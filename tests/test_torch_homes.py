"""Streams of the port's several homes, home bandwidth, shared credits
and bit-packed planes, against the reference.

* packed against dense in the port on ``PACKED_CASES`` (counters,
  message counts, retirement trace), and both against ``repro``'s packed
  ``run_stream``, final state leaf by leaf;
* ``home_bw``, shared-credit and packed multi-home streams against
  ``repro``'s;
* every run replayed into the port's multi-home oracle
  (``validate_run(..., n_homes=H)``);
* the shared-credit fan-out stall of ``tests/test_specialize_mn.py``.

The step itself is held leaf by leaf in ``tests/test_torch_packed.py``;
the baseline key ``streaming.r8_h2`` in ``tests/test_torch_stream.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.traffic import (EngineConfig as JEngineConfig,  # noqa: E402
                           StreamConfig as JStreamConfig,
                           WorkloadSpec as JWorkloadSpec,
                           WORKLOADS as J_WORKLOADS,
                           run_stream as j_run_stream)
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine_mn import EngineMN  # noqa: E402
from repro_torch.traffic import (EngineConfig, StreamConfig,  # noqa: E402
                                 Workload, run_stream, summarize,
                                 validate_run)

#: (R, H, moesi): W=1, ragged W=2 and full W=2 words, one and two homes.
PACKED_CASES = [(8, 1, True), (33, 2, False), (64, 2, True)]


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _assert_same(j_tree, t_state, what):
    a = convert.flatten(_np_tree(j_tree))
    b = convert.flatten(convert.engine_state_to_numpy(t_state))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def _workload(name, R, L, ops, seed):
    wl = JWorkloadSpec(name, ops=ops, seed=seed).materialize(R, L)
    return Workload(*(np.array(x) for x in wl))


def _assert_runs_equal(a, b):
    np.testing.assert_array_equal(a.msg_count, b.msg_count)
    assert a.payload_msgs == b.payload_msgs
    np.testing.assert_array_equal(a.trace.retire_step, b.trace.retire_step)
    for f, x, y in zip(a.counters._fields, a.counters, b.counters):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f)


@pytest.mark.parametrize("R,H,moesi", PACKED_CASES)
def test_packed_stream_bit_identical_and_oracle(R, H, moesi):
    """Packed against dense in the port (counters, message counts,
    retirement trace), both against ``repro``'s packed run, and the
    packed run's linearization replayed into the multi-home oracle."""
    L, ops = 16, 16
    wl = _workload("zipfian", R, L, ops, 3)
    cfg = StreamConfig(workload=wl, width=2, collect_trace=True)
    base = dict(remotes=R, lines=L, homes=H, moesi=moesi)
    dense = run_stream(EngineConfig(**base).build("cpu"), cfg)
    packed = run_stream(EngineConfig(**base, packed=True).build("cpu"), cfg)
    assert dense.completed and packed.completed
    _assert_runs_equal(dense, packed)
    jrun = j_run_stream(JEngineConfig(**base, packed=True).build(),
                        JStreamConfig(workload=JWorkloadSpec(
                            "zipfian", ops=ops, seed=3), width=2,
                            collect_trace=True))
    np.testing.assert_array_equal(packed.msg_count, jrun.msg_count)
    np.testing.assert_array_equal(packed.trace.retire_step,
                                  jrun.trace.retire_step)
    jctr = _np_tree(jrun.counters)
    got = convert.counters_to_reference(packed.counters)
    for f in jctr._fields:
        np.testing.assert_array_equal(got[f], getattr(jctr, f), err_msg=f)
    _assert_same(jrun.state, packed.state, "final state")
    validate_run(packed, moesi=moesi, n_homes=H)
    assert int(packed.counters.retired.sum()) == R * ops


@pytest.mark.parametrize("kw", [dict(homes=2, home_bw=1),
                                dict(shared_credits=True, credits=4),
                                dict(homes=2, packed=True,
                                     shared_credits=True, credits=4)],
                         ids=["h2_home_bw1", "shared", "packed_h2_shared"])
def test_option_streams_match_reference(kw):
    R, L, ops = 8, 16, 16
    wl = _workload("zipfian", R, L, ops, 9)
    trun = run_stream(EngineConfig(remotes=R, lines=L, **kw).build("cpu"),
                      StreamConfig(workload=wl, collect_trace=True))
    jrun = j_run_stream(JEngineConfig(remotes=R, lines=L, **kw).build(),
                        JStreamConfig(workload=JWorkloadSpec(
                            "zipfian", ops=ops, seed=9),
                            collect_trace=True))
    assert trun.completed and jrun.completed
    np.testing.assert_array_equal(trun.msg_count, jrun.msg_count)
    np.testing.assert_array_equal(trun.trace.retire_step,
                                  jrun.trace.retire_step)
    _assert_same(jrun.state, trun.state, "final state")
    validate_run(trun, n_homes=kw.get("homes", 1))


def test_shared_credit_fanout_stalls_but_stays_exact():
    """Under the shared-credit link model the R-1 invalidation fan-out on
    one line's VC is pinned at the credit (against the full R-1 burst
    under per-remote pools), the refused invalidations defer and retry,
    and the retirement-order replay stays exact."""
    n_remotes, n_lines, ops, credit = 8, 1, 10, 4
    wl = J_WORKLOADS["producer_consumer"](jax.random.key(5), ops, n_remotes,
                                          n_lines)
    wl = Workload(*(np.array(x) for x in wl))
    peaks = {}
    for shared in (False, True):
        eng = EngineMN(np.zeros((n_lines, 2), np.float32),
                       n_remotes=n_remotes,
                       credits=np.asarray([credit] * 10, np.int32),
                       shared_credits=shared, device="cpu")
        run = run_stream(eng, StreamConfig(workload=wl, steps=4000,
                                           collect_trace=True))
        validate_run(run, moesi=True)
        s = summarize(run.counters, run.msg_count)
        peaks[shared] = s["peak_occupancy"]["hreq"]
    assert peaks[False] == n_remotes - 1      # per-remote pools: full burst
    assert peaks[True] <= credit              # shared pool: stalls at bound
