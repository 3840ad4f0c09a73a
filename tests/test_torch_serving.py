"""The port's open-loop serving against the reference: arrival schedules,
the FIFO + reserve admission loop, sojourn and admission-wait histograms
and the backlog.

The reference draws its arrivals (and workloads) from ``jax.random``, the
port from ``numpy.random.default_rng``, so every comparison feeds both
packages the reference's ``[T, R]`` arrays through numpy.  Everything is
integer arithmetic: each comparison is bit-exact.

* the port's generators meet ``check_schedule``'s envelope and offer
  the documented load; ``check_schedule`` and the config checks refuse
  what the reference refuses;
* ``at_step0`` with no cap leaves every counter of the closed loop
  bit-identical;
* open-loop runs equal ``repro``'s (counters, message counts, retirement
  trace, both histograms, backlog) at W in {1, 2} x H in {1, 2} with the
  cap, and under ``bursty``, and pass the oracle;
* the baseline keys ``knee.rate0.02``, ``knee.rate0.05`` and
  ``knee.rate0.3`` of ``benchmarks/BENCH_baseline.json`` are reproduced
  exactly, with the arrays drawn under ``jax.threefry_partitionable``
  off (the layout the baseline was made with); rate 0.05 replays the
  oracle.
"""
import json
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import traffic as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.traffic import (ARRIVALS, AdmissionConfig,  # noqa: E402
                                 ArrivalSchedule, ArrivalSpec,
                                 EngineConfig, ObserveConfig,
                                 SOJOURN_EDGES, StreamConfig, Workload,
                                 WorkloadSpec, check_schedule,
                                 default_steps, hist_percentiles,
                                 run_stream, sojourn_summary, validate_run)
from repro_torch.traffic.arrivals import bursty, poisson  # noqa: E402

BASELINE = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks" / "BENCH_baseline.json").read_text())
R, L, T = 3, 12, 12
SEED = 7


@pytest.fixture(autouse=True)
def one_thread():
    """The loop's tensors are tiny: one intra-op thread keeps PyTorch's
    CPU searchsorted/bucketize from waiting on a busy thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(wl) -> Workload:
    return Workload(*(np.array(x) for x in wl))


def _schedule(arr) -> ArrivalSchedule:
    return ArrivalSchedule(np.array(arr.step))


def _same_run(t_run, j_run):
    """Counters, message counts, trace, histograms and backlog equal."""
    ref = jax.tree_util.tree_map(np.asarray, j_run.counters)
    got = convert.counters_to_reference(t_run.counters)
    for f in ref._fields:
        np.testing.assert_array_equal(got[f], getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(t_run.msg_count, j_run.msg_count)
    assert t_run.payload_msgs == j_run.payload_msgs
    assert t_run.completed == j_run.completed
    if j_run.trace is not None:
        np.testing.assert_array_equal(t_run.trace.retire_step,
                                      j_run.trace.retire_step)
    for f in ("sojourn_hist", "admit_wait_hist"):
        np.testing.assert_array_equal(getattr(t_run, f),
                                      getattr(j_run, f), err_msg=f)
    assert t_run.backlog == j_run.backlog


# ---------------------------------------------------------------------------
# Arrival processes and the config checks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(ARRIVALS))
def test_arrival_envelope(kind):
    """[T, R] int32, >= 0, nondecreasing per remote, the same for the same
    seed; at_step0 is zero, as the reference's is."""
    st = ArrivalSpec(kind, rate=0.2, seed=3).materialize(T, R).step
    assert st.shape == (T, R) and st.dtype == np.int32
    assert (st >= 0).all() and (np.diff(st, axis=0) >= 0).all()
    np.testing.assert_array_equal(
        st, ArrivalSpec(kind, rate=0.2, seed=3).materialize(T, R).step)
    check_schedule(ArrivalSchedule(st), T, R)
    if kind == "at_step0":
        np.testing.assert_array_equal(
            st, np.asarray(J.ArrivalSpec(kind, rate=0.2).materialize(
                T, R).step))


@pytest.mark.parametrize("gen", [poisson, bursty])
def test_arrival_rate_sets_offered_load(gen):
    """The mean interarrival gap is 1/rate within sampling noise; bursty's
    normalisation keeps it there while its gaps spread wider."""
    rng = np.random.default_rng(0)
    gaps = np.diff(gen(rng, 4096, 4, 0.1).step, axis=0, prepend=0)
    assert 9.0 < gaps.mean() < 11.0, gaps.mean()      # 1/rate = 10
    if gen is bursty:
        p = np.diff(poisson(np.random.default_rng(0), 4096, 4, 0.1).step,
                    axis=0, prepend=0)
        assert gaps.std() > 1.5 * p.std()


@pytest.mark.parametrize("case,match", [
    ("shape", "shape"), ("float", "integer"),
    ("decreasing", "nondecreasing"), ("negative", "nondecreasing")])
def test_check_schedule_refuses_what_the_reference_refuses(case, match):
    good = np.zeros((T, R), np.int32)
    bad = {"shape": (good, R + 1),
           "float": (good.astype(np.float32), R),
           "decreasing": (np.where(np.arange(T)[:, None] == 0, 5, good)
                          .astype(np.int32), R),
           "negative": (good - 1, R)}[case]
    with pytest.raises(ValueError, match=match):
        check_schedule(ArrivalSchedule(bad[0]), T, bad[1])
    with pytest.raises(ValueError, match=match):
        J.check_schedule(J.ArrivalSchedule(bad[0]), T, bad[1])


@pytest.mark.parametrize("adm", [(2, 2), (2, 3), (-1, 0), (0, -1)])
def test_admission_reserve_must_fit(adm):
    for pkg in (J, None):
        SC = J.StreamConfig if pkg else StreamConfig
        WS = J.WorkloadSpec if pkg else WorkloadSpec
        AC = J.AdmissionConfig if pkg else AdmissionConfig
        with pytest.raises(ValueError, match="reserve"):
            SC(workload=WS(ops=4), admission=AC(*adm))


def test_config_refusals():
    with pytest.raises(ValueError, match="unknown arrival process"):
        ArrivalSpec("nope")
    with pytest.raises(ValueError, match="unknown arrival process"):
        J.ArrivalSpec("nope")
    with pytest.raises(ValueError, match="rate"):
        poisson(np.random.default_rng(0), T, R, 0.0)
    assert StreamConfig(admission=(4, 1)).admission == AdmissionConfig(4, 1)


def test_admission_requires_arrivals():
    for run, eng, SC, WS, AC in (
            (run_stream, EngineConfig(remotes=R, lines=L).build("cpu"),
             StreamConfig, WorkloadSpec, AdmissionConfig),
            (J.run_stream, J.EngineConfig(remotes=R, lines=L).build(),
             J.StreamConfig, J.WorkloadSpec, J.AdmissionConfig)):
        with pytest.raises(ValueError, match="arrival schedule"):
            run(eng, SC(workload=WS(ops=4),
                        admission=AC(max_inflight=4)))


def test_filter_validation_loud():
    eng = EngineConfig(remotes=R, lines=L).build("cpu")
    cfg = dict(workload=WorkloadSpec(ops=4), observe=ObserveConfig())
    with pytest.raises(ValueError, match="line_filter.*shape"):
        run_stream(eng, StreamConfig(line_filter=np.zeros(L + 3, bool),
                                     **cfg))
    with pytest.raises(ValueError, match="type_filter.*shape"):
        run_stream(eng, StreamConfig(type_filter=np.zeros(8, bool), **cfg))
    with pytest.raises(ValueError, match="bool dtype"):
        run_stream(eng, StreamConfig(line_filter=np.zeros(L, np.int32),
                                     **cfg))
    with pytest.raises(ValueError, match="require observe"):
        run_stream(eng, StreamConfig(workload=WorkloadSpec(ops=4),
                                     line_filter=np.zeros(L, bool)))


def test_sojourn_summary_needs_open_loop():
    run = run_stream(EngineConfig(remotes=R, lines=L).build("cpu"),
                     StreamConfig(workload=WorkloadSpec(ops=4), steps=8))
    assert run.sojourn_hist is None and run.backlog == 0
    with pytest.raises(ValueError, match="open-loop"):
        sojourn_summary(run)


# ---------------------------------------------------------------------------
# The admission loop against the reference.
# ---------------------------------------------------------------------------


def test_closed_loop_equivalence_counters_bit_identical():
    """All arrivals at step 0 and no cap drive the closed loop's exact
    schedule: every counter and the trace bit-identical."""
    wl = _workload(J.WORKLOADS["zipfian"](jax.random.key(SEED), T, R, L))
    eng = EngineConfig(remotes=R, lines=L).build("cpu")
    base = run_stream(eng, StreamConfig(workload=wl, collect_trace=True))
    ol = run_stream(eng, StreamConfig(
        workload=wl, arrivals=ArrivalSpec("at_step0", rate=1.0),
        collect_trace=True))
    for a, b in zip(base.counters, ol.counters):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(base.msg_count, ol.msg_count)
    np.testing.assert_array_equal(base.trace.retire_step,
                                  ol.trace.retire_step)
    validate_run(ol)
    assert ol.backlog == 0 and base.sojourn_hist is None
    assert int(ol.sojourn_hist.sum()) == int((wl.op != 0).sum())


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("homes", [1, 2])
def test_admission_loop_matches_reference(width, homes):
    """Poisson arrivals through FIFO + reserve admission at W and H: the
    same run as the reference's, and oracle-exact."""
    wl = J.WorkloadSpec("zipfian", ops=T, seed=SEED).materialize(R, L)
    arr = J.ArrivalSpec("poisson", rate=0.3, seed=1).materialize(T, R)
    kw = dict(admission=(4, 1), width=width, collect_trace=True)
    j_run = J.run_stream(J.EngineConfig(remotes=R, lines=L,
                                        homes=homes).build(),
                         J.StreamConfig(workload=wl, arrivals=arr, **kw))
    run = run_stream(EngineConfig(remotes=R, lines=L, homes=homes)
                     .build("cpu"),
                     StreamConfig(workload=_workload(wl),
                                  arrivals=_schedule(arr), **kw))
    assert run.completed and run.backlog == 0
    _same_run(run, j_run)
    validate_run(run, n_homes=homes)
    assert int(run.counters.steps) == default_steps(
        T, R, int(np.asarray(arr.step).max()))


def test_bursty_overload_matches_reference():
    """Bursty arrivals past a cap of 3 in a fixed window: the run ends
    with a backlog, equal to the reference's, as are its histograms."""
    wl = J.WorkloadSpec("zipfian", ops=60, seed=SEED).materialize(R, L)
    arr = J.ArrivalSpec("bursty", rate=0.5, seed=2).materialize(60, R)
    kw = dict(admission=(3, 1), steps=60, width=2)
    j_run = J.run_stream(J.EngineConfig(remotes=R, lines=L).build(),
                         J.StreamConfig(workload=wl, arrivals=arr, **kw))
    run = run_stream(EngineConfig(remotes=R, lines=L).build("cpu"),
                     StreamConfig(workload=_workload(wl),
                                  arrivals=_schedule(arr), **kw))
    _same_run(run, j_run)
    assert not run.completed and run.backlog > 0
    s = sojourn_summary(run)
    assert s == J.sojourn_summary(j_run)


def test_admission_cap_bounds_inflight():
    run = run_stream(EngineConfig(remotes=R, lines=L).build("cpu"),
                     StreamConfig(
                         workload=WorkloadSpec("false_sharing", ops=2 * T),
                         arrivals=ArrivalSpec("at_step0", rate=1.0),
                         admission=AdmissionConfig(2, 1)))
    assert run.completed
    assert int(run.counters.mshr_peak) <= 2


# ---------------------------------------------------------------------------
# The knee keys of the committed baseline.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.02, 0.05, 0.3])
def test_knee_baseline_keys(rate):
    """``bench_smoke.run_knee``'s point at ``rate``: zipfian R=8, L=16, 48
    ops, Poisson arrivals (seed 1), admission (16, 2); the overload point
    runs the arrival span, the others the auto budget."""
    want = BASELINE["knee"][f"rate{rate:g}"]
    with jax.threefry_partitionable(False):
        wl = J.WorkloadSpec("zipfian", ops=48, seed=0).materialize(8, 16)
        arr = J.ArrivalSpec("poisson", rate=rate, seed=1).materialize(48, 8)
    last = int(np.asarray(arr.step).max())
    overload = rate >= 0.2
    run = run_stream(EngineConfig(remotes=8, lines=16).build("cpu"),
                     StreamConfig(workload=_workload(wl),
                                  arrivals=_schedule(arr),
                                  admission=AdmissionConfig(16, 2),
                                  steps=last if overload else 0,
                                  collect_trace=want["validated"]))
    if want["validated"]:
        validate_run(run)
    s = sojourn_summary(run)
    p = s["sojourn_percentiles"]
    got = {"admit_wait_p99": s["admit_wait_percentiles"]["p99"],
           "backlog": s["backlog"], "completed": run.completed,
           "sojourn_p50": p["p50"], "sojourn_p99": p["p99"],
           "sojourn_p999": p["p999"], "steps": int(run.counters.steps),
           "last_arrival": last}
    assert got == {k: want[k] for k in got}
    assert hist_percentiles(run.sojourn_hist, SOJOURN_EDGES) == p
