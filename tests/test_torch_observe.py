"""The port's observability plane against the reference: the copied
``core.tracing``, the v1 EWF layout, ``step_mn``'s wire events and the
in-loop fold of ``traffic.observe``.

Both packages run the same workload arrays (the reference's, through
numpy); everything compared is integer data, so every comparison is
bit-exact:

* ``compile_spec``, ``_encoded_tables`` and ``check_trace`` of the
  port's ``tracing.py`` equal the reference's on every shipped spec;
  ``pack_v1``/``unpack_v1`` round-trip within the v1 field widths;
* ``step_mn(emit_events=True)`` equals the reference's ``StepEvents``
  leaf by leaf after every step, dense, packed and with two homes;
* observed runs equal ``repro``'s ``ObsResult`` (words, words seen,
  dropped words, violations, phase histograms) on clean streams at R=8
  with H in {1, 2}, READ_ONLY with all three specs, the injected
  violation, the capture filters, ring wrap and the port cap; a fold
  over a step with no event leaves the carry as it was, and an observed
  run equals the plain one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import traffic as J  # noqa: E402
from repro.core import messages as jmsg  # noqa: E402
from repro.core import tracing as jtr  # noqa: E402
from repro.core.engine_mn import EngineMN as JEngine  # noqa: E402
from repro.core.engine_mn import step_mn as j_step_mn  # noqa: E402
from repro.core.protocol import mn_tables  # noqa: E402
from repro.traffic import observe as jobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.core.engine_mn import (EngineMN, StepEvents,  # noqa: E402
                                        step_mn)
from repro_torch.core.messages import MsgType  # noqa: E402
from repro_torch.core.tracing import (SPECS, TraceBuffer,  # noqa: E402
                                      check_trace, compile_spec)
from repro_torch.traffic import (EngineConfig, ObserveConfig,  # noqa: E402
                                 StreamConfig, Workload, default_steps,
                                 perfetto_events, run_stream)
from repro_torch.traffic import observe as obs  # noqa: E402

SEED = 4242


@pytest.fixture(autouse=True)
def one_thread():
    """The loop's tensors are tiny: one intra-op thread keeps PyTorch's
    CPU searchsorted/bucketize from waiting on a busy thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wl(R, L, ops, workload="zipfian", seed=3, **kw):
    return J.WORKLOADS[workload](jax.random.key(seed), ops, R, L, **kw)


def _runs(R=4, L=8, ops=12, homes=1, subset="", wl=None, **kw):
    """The reference's and the port's observed run of one stream; ``kw``
    are ``ObserveConfig`` fields and the capture filters."""
    wl = _wl(R, L, ops) if wl is None else wl
    filt = {k: kw.pop(k) for k in ("line_filter", "type_filter")
            if k in kw}
    ocfg = {"capacity": 4096, **kw}
    steps = default_steps(ops, R)
    j_run = J.run_stream(
        J.EngineConfig(remotes=R, lines=L, homes=homes, subset=subset)
        .build(), J.StreamConfig(workload=wl, steps=steps,
                                 observe=J.ObserveConfig(**ocfg), **filt))
    run = run_stream(
        EngineConfig(remotes=R, lines=L, homes=homes, subset=subset)
        .build("cpu"),
        StreamConfig(workload=Workload(*(np.array(x) for x in wl)),
                     steps=steps, observe=ObserveConfig(**ocfg), **filt))
    assert run.completed and j_run.completed
    np.testing.assert_array_equal(run.msg_count, j_run.msg_count)
    _same_obs(run.obs, j_run.obs)
    return run, j_run


def _same_obs(got, want):
    assert got.words.dtype == np.uint64
    np.testing.assert_array_equal(got.words, np.asarray(want.words))
    assert got.captured_total == want.captured_total
    assert got.dropped == want.dropped
    assert [vars(v) for v in got.violations] == \
        [vars(v) for v in want.violations]
    if want.phase_hist is None:
        assert got.phase_hist is None
    else:
        np.testing.assert_array_equal(got.phase_hist, want.phase_hist)
    assert got.metrics() == want.metrics()


# ---------------------------------------------------------------------------
# The copied modules: EWF v1, TraceBuffer, the specs and their compiler.
# ---------------------------------------------------------------------------


def test_pack_v1_matches_reference():
    """Within the v1 widths (2-bit node, 32-bit line, 20-bit txn), as
    tensors and as Python ints."""
    rng = np.random.default_rng(SEED)
    n = 500
    f = dict(msg_type=rng.integers(0, 16, n), vc=rng.integers(0, 16, n),
             has_payload=rng.integers(0, 2, n), dirty=rng.integers(0, 2, n),
             node=rng.integers(0, 4, n),
             line=rng.integers(0, 1 << 32, n, dtype=np.int64),
             txn=rng.integers(0, 1 << 20, n))
    want = jmsg.pack_v1(**f)
    got = tmsg.pack_v1(**{k: torch.as_tensor(v) for k, v in f.items()})
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    back = tmsg.unpack_v1(got)
    for name in f:
        np.testing.assert_array_equal(getattr(back, name).numpy(), f[name],
                                      err_msg=name)
    for i in (0, 1, n - 1):
        one = tmsg.unpack_v1(int(want[i]))
        assert {k: int(getattr(one, k)) for k in f} == \
            {k: int(v[i]) for k, v in f.items()}


@pytest.mark.parametrize("version", [1, 2])
def test_tracebuffer_matches_reference(version):
    """Record, ring order, decode and JSON equal the reference's."""
    rng = np.random.default_rng(SEED + version)
    tb, jtb = TraceBuffer(4, ewf_version=version), \
        jtr.TraceBuffer(4, ewf_version=version)
    for _ in range(10):
        fields = (int(rng.integers(0, 16)), int(rng.integers(0, 16)),
                  bool(rng.integers(0, 2)), bool(rng.integers(0, 2)),
                  int(rng.integers(0, 4)), int(rng.integers(0, 1 << 32)),
                  int(rng.integers(0, 1 << 16)))
        tb.record(*fields)
        jtb.record(*fields)
    assert tb.words == jtb.words and len(tb.words) == 4
    assert tb.to_json() == jtb.to_json()
    tb2 = TraceBuffer.from_words(np.asarray(jtb.words, np.uint64))
    assert tb2.words == jtb.words


@pytest.mark.parametrize("name", sorted(jtr.SPECS))
def test_compile_spec_matches_reference(name):
    got, want = compile_spec(SPECS[name]), jtr.compile_spec(jtr.SPECS[name])
    assert got.states == want.states and got.start_mask == want.start_mask
    np.testing.assert_array_equal(got.table, want.table)
    assert SPECS[name].transitions == jtr.SPECS[name].transitions


def test_encoded_tables_match_reference():
    names = tuple(sorted(SPECS))
    tab, start = obs._encoded_tables(obs.compiled_specs(names))
    jtab, jstart = jobs._encoded_tables(jobs.compiled_specs(names))
    np.testing.assert_array_equal(tab, jtab)
    np.testing.assert_array_equal(start, jstart)
    assert obs.SYMBOL_PAIRS == jobs.SYMBOL_PAIRS and obs.N_COLS == \
        jobs.N_COLS


@pytest.mark.parametrize("name", sorted(jtr.SPECS))
def test_check_trace_matches_reference(name):
    """The offline checker over a random name trace on four lines, with
    the hresp channel, flags the same violations as the reference's."""
    rng = np.random.default_rng(SEED)
    tb, jtb = TraceBuffer(), jtr.TraceBuffer()
    for _ in range(300):
        fields = (int(rng.integers(1, 12)), int(rng.integers(0, 8)),
                  False, False, 0, int(rng.integers(0, 4)), 0)
        tb.record(*fields)
        jtb.record(*fields)
    got = check_trace(SPECS[name], tb)
    want = jtr.check_trace(jtr.SPECS[name], jtb)
    assert got and [vars(v) for v in got] == [vars(v) for v in want]


# ---------------------------------------------------------------------------
# step_mn's wire events.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _j_step(subset: str, n_homes: int):
    t = mn_tables(subset)
    return jax.jit(functools.partial(j_step_mn, t.base, t, n_homes=n_homes,
                                     emit_events=True))


@pytest.mark.parametrize("R,H,packed", [(8, 1, False), (8, 2, False),
                                        (8, 1, True), (33, 2, True)],
                         ids=["dense", "dense-h2", "packed", "packed-h2"])
def test_step_events_match_reference(R, H, packed):
    L, B, steps = 16, 2, 40
    rng = np.random.default_rng(SEED + R)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = JEngine(jnp.asarray(backing), n_remotes=R, n_homes=H,
                 packed=packed)
    te = EngineMN(backing, n_remotes=R, n_homes=H, packed=packed,
                  device="cpu")
    js, ts = je.init(), te.init()
    fire = np.zeros(len(StepEvents._fields), bool)
    for t in range(steps):
        op = np.zeros((R, L), np.int8)
        if t < steps - 12:
            op[np.arange(R), rng.integers(0, L, R)] = rng.choice(
                [1, 1, 2, 2, 3], R)             # loads, stores, evicts
        val = rng.normal(size=(R, L, B)).astype(np.float32)
        wr = (rng.random(L) < 0.05) & (t < steps - 12)
        ww = (rng.random(L) < 0.05) & (t < steps - 12)
        wv = rng.normal(size=(L, B)).astype(np.float32)
        js, _, jev = _j_step(je.subset.name, H)(
            js, *(jnp.asarray(x) for x in (op, val, wr, ww, wv)),
            je.delays, je.credits)
        ts, _, tev = step_mn(te.tables, ts, *(torch.as_tensor(x) for x in
                                              (op, val, wr, ww, wv)),
                             te.delays, te.credits, n_homes=H,
                             emit_events=True)
        for i, f in enumerate(StepEvents._fields):
            want, got = np.asarray(getattr(jev, f)), getattr(tev, f).numpy()
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f"{f} @ {t}")
            fire[i] |= bool(want.any())
        a = convert.flatten(convert.engine_state_to_numpy(ts))
        b = convert.flatten(jax.tree_util.tree_map(np.asarray, js))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every site fired: hresp, vol, req, grant and hd events.
    for f in ("hresp_arr", "vol_arr", "req_acc", "grant", "hd_arr"):
        assert fire[StepEvents._fields.index(f)], f


def test_fold_without_events_changes_nothing():
    """The port folds every step (no ``lax.cond``): a step with no event,
    acceptance, retirement or injection leaves the carry as it was."""
    R, L = 4, 8
    cfg = ObserveConfig(capacity=64, specs=tuple(sorted(SPECS)),
                        inject=(99, 3, int(MsgType.REQ_READ_SHARED)))
    comp = obs.compiled_specs(cfg.specs)
    tables = obs.obs_tables(comp, "cpu")
    rng = np.random.default_rng(SEED)
    oc = obs.make_obs_carry(cfg, R, L, comp, "cpu")
    # a carry that has seen traffic: every field non-trivial
    oc = oc._replace(
        ring=torch.as_tensor(rng.integers(0, 1 << 40, 65)),
        ring_pos=torch.tensor(70), ring_dropped=torch.tensor(3),
        nfa_mask=torch.as_tensor(rng.integers(1, 3, (3, L))),
        acc_step=torch.as_tensor(rng.integers(0, 9, (R, L)),
                                 dtype=torch.int32),
        park_step=torch.as_tensor(rng.integers(0, 9, L), dtype=torch.int32),
        park_hd=torch.as_tensor(rng.random(L) < 0.5),
        last_reply=torch.as_tensor(rng.integers(0, 9, L),
                                   dtype=torch.int32),
        phase_hist=torch.as_tensor(rng.integers(0, 9, (4, 10))))
    zrl = torch.zeros((R, L), dtype=torch.bool)
    zl = torch.zeros(L, dtype=torch.bool)
    ev = StepEvents(
        hresp_arr=zrl, hresp_msg=torch.full((R, L), 10, dtype=torch.int8),
        hresp_dirty=zrl, vol_arr=zrl,
        vol_msg=torch.full((R, L), 5, dtype=torch.int8), vol_dirty=zrl,
        req_acc=zl, req_msg=torch.ones(L, dtype=torch.int8),
        req_node=torch.zeros(L, dtype=torch.int32), grant=zl,
        grant_msg=torch.full((L,), 8, dtype=torch.int8),
        grant_node=torch.zeros(L, dtype=torch.int32), grant_pay=zl,
        hd_arr=zrl, hd_msg=torch.full((R, L), 7, dtype=torch.int8))
    before = {f: (None if x is None else x.clone())
              for f, x in oc._asdict().items()}
    after = obs.fold_obs(cfg, tables, oc, ev, 12, None, None, newly=zrl,
                         born_d=torch.zeros((R, L), dtype=torch.int32),
                         retired=zrl)
    for f, x in after._asdict().items():
        if f == "ring":     # the slot past the capacity is scratch
            x, before[f] = x[:cfg.capacity], before[f][:cfg.capacity]
        assert torch.equal(x, before[f]), f


# ---------------------------------------------------------------------------
# Observed runs against the reference.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _clean_r8(homes):
    return _runs(R=8, L=12, ops=16, homes=homes)


@pytest.mark.parametrize("homes", [1, 2])
def test_clean_stream_matches_reference_r8(homes):
    run, _ = _clean_r8(homes)
    assert run.obs.violations == [] and run.obs.dropped == 0
    tb = run.obs.trace_buffer()
    assert len(tb.words) == int(run.msg_count.sum())
    for name in ("req_resp", "single_writer"):
        assert check_trace(SPECS[name], tb) == [], name


def test_readonly_subset_all_three_specs_match_reference():
    run, _ = _runs(R=8, L=12, ops=8, subset="read_only",
                   wl=_wl(8, 12, 8, seed=0, store_frac=0.0),
                   specs=("req_resp", "single_writer", "readonly"))
    assert run.obs.violations == []
    for name in SPECS:
        assert check_trace(SPECS[name], run.obs.trace_buffer()) == [], name


def _open_window(tb):
    """(step, line) one step after a request parked >= 2 steps before its
    grant: a second request on the line is illegal there."""
    open_at = {}
    for m in tb.messages():
        klass = int(m.vc) // 2
        if klass == tp.CLASS_REMOTE_REQ and int(m.msg_type) in (
                int(MsgType.REQ_READ_SHARED), int(MsgType.REQ_READ_EXCL),
                int(MsgType.REQ_UPGRADE)):
            open_at[int(m.line)] = int(m.txn)
        elif klass == tp.CLASS_HOME_RESP and int(m.line) in open_at:
            s = open_at.pop(int(m.line))
            if int(m.txn) > s + 1:
                return s + 1, int(m.line)
    raise AssertionError("no open request window in trace")


def test_injected_violation_matches_reference():
    clean = run_stream(EngineConfig(remotes=4, lines=8).build("cpu"),
                       StreamConfig(workload=Workload(*(
                           np.array(x) for x in _wl(4, 8, 12))),
                           observe=ObserveConfig(capacity=4096)))
    istep, iline = _open_window(clean.obs.trace_buffer())
    bad, _ = _runs(inject=(istep, iline, int(MsgType.REQ_READ_SHARED)))
    v = [v for v in bad.obs.violations if v.spec == "req_resp"]
    assert v and (v[0].step, v[0].line) == (istep, iline)
    assert v[0].symbol == "REQ_READ_SHARED" and "wait" in v[0].states_before
    hv = check_trace(SPECS["req_resp"], bad.obs.trace_buffer())
    assert hv and hv[0].line == iline


def test_filters_match_reference():
    lf = np.zeros(8, bool)
    lf[:2] = True
    tf = np.zeros(16, bool)
    tf[[int(MsgType.REQ_READ_SHARED), int(MsgType.REQ_READ_EXCL)]] = True
    run, _ = _runs(specs=(), line_filter=lf, type_filter=tf)
    msgs = run.obs.trace_buffer().messages()
    assert msgs and all(m.line < 2 for m in msgs)
    assert all(m.msg_type in (1, 2) for m in msgs)


def test_ring_wrap_matches_reference():
    run, _ = _runs(capacity=32, specs=())
    assert run.obs.captured_total > 32 and len(run.obs.words) == 32
    steps = [m.txn for m in run.obs.trace_buffer().messages()]
    assert steps == sorted(steps)


def test_port_cap_matches_reference():
    run, _ = _runs(port=2, specs=(), attribution=False)
    assert run.obs.dropped > 0 and run.obs.phase_hist is None
    assert run.obs.captured_total + run.obs.dropped == \
        int(run.msg_count.sum())


def test_observed_run_equals_plain_run():
    """Observation changes nothing of the run: state, counters, message
    counts and trace bit for bit."""
    R, L, ops = 4, 8, 12
    wl = Workload(*(np.array(x) for x in _wl(R, L, ops)))
    eng = EngineConfig(remotes=R, lines=L).build("cpu")
    a, b = (run_stream(eng, StreamConfig(workload=wl, observe=o,
                                         collect_trace=True))
            for o in (None, ObserveConfig()))
    assert a.obs is None and b.obs.violations == []
    for x, y in zip(convert.flatten(convert.engine_state_to_numpy(a.state))
                    .values(),
                    convert.flatten(convert.engine_state_to_numpy(b.state))
                    .values()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.counters, b.counters):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.msg_count, b.msg_count)
    np.testing.assert_array_equal(a.trace.retire_step, b.trace.retire_step)


def test_phase_accounting_and_perfetto():
    """Every retired op contributes one queue and one service sample,
    fan-out waits are a subset of home samples; the Perfetto export
    equals the reference's on the same ring."""
    run, j_run = _clean_r8(1)
    totals = dict(zip(obs.PHASES, run.obs.phase_hist.sum(axis=1)))
    ops_retired = int(run.counters.retired.sum())
    assert totals["queue"] == totals["service"] == ops_retired
    assert 0 < totals["fanout"] <= totals["home"]
    doc = perfetto_events(run.obs.trace_buffer(), n_homes=1)
    assert doc == jobs.perfetto_events(j_run.obs.trace_buffer(), n_homes=1)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 1 for e in spans)
