"""The port's sweep fleets against the reference's.

* The fleet's home emulation in ``step_mn`` (``home_group``/
  ``home_bw_t``), leaf by leaf against ``repro``'s flat-layout
  emulation, for ``home_group`` in {1, 2, 4} x ``home_bw_t`` in {0, 1}.
* The grouped ``count_fold`` twin against a per-member loop of
  ``repro.kernels.ref``.
* The port's member-batched loop fed the reference's ``[T, R]`` arrays,
  against ``repro.traffic.run_fleet`` on a small R x W fleet and an
  H in {1, 2} fleet: counters, message counts, completion, retirement
  trace and final state, bit for bit.
* The baseline keys ``fleet.grid.*`` (all 12) and ``fleet.homes.*``
  (all 3) of ``benchmarks/BENCH_baseline.json``, exact, with the
  baseline's workloads (drawn under ``jax.threefry_partitionable(False)``).
* The loop stopping once every member is quiet, dense, packed and with
  two homes, each member still equal to the reference's run of the whole
  budget; a budget that ends first runs every step.
* Every member against its solo port run at the fleet's budget, packed
  members against dense, one ``step_folded`` call per step for the whole
  fleet, and every ``FleetConfig`` refusal of ``tests/test_fleet.py``.
"""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine_mn import EngineMN as JEngine  # noqa: E402
from repro.core.engine_mn import step_mn as j_step_mn  # noqa: E402
from repro.core.protocol import mn_tables  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.traffic import (EngineConfig as JEngineConfig,  # noqa: E402
                           FleetConfig as JFleetConfig,
                           StreamConfig as JStreamConfig,
                           WorkloadSpec as JWorkloadSpec,
                           run_fleet as j_run_fleet)
from repro_torch import convert, spans  # noqa: E402
from repro_torch.core import engine_mn  # noqa: E402
from repro_torch.core.engine_mn import EngineMN, step_mn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.traffic import (ArrivalSpec, EngineConfig,  # noqa: E402
                                 FleetConfig, ObserveConfig, StreamConfig,
                                 Workload, WorkloadSpec, fleet_steps,
                                 run_fleet, run_stream, summarize,
                                 validate_run)
from repro_torch.traffic import fleet as fleet_mod  # noqa: E402
from repro_torch.traffic import driver as driver_mod  # noqa: E402

BASELINE = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks" / "BENCH_baseline.json").read_text())
#: the baseline's fleet sweeps (``benchmarks/bench_smoke.py``): 16 lines,
#: 32 ops per remote, the R x W grid and the homes sweep at R=8.
GRID = tuple((r, w) for r in (4, 8, 16, 32) for w in (1, 2, 4))
HOMES = (1, 2, 4)
L, OPS = 16, 32
SEED = 2024


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain path's tensors are tiny: one intra-op thread keeps the
    # CPU's small kernels off a busy thread pool.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _ref_workload(R, ops, seed, legacy_bits=False, lines=L):
    spec = JWorkloadSpec("zipfian", ops=ops, seed=seed)
    if legacy_bits:
        with jax.threefry_partitionable(False):
            wl = spec.materialize(R, lines)
    else:
        wl = spec.materialize(R, lines)
    return Workload(*(np.array(x) for x in wl))


def _keys(run):
    s = summarize(run.counters, run.msg_count)
    return {"completed": bool(run.completed),
            "ops_per_step": round(float(s["ops_per_step"]), 6),
            "max_wait": int(max(s["max_wait"])),
            "ops_retired": int(s["ops_retired"])}


def _assert_runs_equal(a, b, trace=True):
    assert a.completed == b.completed
    np.testing.assert_array_equal(a.msg_count, b.msg_count)
    assert a.payload_msgs == b.payload_msgs
    for f, x, y in zip(a.counters._fields, a.counters, b.counters):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f)
    if trace:
        np.testing.assert_array_equal(a.trace.retire_step,
                                      b.trace.retire_step)


# ---------------------------------------------------------------------------
# the home emulation and the grouped counter fold
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _j_step():
    tm = mn_tables("full_moesi")
    return jax.jit(functools.partial(j_step_mn, tm.base, tm))


def _schedule(rng, R, B, t, n_ops):
    op = np.zeros((R, L), np.int8)
    if t < n_ops:
        for r in range(R):
            op[r, rng.integers(0, L)] = rng.choice([1, 2])
    val = rng.normal(size=(R, L, B)).astype(np.float32)
    wr = (rng.random(L) < 0.05) & (t < n_ops)
    ww = (rng.random(L) < 0.05) & (t < n_ops)
    wv = rng.normal(size=(L, B)).astype(np.float32)
    return op, val, wr, ww, wv


@pytest.mark.parametrize("home_bw_t", [0, 1])
@pytest.mark.parametrize("home_group", [1, 2, 4])
def test_home_emulation_leaf_by_leaf(home_group, home_bw_t):
    """``step_mn(home_group=, home_bw_t=)`` equals the reference's
    flat-layout emulation after every step, state and outputs."""
    R, B, steps = 4, 2, 40
    rng = np.random.default_rng(SEED + 10 * home_group + home_bw_t)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = JEngine(jnp.asarray(backing), n_remotes=R)
    te = EngineMN(backing, n_remotes=R, device="cpu")
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for t in range(steps):
        op, val, wr, ww, wv = _schedule(rng, R, B, t, steps - 16)
        js, jo = _j_step()(js, jnp.asarray(op), jnp.asarray(val),
                           jnp.asarray(wr), jnp.asarray(ww),
                           jnp.asarray(wv), je.delays, je.credits,
                           home_group=jnp.int32(home_group),
                           home_bw_t=jnp.int32(home_bw_t))
        ts, to = step_mn(te.tables, ts, *(torch.as_tensor(x) for x in
                                          (op, val, wr, ww, wv)),
                         te.delays, te.credits, home_group=home_group,
                         home_bw_t=home_bw_t)
        for what, a, b in (("state", js, ts), ("output", jo, to)):
            a, b = convert.flatten(_np_tree(a)), convert.flatten(b)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(
                    b[k], a[k], err_msg=f"{what} after step {t}: {k}")
    assert int(ts.msg_count.sum()) > 0


def test_home_emulation_default_is_the_plain_step():
    """``home_group = 1`` with ``home_bw_t = 0`` is the default step."""
    R, B = 3, 2
    rng = np.random.default_rng(SEED)
    te = EngineMN(np.zeros((L, B), np.float32), n_remotes=R, device="cpu")
    a = b = te.init()
    for t in range(24):
        args = [torch.as_tensor(x) for x in _schedule(rng, R, B, t, 12)]
        a, oa = step_mn(te.tables, a, *args, te.delays, te.credits)
        b, ob = step_mn(te.tables, b, *args, te.delays, te.credits,
                        home_group=1, home_bw_t=0)
        for x, y in ((a, b), (oa, ob)):
            fx, fy = convert.flatten(x), convert.flatten(y)
            for k in fx:
                np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("G", [1, 3, 12])
def test_count_fold_grouped_equals_reference_per_member(G, with_base):
    rng = np.random.default_rng(G)
    shape = (G, 5, 37)
    mask = rng.random(shape) < 0.4
    msg = rng.integers(-3, 20, shape).astype(np.int8)
    pay = rng.random(shape) < 0.5
    base = None
    if with_base:
        base = (torch.as_tensor(rng.integers(0, 99, (G, 16)),
                                dtype=torch.int32),
                torch.as_tensor(rng.integers(0, 99, G), dtype=torch.int32))
    gc, gp = tref.count_fold_ref(torch.as_tensor(mask),
                                 torch.as_tensor(msg), torch.as_tensor(pay),
                                 base, grouped=True)
    assert gc.shape == (G, 16) and gp.shape == (G,)
    for g in range(G):
        wc, wp = jref.count_fold_ref(jnp.asarray(mask[g]),
                                     jnp.asarray(msg[g]),
                                     jnp.asarray(pay[g]))
        wc, wp = np.asarray(wc), int(wp)
        if with_base:
            wc, wp = wc + base[0][g].numpy(), wp + int(base[1][g])
        np.testing.assert_array_equal(gc[g].numpy(), wc)
        assert int(gp[g]) == wp


# ---------------------------------------------------------------------------
# fleets against the reference's
# ---------------------------------------------------------------------------

#: (remotes, width, homes, home_bw, seed) per member.
REF_FLEETS = {
    "rw": [(2, 1, 1, 0, 3), (4, 2, 1, 0, 4), (3, 1, 1, 0, 5)],
    "homes": [(4, 1, 1, 1, 6), (4, 1, 2, 1, 6)],
}


@pytest.mark.parametrize("kind", list(REF_FLEETS))
def test_fleet_matches_reference_run_fleet(kind):
    """The port's loop fed the reference's arrays equals
    ``repro.traffic.run_fleet``, member by member, state leaf by leaf."""
    ops = 12

    def members(E, S, W):
        return tuple((E(remotes=r, lines=L, homes=h, home_bw=bw),
                      S(workload=W("zipfian", ops=ops, seed=sd), width=w,
                        collect_trace=True))
                     for r, w, h, bw, sd in REF_FLEETS[kind])

    jf = JFleetConfig(members=members(JEngineConfig, JStreamConfig,
                                      JWorkloadSpec))
    tf = FleetConfig(members=members(EngineConfig, StreamConfig,
                                     WorkloadSpec))
    wls = [_ref_workload(e.remotes, ops, s.workload.seed)
           for e, s in tf.members]
    got = fleet_mod._run_members(tf.members, wls, fleet_steps(tf),
                                 torch.device("cpu"))
    for i, (a, b) in enumerate(zip(j_run_fleet(jf), got)):
        assert a.completed and b.completed
        _assert_member_equals_reference(i, b, a)
        validate_run(b, n_homes=tf.members[i][0].homes)


def _assert_member_equals_reference(i, b, a):
    """The port's member ``b`` equals the reference's ``a``: completion,
    messages, trace, every counter and the state leaf by leaf."""
    assert b.completed == a.completed
    np.testing.assert_array_equal(b.msg_count, a.msg_count)
    assert b.payload_msgs == a.payload_msgs
    np.testing.assert_array_equal(b.trace.retire_step, a.trace.retire_step)
    jc = _np_tree(a.counters)
    tc = convert.counters_to_reference(b.counters)
    for f in jc._fields:
        np.testing.assert_array_equal(tc[f], getattr(jc, f),
                                      err_msg=f"member {i}: {f}")
    sa, sb = convert.flatten(_np_tree(a.state)), convert.flatten(b.state)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k],
                                      err_msg=f"member {i}: {k}")


def _engine_steps(fn):
    """``fn()`` and the engine steps its loop ran: the calls of the
    ``engine.step`` span."""
    spans.reset()
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    ran = spans.summary()["engine.step"]["calls"]
    spans.reset()
    return out, ran


#: kind -> (packed, members as (remotes, width, homes, home_bw, seed),
#: budget (0: the fleet's)), at 64 lines, B=4, 4 ops a remote.
QUIET_FLEETS = {
    "dense": (False, ((3, 1, 1, 0, 21), (3, 2, 1, 0, 22),
                      (2, 1, 1, 0, 23)), 0),
    "packed": (True, ((3, 1, 1, 0, 21), (3, 2, 1, 0, 22),
                      (2, 2, 1, 0, 23), (3, 1, 1, 0, 24)), 0),
    "homes2": (False, ((3, 1, 2, 1, 25), (3, 2, 1, 0, 26)), 0),
    "short_budget": (False, ((3, 1, 1, 0, 21), (3, 2, 1, 0, 22)), 6),
}


@pytest.mark.parametrize("kind", list(QUIET_FLEETS))
def test_fleet_loop_stops_at_quiescence_as_the_full_budget(kind):
    """The fleet's loop stops once every member is quiet (fewer
    ``engine.step`` calls than the budget; a budget that ends first runs
    every step), and each member equals the reference's fleet run of the
    whole budget, ``step_no`` and ``counters.steps`` among the leaves."""
    packed, spec, steps = QUIET_FLEETS[kind]
    lines, ops = 64, 4

    def members(E, S, W):
        return tuple((E(remotes=r, lines=lines, block=4, homes=h,
                        home_bw=bw, packed=packed),
                      S(workload=W("zipfian", ops=ops, seed=sd), width=w,
                        collect_trace=True))
                     for r, w, h, bw, sd in spec)

    jf = JFleetConfig(members=members(JEngineConfig, JStreamConfig,
                                      JWorkloadSpec), steps=steps)
    tf = FleetConfig(members=members(EngineConfig, StreamConfig,
                                     WorkloadSpec), steps=steps)
    wls = [_ref_workload(e.remotes, ops, s.workload.seed, lines=lines)
           for e, s in tf.members]
    budget = fleet_steps(tf)
    got, ran = _engine_steps(lambda: fleet_mod._run_members(
        tf.members, wls, budget, torch.device("cpu")))
    assert (ran == budget) if steps else (ran < budget), (ran, budget)
    for i, (a, b) in enumerate(zip(j_run_fleet(jf), got)):
        assert b.completed == (steps == 0)
        assert int(b.counters.steps) == int(b.state.step_no) == budget
        _assert_member_equals_reference(i, b, a)


@pytest.fixture(scope="module")
def grid_runs():
    fleet = FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=L),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=OPS), width=w))
        for r, w in GRID))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = fleet_mod._run_members(
            fleet.members, [_ref_workload(r, OPS, 0, legacy_bits=True)
                            for r, _ in GRID],
            fleet_steps(fleet), torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    return fleet_steps(fleet), dict(zip(GRID, runs))


@pytest.mark.parametrize("r,w", GRID)
def test_fleet_grid_baseline_keys(grid_runs, r, w):
    steps, runs = grid_runs
    assert steps == BASELINE["fleet"]["compile"]["steps"] == 2496
    want = BASELINE["fleet"]["grid"][f"r{r}_w{w}"]
    run = runs[(r, w)]
    assert int(run.counters.steps) == steps
    assert _keys(run) == {k: want[k] for k in _keys(run)}


def test_fleet_homes_baseline_keys():
    fleet = FleetConfig(members=tuple(
        (EngineConfig(remotes=8, lines=L, homes=h, home_bw=1),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=OPS)))
        for h in HOMES))
    wl = _ref_workload(8, OPS, 0, legacy_bits=True)
    runs = fleet_mod._run_members(fleet.members, [wl] * 3,
                                  fleet_steps(fleet), torch.device("cpu"))
    for h, run in zip(HOMES, runs):
        want = BASELINE["fleet"]["homes"][f"h{h}"]
        assert _keys(run) == {k: want[k] for k in _keys(run)}, f"h{h}"


# ---------------------------------------------------------------------------
# fleets against the port's own solo runs
# ---------------------------------------------------------------------------


def _fleet(packed=False, trace=True, ops=12):
    return FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=L, homes=h, home_bw=bw,
                      packed=packed),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=ops, seed=sd),
                      width=w, collect_trace=trace))
        for r, w, h, bw, sd in ((2, 1, 1, 0, 1), (5, 3, 2, 1, 2),
                                (3, 2, 4, 0, 3), (5, 1, 1, 2, 4))))


def test_fleet_members_equal_solo_runs():
    """Each member equals its own ``run_stream`` at the fleet's budget
    (the port's numpy generators on both sides) and replays into the
    oracle."""
    fleet = _fleet()
    steps = fleet_steps(fleet)
    for (e, s), fr in zip(fleet.members, run_fleet(fleet, device="cpu")):
        solo = run_stream(e.build("cpu"), StreamConfig(
            workload=s.workload, width=s.width, steps=steps,
            collect_trace=True))
        _assert_runs_equal(fr, solo)
        assert fr.completed
        validate_run(fr, n_homes=e.homes)


def test_fleet_packed_members_equal_dense_fleet():
    for a, b in zip(run_fleet(_fleet(packed=True), device="cpu"),
                    run_fleet(_fleet(packed=False), device="cpu")):
        _assert_runs_equal(a, b)


def test_fleet_runs_one_batched_step_per_step(monkeypatch):
    """The whole fleet goes through ONE ``step_folded`` call a step, on a
    leading member axis — not a loop of solo runs."""
    calls = []
    real = engine_mn.step_folded

    def spy(tables, st, *args, **kw):
        calls.append(tuple(st.msg_count.shape))
        return real(tables, st, *args, **kw)

    monkeypatch.setattr(driver_mod, "step_folded", spy)
    fleet = FleetConfig(members=_fleet(trace=False).members, steps=40)
    runs, ran = _engine_steps(lambda: run_fleet(fleet, device="cpu"))
    # the loop may stop at quiescence, before the budget's 40 steps.
    assert 0 < ran <= 40 and calls == [(4, 16)] * ran
    assert [int(r.counters.steps) for r in runs] == [40] * 4


def test_fleet_explicit_steps_budget():
    fleet = FleetConfig(members=_fleet(trace=False).members[:2], steps=30)
    assert fleet_steps(fleet) == 30
    for fr in run_fleet(fleet, device="cpu"):
        assert int(fr.counters.steps) == 30


def test_fleet_config_validation():
    e = EngineConfig(remotes=2, lines=L)
    s = StreamConfig(workload=WorkloadSpec("zipfian", ops=OPS))
    with pytest.raises(ValueError, match="at least one member"):
        FleetConfig(members=())
    with pytest.raises(ValueError, match="uniform"):
        FleetConfig(members=((e, s),
                             (EngineConfig(remotes=2, lines=2 * L), s)))
    with pytest.raises(ValueError, match="shared_credits"):
        FleetConfig(members=((EngineConfig(remotes=2, lines=L,
                                           shared_credits=True), s),))
    with pytest.raises(ValueError, match="credits"):
        FleetConfig(members=((EngineConfig(remotes=2, lines=L, homes=2,
                                           credits=4), s),))
    with pytest.raises(ValueError, match="WorkloadSpec"):
        wl = WorkloadSpec("zipfian", ops=OPS).materialize(2, L)
        FleetConfig(members=((e, StreamConfig(workload=wl)),))
    with pytest.raises(ValueError, match="ops must be uniform"):
        FleetConfig(members=(
            (e, s), (e, StreamConfig(workload=WorkloadSpec(
                "zipfian", ops=OPS + 1)))))
    with pytest.raises(ValueError, match="open-loop"):
        FleetConfig(members=((e, StreamConfig(
            workload=WorkloadSpec("zipfian", ops=OPS),
            arrivals=ArrivalSpec("at_step0", rate=1.0))),))
    with pytest.raises(ValueError, match="per-member steps"):
        FleetConfig(members=((e, StreamConfig(
            workload=WorkloadSpec("zipfian", ops=OPS), steps=100)),))
    with pytest.raises(ValueError, match="observability"):
        FleetConfig(members=((e, StreamConfig(
            workload=WorkloadSpec("zipfian", ops=OPS),
            observe=ObserveConfig())),))
    with pytest.raises(ValueError, match="collect_trace"):
        FleetConfig(members=((e, s), (e, StreamConfig(
            workload=WorkloadSpec("zipfian", ops=OPS),
            collect_trace=True))))


def test_fleet_mesh_and_packed_validation():
    e = EngineConfig(remotes=2, lines=L)
    s = StreamConfig(workload=WorkloadSpec("zipfian", ops=OPS))
    with pytest.raises(ValueError, match="mesh_devices"):
        FleetConfig(members=((e, s),), mesh_devices=-1)
    with pytest.raises(ValueError, match="uniform"):
        FleetConfig(members=((e, s),
                             (EngineConfig(remotes=2, lines=L,
                                           packed=True), s)))
    # the mesh splits members across CUDA devices: none on the CPU.
    with pytest.raises(ValueError, match="mesh_devices=2"):
        run_fleet(FleetConfig(members=((e, s),), mesh_devices=2),
                  device="cpu")


def test_fleet_defaults_to_the_card():
    fleet = FleetConfig(members=_fleet().members[:1])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet(fleet)
