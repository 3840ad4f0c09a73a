"""The port's ``step_mn`` against the reference's, leaf by leaf.

Both engines start from the same state — the reference's initial state
carried into the port by ``repro_torch.convert`` — and take the same
seeded schedule of remote ops and home-side accesses; after EVERY step
every state leaf and every step output must be bit-identical (the
engine is integer arithmetic; the payload floats are only ever moved).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine_mn import EngineMN as JEngine  # noqa: E402
from repro.core.protocol import SUBSETS as JSUBSETS  # noqa: E402
from repro.traffic import (EngineConfig as JEngineConfig,  # noqa: E402
                           StreamConfig as JStreamConfig,
                           WorkloadSpec as JWorkloadSpec,
                           run_stream as j_run_stream)
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine_mn import EngineMN  # noqa: E402
from repro_torch.core.protocol import SUBSETS  # noqa: E402

SEED = 2024


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _assert_same(j_tree, t_tree, what):
    a, b = convert.flatten(_np_tree(j_tree)), convert.flatten(t_tree)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")


def _schedule(rng, R, L, B, t, n_ops):
    op = np.zeros((R, L), np.int8)
    if t < n_ops:
        for r in range(R):
            op[r, rng.integers(0, L)] = rng.choice([1, 2])
    val = rng.normal(size=(R, L, B)).astype(np.float32)
    wr = (rng.random(L) < 0.05) & (t < n_ops)
    ww = (rng.random(L) < 0.05) & (t < n_ops)
    wv = rng.normal(size=(L, B)).astype(np.float32)
    return op, val, wr, ww, wv


@pytest.mark.parametrize("moesi", [True, False], ids=["moesi", "mesi"])
@pytest.mark.parametrize("R", [2, 3, 8])
def test_step_mn_leaf_by_leaf(R, moesi):
    L, B, steps = 16, 2, 48
    rng = np.random.default_rng(SEED + R)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = JEngine(jnp.asarray(backing), n_remotes=R, moesi=moesi)
    te = EngineMN(backing, n_remotes=R, moesi=moesi, device="cpu")
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for t in range(steps):
        op, val, wr, ww, wv = _schedule(rng, R, L, B, t, steps - 16)
        js, jo = je.step(js, jnp.asarray(op), jnp.asarray(val),
                         jnp.asarray(wr), jnp.asarray(ww), jnp.asarray(wv))
        ts, to = te.step(ts, torch.as_tensor(op), torch.as_tensor(val),
                         torch.as_tensor(wr), torch.as_tensor(ww),
                         torch.as_tensor(wv))
        _assert_same(js, ts, f"state after step {t}")
        _assert_same(jo, to, f"output of step {t}")
    assert int(ts.msg_count.sum()) > 0


@pytest.mark.parametrize("name", ["read_only", "stateless"])
def test_step_mn_subsets_leaf_by_leaf(name):
    """The load-only subsets through the same dense step."""
    R, L, B = 4, 16, 2
    rng = np.random.default_rng(SEED)
    je = JEngine(jnp.zeros((L, B), jnp.float32), n_remotes=R,
                 subset=JSUBSETS[name])
    te = EngineMN(np.zeros((L, B), np.float32), n_remotes=R,
                  subset=SUBSETS[name], device="cpu")
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for t in range(24):
        op = np.zeros((R, L), np.int8)
        if t < 12:
            op[np.arange(R), rng.integers(0, L, R)] = 1      # LOAD
        val = np.zeros((R, L, B), np.float32)
        js, _ = je.step(js, jnp.asarray(op), jnp.asarray(val))
        ts, _ = te.step(ts, torch.as_tensor(op), torch.as_tensor(val))
        _assert_same(js, ts, f"{name} step {t}")


def test_state_convert_roundtrip():
    je = JEngine(jnp.zeros((8, 3), jnp.float32), n_remotes=3)
    js = _np_tree(je.init())
    ts = convert.engine_state_to_torch(js, "cpu")
    back = convert.engine_state_to_numpy(ts)
    _assert_same(js, back, "roundtrip")


def test_counters_convert_roundtrip():
    cfg = JStreamConfig(workload=JWorkloadSpec("zipfian", ops=8, seed=1))
    ctr = _np_tree(j_run_stream(JEngineConfig(remotes=3, lines=8).build(),
                                cfg).counters)
    tc = convert.counters_to_torch(ctr, "cpu")
    assert tc.occ_sum.dtype == torch.int64
    hi, lo = ctr.occ_sum_hi.astype(np.int64), ctr.occ_sum_lo.astype(np.int64)
    np.testing.assert_array_equal(tc.occ_sum.numpy(), (hi << 30) + lo)
    back = convert.counters_to_reference(tc)
    assert list(back) == list(ctr._fields)
    for f in ctr._fields:
        np.testing.assert_array_equal(back[f], getattr(ctr, f), err_msg=f)
        assert back[f].dtype == getattr(ctr, f).dtype, f


def test_drain_and_quiescence():
    R, L, B = 3, 8, 2
    te = EngineMN(np.zeros((L, B), np.float32), n_remotes=R, device="cpu")
    st = te.init()
    assert te.quiescent(st)
    op = torch.zeros((R, L), dtype=torch.int8)
    op[:, 0] = 2                                  # three stores, one line
    st, out = te.step(st, op, torch.ones((R, L, B)))
    assert not te.quiescent(st)
    st = te.drain(st, 256)
    assert te.quiescent(st)
    with pytest.raises(RuntimeError, match="still busy"):
        st2, _ = te.step(st, op, torch.ones((R, L, B)))
        te.drain(st2, 1)
