"""The port's ``CoherentStore`` against ``repro.core.CoherentStore``, on
the CPU.

Every public method on the same program, for each of the four protocol
subsets and for one remote (the two-node engine) and eight (the N-remote
engine): the values returned, every state leaf and the accounting
(``hits``, ``misses``, ``interconnect_messages``, ``payload_bytes``) equal
bit for bit.  Then the store cases of ``tests/test_system.py`` and
``tests/test_specialize_mn.py`` on the port, the errors the reference
raises, and the baseline keys ``fanout.r2``/``fanout.r8`` as
``benchmarks/bench_smoke.py::run_fanout`` drives them.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CoherentStore as JStore  # noqa: E402
from repro.core.protocol import SUBSETS as JSUBSETS  # noqa: E402
from repro.traffic import WORKLOADS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (ENHANCED_MESI, FULL_MOESI,  # noqa: E402
                              READ_ONLY, STATELESS, SUBSETS, CoherentStore,
                              LocalOp, MultiNodeRef)
from repro_torch.core.engine_mn import EngineMN  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCK = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_state(j, t, what):
    a = convert.flatten(jax.tree_util.tree_map(np.asarray, j.state))
    b = convert.flatten(t.state)
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")


def _assert_same_accounting(j, t, what):
    assert t.interconnect_messages == j.interconnect_messages, what
    assert (t.hits, t.misses, t.payload_bytes, t.ops_issued) == \
        (j.hits, j.misses, j.payload_bytes, j.ops_issued), what


def _double(block):
    return block * 2.0 + 1.0


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("name", ["full_moesi", "enhanced_mesi", "read_only",
                                  "stateless"])
def test_store_against_reference(name, R):
    """Reads by several nodes and re-reads (hits); where the subset
    allows them, writes, evicts and a home_read of the dirty lines; a
    home_write of uncached lines; then a store with an operator: a
    virtual block read, evicted and read again."""
    L = 16
    rng = np.random.default_rng(7 + R)
    backing = rng.normal(size=(L, BLOCK)).astype(np.float32)
    js = JStore(jnp.asarray(backing), JSUBSETS[name], n_remotes=R)
    ts = CoherentStore(backing, SUBSETS[name], n_remotes=R, device="cpu")

    def both(call, *args, **kw):
        a = getattr(js, call)(*[jnp.asarray(x) if isinstance(x, np.ndarray)
                                else x for x in args], **kw)
        b = getattr(ts, call)(*args, **kw)
        if a is not None:
            np.testing.assert_array_equal(_np(b), np.asarray(a),
                                          err_msg=call)
        _assert_same_state(js, ts, call)
        _assert_same_accounting(js, ts, call)

    nodes = range(min(R, 3))
    for node in nodes:
        both("read", [3, 1, 4, 5, 9, 2, 6], node=node)
        both("read", [3, 1, 4], node=node)               # hits
    if name in ("full_moesi", "enhanced_mesi"):
        both("write", list(range(0, L, 2)),
             rng.normal(size=(L // 2, BLOCK)).astype(np.float32), node=0)
        both("evict", list(range(0, L, 4)), node=0)
        both("home_read", [2, 6, 10, 3])
        both("read", [2, 6], node=R - 1)
    else:
        both("evict", [3, 1], node=0)
    both("home_write", [12, 13], np.full((2, BLOCK), 5.0, np.float32))
    both("read", [12, 13], node=0)

    jo = JStore(jnp.asarray(backing), JSUBSETS[name], n_remotes=R,
                operator=lambda b: b * 2.0 + 1.0)
    to = CoherentStore(backing, SUBSETS[name], n_remotes=R,
                       operator=_double, device="cpu")
    js, ts = jo, to
    both("read", [5, 7], node=0)
    both("evict", [5], node=0)
    both("read", [5, 7], node=R - 1)
    np.testing.assert_array_equal(_np(ts.read([5])), backing[5:6] * 2 + 1)


def test_stateless_home_interop():
    """The stateless home serves a read-only workload with the full
    protocol's values and keeps no per-line state."""
    backing = np.arange(64, dtype=np.float32).reshape(16, 4)
    full = CoherentStore(backing, FULL_MOESI, device="cpu")
    stateless = CoherentStore(backing, STATELESS, device="cpu")
    ids = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    np.testing.assert_array_equal(_np(full.read(ids)),
                                  _np(stateless.read(ids)))
    assert int(stateless.state.dir.home_state.sum()) == 0
    assert int(stateless.state.dir.view.sum()) == 0
    assert int(stateless.state.dir.illegal) == 0
    stateless.evict([3, 1])
    assert int(stateless.state.dir.illegal) == 0


def test_readonly_subset_rejects_writes():
    ro = CoherentStore(np.zeros((8, 2), np.float32), READ_ONLY, device="cpu")
    ro.read([0, 1])
    with pytest.raises(ValueError, match="read_only"):
        ro.write([0], np.ones((1, 2), np.float32))


def test_temporal_locality_hits():
    cs = CoherentStore(np.arange(128, dtype=np.float32).reshape(32, 4),
                       READ_ONLY, device="cpu")
    for i in range(16):
        cs.read([i])
        if i >= 4:
            cs.read([i - 4])
        if i >= 8:
            cs.read([i - 8])
    assert cs.hits >= 0.9 * (16 - 4 + 16 - 8)


def test_operator_results_cached():
    calls = {"n": 0}

    def expensive(block):
        calls["n"] += 1
        return block * 2.0

    backing = np.arange(32, dtype=np.float32).reshape(8, 4)
    cs = CoherentStore(backing, STATELESS, operator=expensive, device="cpu")
    v = [_np(cs.read([2])) for _ in range(3)]
    np.testing.assert_array_equal(v[0], v[1])
    np.testing.assert_array_equal(v[0], v[2])
    assert calls["n"] == 1
    np.testing.assert_array_equal(v[0][0], backing[2] * 2.0)


def test_operator_not_rematerialized_after_evict():
    calls = {"n": 0}

    def accumulate(block):                 # deliberately non-idempotent
        calls["n"] += 1
        return block + 1.0

    cs = CoherentStore(np.zeros((4, 2), np.float32), STATELESS,
                       operator=accumulate, device="cpu")
    np.testing.assert_array_equal(_np(cs.read([1])), [[1.0, 1.0]])
    cs.evict([1])
    np.testing.assert_array_equal(_np(cs.read([1])), [[1.0, 1.0]])
    assert calls["n"] == 1


def test_operator_explicit_write_wins_over_operator():
    cs = CoherentStore(np.zeros((4, 2), np.float32), FULL_MOESI,
                       operator=lambda b: b + 1.0, device="cpu")
    cs.write([2], np.asarray([[7.0, 7.0]], np.float32))
    cs.evict([2])
    np.testing.assert_array_equal(_np(cs.read([2])), [[7.0, 7.0]])


def test_check_workload_on_reference_workloads():
    """One LocalOp encoding: the reference's workload arrays pass or fail
    the port's subset guarantee as they do the reference's."""
    demote = [int(LocalOp.DEMOTE)]
    assert FULL_MOESI.check_workload(demote)
    assert not FULL_MOESI.check_workload(demote, n_remotes=2)
    wl = WORKLOADS["zipfian"](jax.random.key(0), 16, 4, 8, store_frac=0.0)
    assert READ_ONLY.check_workload(np.asarray(wl.op), n_remotes=4)
    wl2 = WORKLOADS["zipfian"](jax.random.key(0), 16, 4, 8)
    assert not READ_ONLY.check_workload(np.asarray(wl2.op), n_remotes=4)
    assert FULL_MOESI.check_workload(np.asarray(wl2.op), n_remotes=4)


def test_store_mn_readonly_rejects_store():
    cs = CoherentStore(np.zeros((6, BLOCK), np.float32), READ_ONLY,
                       n_remotes=4, device="cpu")
    cs.read([0, 1], node=2)
    with pytest.raises(ValueError):
        cs.write([0], np.ones((1, BLOCK), np.float32), node=2)


def test_readonly_cuts_messages_per_op_vs_full():
    """``tests/test_specialize_mn.py``'s decode-fleet trace on the port:
    readers re-read hot records while a publisher refreshes one; READ_ONLY
    (the home publishes) costs fewer messages than FULL (a writer remote
    publishes)."""
    n_remotes, n_lines, rounds, publish_every = 4, 6, 12, 3
    n_readers = n_remotes - 1
    wl = WORKLOADS["zipfian"](jax.random.key(3), rounds, n_readers,
                              n_lines, store_frac=0.0)
    lines = np.array(wl.line)
    hot = int(np.bincount(lines.ravel(), minlength=n_lines).argmax())
    ar = np.arange(n_readers)
    msgs = {}
    for subset in (FULL_MOESI, READ_ONLY):
        eng = EngineMN(np.zeros((n_lines, BLOCK), np.float32),
                       n_remotes=n_remotes, subset=subset, device="cpu")
        st = eng.init()
        zvv = torch.zeros((n_remotes, n_lines, BLOCK))

        def read_round(st, t):
            opv = torch.zeros((n_remotes, n_lines), dtype=torch.int8)
            opv[ar, lines[t]] = int(LocalOp.LOAD)
            st, _, _, _, busy = eng.run_ops(st, opv, zvv, 256)
            assert not busy
            return st

        def publish(st, value):
            if subset is READ_ONLY:
                want = torch.zeros(n_lines, dtype=torch.bool)
                want[hot] = True
                wv = torch.zeros((n_lines, BLOCK))
                wv[hot] = float(value)
                st, _ = eng.step(st, want_write=want, wval=wv)
                st = eng.drain(st, max_steps=128)
                return st
            opv = torch.zeros((n_remotes, n_lines), dtype=torch.int8)
            opv[n_remotes - 1, hot] = int(LocalOp.STORE)
            vv = zvv.clone()
            vv[n_remotes - 1, hot] = float(value)
            st, _, _, _, busy = eng.run_ops(st, opv, vv, 256)
            assert not busy
            return st

        for t in range(rounds):
            st = read_round(st, t)
        st = publish(st, 1)
        base = int(st.msg_count.sum())
        for t in range(rounds):
            if t % publish_every == 0:
                st = publish(st, t + 2)
            st = read_round(st, t)
        msgs[subset.name] = int(st.msg_count.sum()) - base
    assert msgs["read_only"] < msgs["full_moesi"], msgs


@pytest.mark.parametrize("R", [1, 4])
def test_store_raises_what_the_reference_raises(R):
    cs = CoherentStore(np.zeros((8, 2), np.float32), STATELESS, n_remotes=R,
                       device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        cs.read([0], node=R)
    with pytest.raises(ValueError, match="stateless"):
        cs.write([0], np.ones((1, 2), np.float32))
    cs.read([3])
    with pytest.raises(ValueError, match="stateless home cannot"):
        cs.home_write([3], np.ones((1, 2), np.float32))
    cs.home_write([4], np.ones((1, 2), np.float32))     # uncached: fine
    short = CoherentStore(np.zeros((8, 2), np.float32), FULL_MOESI,
                          n_remotes=R, max_rounds=1, device="cpu")
    with pytest.raises(RuntimeError, match="max_rounds=1"):
        short.read([0, 1])
    short.max_rounds = 64
    short.state = short.engine.init()
    short.write([0], np.ones((1, 2), np.float32))
    short.max_rounds = 1
    with pytest.raises(RuntimeError, match="home_read did not retire"):
        short.home_read([0])
    with pytest.raises(ValueError, match="n_blocks, block"):
        CoherentStore(np.zeros(8, np.float32), device="cpu")


def test_store_past_the_remote_ceiling_raises():
    with pytest.raises(ValueError, match="n_remotes=65"):
        CoherentStore(np.zeros((4, 2), np.float32), n_remotes=65,
                      device="cpu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoherentStore(np.zeros((4, 2), np.float32), ENHANCED_MESI)


@pytest.mark.parametrize("n_remotes", [2, 8])
def test_fanout_baseline_keys(n_remotes):
    """``fanout.r{R}`` of ``benchmarks/BENCH_baseline.json``: every node
    reads every line, node 0 writes them all; the engine's invalidations
    per store equal the port's oracle's and R - 1."""
    n_lines, block = 8, 2
    cs = CoherentStore(np.zeros((n_lines, block), np.float32), FULL_MOESI,
                       n_remotes=n_remotes, max_rounds=128, device="cpu")
    ids = np.arange(n_lines)
    for node in range(n_remotes):
        cs.read(ids, node=node)
    before = cs.interconnect_messages.get("HOME_DOWNGRADE_I", 0)
    cs.write(ids, np.ones((n_lines, block), np.float32), node=0)
    sent = cs.interconnect_messages.get("HOME_DOWNGRADE_I", 0) - before
    ref = MultiNodeRef(1, n_remotes=n_remotes)
    for node in range(n_remotes):
        ref.load(node, 0)
    rbefore = ref.invalidation_messages()
    ref.store(0, 0, 1)
    got = {"invals_per_store": sent / n_lines,
           "oracle_invals_per_store": ref.invalidation_messages() - rbefore,
           "model": n_remotes - 1}
    base = json.loads((ROOT / "benchmarks" / "BENCH_baseline.json"
                       ).read_text())["fanout"][f"r{n_remotes}"]
    assert got == base
