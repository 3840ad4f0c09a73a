"""The port's two-node engine against the reference's, on the CPU.

``core/directory.py``, ``core/engine.py`` (``step``, ``stall_unready_ops``,
``Engine.run_ops``) and ``EngineMN.run_ops`` against ``repro`` on the same
seeded inputs, leaf by leaf and bit for bit (the engines are integer
arithmetic; payload floats are only ever moved); and a bisimulation of
the port's ``Engine`` against the port's own atomic oracle
``core/model_ref.TwoNodeRef`` over numpy-drawn programs, as
``tests/test_protocol.py`` does with hypothesis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import directory as jdr  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.core.engine_mn import EngineMN as JEngineMN  # noqa: E402
from repro.core.protocol import FULL as JFULL  # noqa: E402
from repro.core.protocol import MINIMAL as JMINIMAL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import directory as tdr  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.core.engine_mn import EngineMN  # noqa: E402
from repro_torch.core.model_ref import TwoNodeRef  # noqa: E402
from repro_torch.core.protocol import LocalOp, two_node_tables  # noqa: E402
from repro_torch.kernels import coherency_step as K  # noqa: E402

SEED = 2424
MODES = {"moesi": (True, False), "mesi": (False, False),
         "stateless": (False, True)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _assert_same(j_tree, t_tree, what):
    a, b = convert.flatten(_np_tree(j_tree)), convert.flatten(t_tree)
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_two_node_tables_are_the_dense_bakes():
    for moesi, dense in ((True, JFULL), (False, JMINIMAL)):
        tt = two_node_tables(moesi, "cpu")
        assert tt is two_node_tables(moesi, "cpu")       # cached
        assert tt.moesi is moesi
        for f in tt._fields[:-1]:
            want = getattr(dense, f)
            got = getattr(tt, f).numpy()
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("mode", list(MODES))
def test_process_against_reference(mode):
    moesi, stateless = MODES[mode]
    L, B = 512, 3
    rng = np.random.default_rng(SEED)
    hs = rng.integers(0, 5, L).astype(np.int8)
    vw = rng.integers(0, 3, L).astype(np.int8)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    home_buf = rng.normal(size=(L, B)).astype(np.float32)
    msg = rng.integers(0, 16, L).astype(np.int8)
    active = rng.random(L) < 0.7
    dirty = rng.random(L) < 0.5
    payload = rng.normal(size=(L, B)).astype(np.float32)
    ill = np.asarray(3, np.int32)
    jst = jdr.DirectoryState(*_j(hs, vw, backing, home_buf, ill))
    tst = tdr.DirectoryState(*_t(hs, vw, backing, home_buf, ill))
    jout = jdr.process(JFULL if moesi else JMINIMAL, jst, *_j(active, msg,
                       dirty, payload), stateless=stateless)
    tout = tdr.process(two_node_tables(moesi, "cpu"), tst,
                       *_t(active, msg, dirty, payload),
                       stateless=stateless)
    _assert_same(jout[0], tout[0], "state")
    for i, (a, b) in enumerate(zip(jout[1:], tout[1:])):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, i
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(i))
    if stateless:
        np.testing.assert_array_equal(tout[0].home_state.numpy(), hs)


def test_home_side_helpers_against_reference():
    L, B = 256, 2
    rng = np.random.default_rng(SEED + 1)
    st = (rng.integers(0, 5, L).astype(np.int8),
          rng.integers(0, 3, L).astype(np.int8),
          rng.normal(size=(L, B)).astype(np.float32),
          rng.normal(size=(L, B)).astype(np.float32),
          np.asarray(0, np.int32))
    jst, tst = jdr.DirectoryState(*_j(*st)), tdr.DirectoryState(*_t(*st))
    wr, ww = rng.random(L) < 0.5, rng.random(L) < 0.5
    mask, val = rng.random(L) < 0.5, rng.normal(size=(L, B)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tdr.needed_downgrade(tst, *_t(wr, ww)).numpy(),
        np.asarray(jdr.needed_downgrade(jst, *_j(wr, ww))))
    np.testing.assert_array_equal(tdr.home_read_value(tst).numpy(),
                                  np.asarray(jdr.home_read_value(jst)))
    _assert_same(jdr.home_apply_write(jst, *_j(mask, val)),
                 tdr.home_apply_write(tst, *_t(mask, val)), "apply_write")


def _program(rng, L, B, t, n_ops, stateless):
    """One step's inputs: a few remote ops and home-side wants."""
    op = np.zeros(L, np.int8)
    if t < n_ops:
        idx = rng.choice(L, 4, replace=False)
        op[idx] = rng.choice([1] if stateless else [1, 2, 3, 4], 4)
    val = rng.normal(size=(L, B)).astype(np.float32)
    wr = (rng.random(L) < 0.1) & (t < n_ops)
    ww = (rng.random(L) < 0.1) & (t < n_ops) & (not stateless)
    wv = rng.normal(size=(L, B)).astype(np.float32)
    return op, val, wr, ww, wv


def _engines(mode, L, B, credits=None, seed=SEED):
    moesi, stateless = MODES[mode]
    rng = np.random.default_rng(seed)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = jeng.Engine(jnp.asarray(backing), moesi=moesi, stateless=stateless,
                     credits=credits)
    te = teng.Engine(backing, moesi=moesi, stateless=stateless,
                     credits=credits, device="cpu")
    return rng, je, te


@pytest.mark.parametrize("mode", list(MODES))
def test_step_leaf_by_leaf(mode):
    """30 steps of a random program with home wants: every state leaf and
    every step output bit-identical after every step."""
    L, B = 16, 2
    rng, je, te = _engines(mode, L, B)
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    _assert_same(js, te.init(), "init")
    for t in range(30):
        inputs = _program(rng, L, B, t, 20, MODES[mode][1])
        js, jo = je.step(js, *_j(*inputs))
        ts, to = te.step(ts, *_t(*inputs))
        _assert_same(js, ts, f"state after step {t}")
        _assert_same(jo, to, f"output of step {t}")
    assert int(ts.msg_count.sum()) > 0
    if mode == "stateless":
        assert not ts.dir.home_state.any() and not ts.dir.view.any()


def test_cpu_step_launches_no_kernel():
    """On the CPU the step runs the plain versions of its kernels; the
    card's launches a step are held in ``tests/test_torch_gpu.py``."""
    _, _, te = _engines("moesi", 8, 2)
    before = dict(K.launches)
    te.step(te.init())
    assert K.launches == before


def test_stall_unready_ops_with_credits_exhausted():
    """One credit per VC: the dry run defers every op whose request the
    VC cannot take, exactly as the reference's does, and the engine stays
    leaf-identical while ops queue up behind the credit."""
    L, B = 16, 2
    rng = np.random.default_rng(SEED + 5)
    credits = np.ones(jtp.N_VCS, np.int32)
    msg = np.where(rng.random(L) < 0.3, 1, 0).astype(np.int8)
    ch = (msg, np.zeros(L, bool), np.zeros((L, B), np.float32),
          np.zeros(L, np.int32))
    eff = rng.integers(0, 5, L).astype(np.int8)
    rs = rng.integers(0, 4, L).astype(np.int8)
    for moesi, dense in ((True, JFULL), (False, JMINIMAL)):
        want = jeng.stall_unready_ops(
            dense, jtp.Channel(*_j(*ch)), *_j(eff, rs),
            jnp.zeros((L, B), jnp.float32), jnp.asarray(credits))
        got = teng.stall_unready_ops(
            two_node_tables(moesi, "cpu"), ttp.Channel(*_t(*ch)),
            *_t(eff, rs), torch.as_tensor(credits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() != eff).any()       # some ops were deferred

    rng, je, te = _engines("moesi", L, B, credits=credits, seed=SEED + 6)
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for t in range(24):
        op = np.full(L, int(LocalOp.LOAD) if t < 2 else 0, np.int8)
        if t == 8:
            op[:] = int(LocalOp.STORE)
        val = rng.normal(size=(L, B)).astype(np.float32)
        js, jo = je.step(js, *_j(op, val))
        ts, to = te.step(ts, *_t(op, val))
        _assert_same(js, ts, f"state after step {t}")
        _assert_same(jo, to, f"output of step {t}")


def _run_ops_case(rng, L, B, R=None):
    shape = (L,) if R is None else (R, L)
    opv = np.zeros(shape, np.int8)
    if R is None:
        opv[rng.choice(L, L // 2, replace=False)] = rng.choice(
            [1, 2, 3], L // 2)
    else:
        for line in rng.choice(L, L // 2, replace=False):
            opv[rng.integers(0, R), line] = rng.choice([1, 2])
    return opv, rng.normal(size=shape + (B,)).astype(np.float32)


def _assert_run_ops_same(jres, tres, what):
    js, jd, jv, jr, jb = jres
    ts, td, tv, tr, tb = tres
    _assert_same(js, ts, f"{what} state")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tr == int(jr) and tb == bool(jb), (what, tr, int(jr), tb, bool(jb))


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_run_ops_against_reference(mode):
    """Two rounds of submit-and-drain, then one cut short by
    ``max_rounds``: the same state, done, vals, rounds and still-busy
    flag as the reference's fused while_loop."""
    L, B = 16, 2
    rng, je, te = _engines(mode, L, B)
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for what, max_rounds in (("first", 64), ("second", 64), ("cut", 2)):
        opv, vv = _run_ops_case(rng, L, B)
        if MODES[mode][1]:
            opv[opv != 0] = int(LocalOp.LOAD)
        jres = je.run_ops(js, *_j(opv, vv), max_rounds)
        tres = te.run_ops(ts, *_t(opv, vv), max_rounds)
        _assert_run_ops_same(jres, tres, what)
        js, ts = jres[0], tres[0]
    assert tres[4]                            # the cut run is still busy


@pytest.mark.parametrize("R", [2, 8])
def test_engine_mn_run_ops_against_reference(R):
    L, B = 16, 2
    rng = np.random.default_rng(SEED + R)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = JEngineMN(jnp.asarray(backing), n_remotes=R)
    te = EngineMN(backing, n_remotes=R, device="cpu")
    js = je.init()
    ts = convert.engine_state_to_torch(_np_tree(js), "cpu")
    for what, max_rounds in (("first", 128), ("second", 128), ("cut", 3)):
        opv, vv = _run_ops_case(rng, L, B, R)
        jres = je.run_ops(js, *_j(opv, vv), max_rounds)
        tres = te.run_ops(ts, *_t(opv, vv), max_rounds)
        _assert_run_ops_same(jres, tres, f"R={R} {what}")
        js, ts = jres[0], tres[0]


def test_two_node_state_convert_round_trip():
    je = jeng.Engine(jnp.zeros((8, 3), jnp.float32))
    js = _np_tree(je.init())
    back = convert.engine_state_to_numpy(
        convert.engine_state_to_torch(js, "cpu"))
    _assert_same(js, back, "round trip")


class _Driver:
    """Drives the port's engine one transaction at a time, so its
    results compare with the atomic oracle (``tests/test_protocol.py``'s
    ``EngineDriver`` on the port)."""

    def __init__(self, moesi: bool, n_lines: int, block: int = 2):
        self.L, self.B = n_lines, block
        self.eng = teng.Engine(np.zeros((n_lines, block), np.float32),
                               moesi=moesi, device="cpu")
        self.st = self.eng.init()

    def _settle(self):
        self.st = self.eng.drain(self.st, max_steps=64)
        assert self.eng.quiescent(self.st), "engine failed to quiesce"

    def submit(self, line, op, val=None):
        opv = torch.zeros(self.L, dtype=torch.int8)
        opv[line] = int(op)
        vv = torch.zeros((self.L, self.B))
        if val is not None:
            vv[line] = float(val)
        result = None
        for _ in range(64):
            self.st, out = self.eng.step(self.st, op=opv, op_val=vv)
            if bool(out.load_done[line]):
                result = float(out.load_val[line, 0])
            opv = opv.masked_fill(out.accepted, 0)
            if not bool(opv.any()):
                break
        self._settle()
        if op == LocalOp.LOAD and result is None:
            result = float(self.st.agent.cache[line, 0])
        return result

    def home_read(self, line):
        want = torch.zeros(self.L, dtype=torch.bool)
        want[line] = True
        result = None
        for _ in range(64):
            self.st, out = self.eng.step(self.st, want_read=want)
            want = torch.zeros_like(want)
            if bool(out.hread_done[line]):
                result = float(out.hread_val[line, 0])
                break
        self._settle()
        return result

    def home_write(self, line, val):
        want = torch.zeros(self.L, dtype=torch.bool)
        want[line] = True
        vv = torch.zeros((self.L, self.B))
        vv[line] = float(val)
        self.st, _ = self.eng.step(self.st, want_write=want, wval=vv)
        self._settle()


@pytest.mark.parametrize("moesi", [True, False], ids=["moesi", "mesi"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_bisimulates_model_ref(moesi, seed):
    """Random programs of the six transactions: after every retired
    transaction the stable states of every line equal the oracle's, no
    transition is illegal, and every value read agrees."""
    n_lines = 4
    rng = np.random.default_rng(seed)
    ref = TwoNodeRef(n_lines, moesi=moesi)
    eng = _Driver(moesi, n_lines)
    for _ in range(25):
        op = rng.choice(["load", "store", "evict", "demote", "hread",
                         "hwrite"])
        line, val = int(rng.integers(0, n_lines)), int(rng.integers(1, 101))
        if op == "load":
            assert eng.submit(line, LocalOp.LOAD) == float(
                ref.remote_load(line))
        elif op == "store":
            ref.remote_store(line, val)
            eng.submit(line, LocalOp.STORE, val)
        elif op == "evict":
            ref.remote_evict(line)
            eng.submit(line, LocalOp.EVICT)
        elif op == "demote":
            ref.remote_demote(line)
            eng.submit(line, LocalOp.DEMOTE)
        elif op == "hread":
            assert eng.home_read(line) == float(ref.home_read(line))
        else:
            ref.home_write(line, val + 1000)
            eng.home_write(line, val + 1000)
        np.testing.assert_array_equal(
            eng.st.agent.remote_state.numpy(),
            [int(s) for s in ref.remote_state])
        np.testing.assert_array_equal(
            eng.st.dir.home_state.numpy(), [int(s) for s in ref.home_state])
        assert int(eng.st.dir.illegal) == 0
        assert int(eng.st.agent.illegal) == 0
    for line in range(n_lines):
        assert eng.submit(line, LocalOp.LOAD) == float(ref.remote_load(line))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.Engine(np.zeros((4, 2), np.float32))
