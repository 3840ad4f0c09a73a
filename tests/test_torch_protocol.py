"""The port's copies of the protocol tables, constants, EWF v2 packing,
workload generators and the atomic oracle against the reference.

Everything here is integer or table data, so every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import messages as jmsg  # noqa: E402
from repro.core import multinode as jmn  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core import states as jstates  # noqa: E402
from repro.core import engine_mn as jeng  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.traffic import counters as jctr  # noqa: E402
from repro.traffic import driver as jdrv  # noqa: E402
from repro.traffic import workloads as jwl  # noqa: E402
from repro_torch.core import engine_mn as teng  # noqa: E402
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.core import multinode as tmn  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core import states as tstates  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.traffic import counters as tctr  # noqa: E402
from repro_torch.traffic import driver as tdrv  # noqa: E402
from repro_torch.traffic import workloads as twl  # noqa: E402

SUBSET_NAMES = ("full_moesi", "enhanced_mesi", "read_only", "stateless")
SEED = 4321


def _fields(dc):
    return {f: getattr(dc, f) for f in dc.__dataclass_fields__}


@pytest.mark.parametrize("name", SUBSET_NAMES)
def test_baked_tables_equal(name):
    j = jproto.bake_mn(jproto.SUBSETS[name])
    t = tproto.bake_mn(tproto.SUBSETS[name])
    for part_j, part_t in ((j, t), (j.base, t.base)):
        for field, want in _fields(part_j).items():
            if field == "base":
                continue
            got = getattr(part_t, field)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=field)
                assert got.dtype == want.dtype, field
            else:
                assert got == want, field


@pytest.mark.parametrize("name", SUBSET_NAMES)
def test_subset_definitions_equal(name):
    j, t = jproto.SUBSETS[name], tproto.SUBSETS[name]
    assert j.remote_may_send == t.remote_may_send
    assert j.home_may_send == t.home_may_send
    assert set(map(int, j.local_ops)) == set(map(int, t.local_ops))
    assert j.stateless_home == t.stateless_home
    for n in (1, 2, 64):
        assert j.allowed_ops(n) == t.allowed_ops(n)


@pytest.mark.parametrize("name", SUBSET_NAMES)
def test_device_tables_hold_the_bake(name):
    mn = tproto.bake_mn(tproto.SUBSETS[name])
    dt = tproto.device_tables(tproto.SUBSETS[name], "cpu")
    assert tproto.device_tables(tproto.SUBSETS[name], "cpu") is dt
    for field in ("grant_new_home", "grant_resp", "grant_wb", "grant_legal",
                  "grant_view", "absorb_new_home", "absorb_to_backing",
                  "absorb_to_homebuf", "op_ok"):
        np.testing.assert_array_equal(getattr(dt, field).numpy(),
                                      getattr(mn, field), err_msg=field)
    for field in ("loc_new_state", "loc_request", "loc_req_dirty", "loc_hit",
                  "rem_new_state", "rem_resp", "rem_resp_dirty", "rem_legal",
                  "resp_new_state"):
        np.testing.assert_array_equal(getattr(dt, field).numpy(),
                                      getattr(mn.base, field), err_msg=field)
    rv = [jproto.MN_REQUEST_VIEW.get(i, 0) for i in range(16)]
    np.testing.assert_array_equal(dt.request_view.numpy(), rv)


def test_enums_and_constants_equal():
    for j_enum, t_enum in ((jmsg.MsgType, tmsg.MsgType),
                           (jstates.HomeState, tstates.HomeState),
                           (jstates.RemoteState, tstates.RemoteState),
                           (jstates.RemoteView, tstates.RemoteView)):
        assert {e.name: int(e) for e in j_enum} == \
            {e.name: int(e) for e in t_enum}
    for name in ("NOP", "LOAD", "STORE", "EVICT", "DEMOTE", "N"):
        assert getattr(jproto.LocalOp, name) == getattr(tproto.LocalOp, name)
    for name in ("VOL_I", "REPLY_S", "REPLY_I", "N"):
        assert getattr(jproto.MnAbsorb, name) == \
            getattr(tproto.MnAbsorb, name)
    assert jproto.MN_REQUEST_VIEW == tproto.MN_REQUEST_VIEW
    assert jmsg.MAX_NODE == tmsg.MAX_NODE
    assert jeng.MAX_REMOTES == teng.MAX_REMOTES
    assert jeng.HOME_TXN == teng.HOME_TXN
    np.testing.assert_array_equal(jctr.LAT_EDGES, tctr.LAT_EDGES)
    np.testing.assert_array_equal(jtp.DEFAULT_CREDITS, ttp.DEFAULT_CREDITS)
    np.testing.assert_array_equal(jtp.DEFAULT_DELAYS, ttp.DEFAULT_DELAYS)
    assert (jtp.N_VCS, jtp.CLASS_REMOTE_REQ, jtp.CLASS_HOME_RESP,
            jtp.CLASS_HOME_REQ, jtp.CLASS_REMOTE_RESP) == \
        (ttp.N_VCS, ttp.CLASS_REMOTE_REQ, ttp.CLASS_HOME_RESP,
         ttp.CLASS_HOME_REQ, ttp.CLASS_REMOTE_RESP)
    for ops, r in ((32, 2), (128, 64), (1, 1)):
        assert jdrv.default_steps(ops, r) == tdrv.default_steps(ops, r)


def _fields_draw(rng, n):
    return dict(
        msg_type=rng.integers(0, 16, n), vc=rng.integers(0, 16, n),
        has_payload=rng.integers(0, 2, n), dirty=rng.integers(0, 2, n),
        node=rng.integers(0, 64, n),
        line=rng.integers(0, 1 << 32, n, dtype=np.int64),
        # EWF v2 has a 16-bit txn field: draw within it.
        txn=rng.integers(0, 1 << 16, n))


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_ewf_pack_matches_reference(n):
    f = _fields_draw(np.random.default_rng(SEED + n), n)
    want = jmsg.pack(**f)
    got = tmsg.pack(**{k: torch.as_tensor(v) for k, v in f.items()})
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_ewf_unpack_matches_reference():
    f = _fields_draw(np.random.default_rng(SEED), 500)
    words = jmsg.pack(**f)
    want = jmsg.unpack(words)
    got = tmsg.unpack(torch.as_tensor(words.view(np.int64)))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.txn.numpy(), f["txn"])


def test_ewf_field_extremes_roundtrip():
    f = dict(msg_type=15, vc=15, has_payload=1, dirty=1, node=63,
             line=(1 << 32) - 1, txn=(1 << 16) - 1)
    w = tmsg.pack(**f)
    assert int(w.numpy().view(np.uint64)) == int(jmsg.pack(**f))
    back = tmsg.unpack(w)
    assert {k: int(getattr(back, k)) for k in f} == f


@pytest.mark.parametrize("name", ["sequential", "strided",
                                  "producer_consumer", "migratory"])
def test_deterministic_lines_equal_reference(name):
    import jax
    R, L, T = 5, 16, 40
    j = jwl.WORKLOADS[name](jax.random.key(0), T, R, L)
    t = twl.WORKLOADS[name](np.random.default_rng(0), T, R, L)
    np.testing.assert_array_equal(t.line, np.asarray(j.line))
    np.testing.assert_array_equal(t.value, np.asarray(j.value))
    if name in ("producer_consumer", "migratory"):
        np.testing.assert_array_equal(t.op, np.asarray(j.op))


@pytest.mark.parametrize("name", sorted(twl.WORKLOADS))
def test_generators_shapes_and_seeding(name):
    R, L, T = 4, 32, 50
    a = twl.WORKLOADS[name](np.random.default_rng(3), T, R, L)
    b = twl.WORKLOADS[name](np.random.default_rng(3), T, R, L)
    for x, y, dt in zip(a, b, (np.int8, np.int32, np.float32)):
        assert x.shape == (T, R) and x.dtype == dt
        np.testing.assert_array_equal(x, y)
    assert set(np.unique(a.op)) <= {0, 1, 2}
    assert a.line.min() >= 0 and a.line.max() < L


def test_oracle_copy_matches_reference():
    """The port's ``MultiNodeRef`` copy sends the same messages and ends
    in the same state as the reference on a random program."""
    rng = np.random.default_rng(SEED)
    R, L = 5, 6
    for moesi in (True, False):
        j = jmn.MultiNodeRef(L, n_remotes=R, moesi=moesi)
        t = tmn.MultiNodeRef(L, n_remotes=R, moesi=moesi)
        for k in range(400):
            r, line, op = (int(rng.integers(R)), int(rng.integers(L)),
                           int(rng.integers(4)))
            if op == 0:
                assert j.load(r, line) == t.load(r, line)
            elif op == 1:
                j.store(r, line, k)
                t.store(r, line, k)
            elif op == 2:
                j.evict(r, line)
                t.evict(r, line)
            else:
                assert j.home_read(line) == t.home_read(line)
        assert j.trace == t.trace
        assert [list(map(int, s)) for s in j.remote_state] == \
            [list(map(int, s)) for s in t.remote_state]
        assert list(map(int, j.home_state)) == list(map(int, t.home_state))
        j.check_all()
        t.check_all()


def test_two_node_oracle_copy_matches_reference():
    from repro.core import model_ref as jref
    from repro_torch.core import model_ref as tref
    rng = np.random.default_rng(SEED + 1)
    for moesi in (True, False):
        j, t = jref.TwoNodeRef(6, moesi=moesi), tref.TwoNodeRef(6, moesi=moesi)
        for k in range(300):
            line, op = int(rng.integers(6)), int(rng.integers(6))
            if op == 0:
                assert j.remote_load(line) == t.remote_load(line)
            elif op == 1:
                j.remote_store(line, k)
                t.remote_store(line, k)
            elif op == 2:
                j.remote_evict(line)
                t.remote_evict(line)
            elif op == 3:
                j.remote_demote(line)
                t.remote_demote(line)
            elif op == 4:
                assert j.home_read(line) == t.home_read(line)
            else:
                j.home_write(line, -k)
                t.home_write(line, -k)
        assert j.trace == t.trace
        t.check_all()
