"""The port's protocol checks and subset metrics against the reference's.

* ``verify_envelope`` / ``verify_envelope_mn`` return the reference's
  violation lists: empty on every lattice member, the same list on
  deliberately broken tables;
* ``subset_metrics``/``subset_metrics_mn`` and
  ``reachable_joint_states``/``reachable_joint_states_mn`` equal the
  reference's on every member of the subset lattice (as in
  ``tests/test_specialize_mn.py``);
* ``test_properties.py::test_transport_conservation`` on the port's
  ``core/transport.py``: no message lost or duplicated, per-VC
  occupancy within credit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import protocol as jp  # noqa: E402
from repro.core import specialize as js  # noqa: E402
from repro_torch.core import protocol as tpr  # noqa: E402
from repro_torch.core import specialize as ts  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.core.messages import MsgType  # noqa: E402

NAMES = sorted(jp.SUBSETS)


@pytest.mark.parametrize("name", NAMES)
def test_envelope_mn_equals_reference(name):
    want = jp.verify_envelope_mn(jp.bake_mn(jp.SUBSETS[name]))
    assert want == []
    assert tpr.verify_envelope_mn(tpr.bake_mn(tpr.SUBSETS[name])) == want


@pytest.mark.parametrize("moesi", [True, False])
def test_envelope_two_node_equals_reference(moesi):
    want = jp.verify_envelope(jp.bake(moesi))
    assert tpr.verify_envelope(tpr.bake(moesi)) == want == []


def _break_mn(mod, name):
    """Baked MN tables with a response that depends on the home state, a
    grant made illegal and a reply the home may no longer send."""
    t = mod.bake_mn(mod.SUBSETS[name])
    M = MsgType
    resp = t.grant_resp.copy()
    resp[int(M.REQ_READ_SHARED), 1] = int(M.RESP_DATA_DIRTY)
    legal = t.grant_legal.copy()
    legal[int(M.REQ_READ_EXCL), 0] = False
    home_ok = t.home_send_ok.copy()
    home_ok[int(M.HOME_DOWNGRADE_S)] = False
    return dataclasses.replace(t, grant_resp=resp, grant_legal=legal,
                               home_send_ok=home_ok)


@pytest.mark.parametrize("name", ["full_moesi", "enhanced_mesi"])
def test_envelope_mn_broken_table_same_violations(name):
    want = jp.verify_envelope_mn(_break_mn(jp, name))
    assert len(want) >= 3
    assert tpr.verify_envelope_mn(_break_mn(tpr, name)) == want


def test_envelope_two_node_broken_tables_same_violations(monkeypatch):
    """A home row made to answer differently and a silent dirty->clean
    local edge: both packages report the same violations."""
    M = MsgType

    def broken_home(mod):
        real = mod.build_home_table

        def build(moesi):
            t = dict(real(moesi))
            key = (int(M.REQ_READ_SHARED), int(mod.H.S), int(mod.V.I))
            t[key] = dataclasses.replace(t[key], resp=int(M.RESP_DATA_DIRTY),
                                         new_view=int(mod.V.EM))
            return t
        return build

    def broken_local(mod):
        real = mod.build_local_table

        def build():
            t = dict(real())
            key = (int(mod.LocalOp.DEMOTE), int(mod.R.M))
            t[key] = dataclasses.replace(t[key], new_remote=int(mod.R.S),
                                         request=int(M.NOP))
            return t
        return build

    for mod in (jp, tpr):
        monkeypatch.setattr(mod, "build_home_table", broken_home(mod))
        monkeypatch.setattr(mod, "build_local_table", broken_local(mod))
    for moesi in (True, False):
        want = jp.verify_envelope(jp.bake(moesi))
        assert want
        assert tpr.verify_envelope(tpr.bake(moesi)) == want


@pytest.mark.parametrize("name", NAMES)
def test_subset_metrics_equal_reference(name):
    a, b = jp.SUBSETS[name], tpr.SUBSETS[name]
    assert ts.subset_metrics(b) == js.subset_metrics(a)
    assert ts.reachable_joint_states(b) == js.reachable_joint_states(a)
    for n in (1, 2, 3, 4, 8):
        assert ts.subset_metrics_mn(b, n) == js.subset_metrics_mn(a, n)
        assert ts.reachable_joint_states_mn(b, n) == \
            js.reachable_joint_states_mn(a, n)


def test_mn_joint_state_counts():
    """The N-node protocol-size table (``tests/test_specialize_mn.py``):
    READ_ONLY's sharer vector is a presence bitmap (n+1 classes),
    STATELESS is one state at any n, the full protocols grow beyond."""
    assert sorted(ts.reachable_joint_states_mn(ts.READ_ONLY, 3)) == \
        ["I:III", "I:IIS", "I:ISS", "I:SSS"]
    for n in (2, 4, 8):
        assert ts.subset_metrics_mn(ts.STATELESS, n)["joint_states_mn"] == 1
        ro = ts.subset_metrics_mn(ts.READ_ONLY, n)["joint_states_mn"]
        assert ro == n + 1
        assert ts.subset_metrics_mn(ts.FULL_MOESI, n)["joint_states_mn"] \
            > ro
    assert [ts.subset_metrics_mn(s, 4)["view_domain"] for s in
            (ts.READ_ONLY, ts.FULL_MOESI, ts.STATELESS)] == [2, 3, 1]


def test_custom_subset_verifies_under_its_own_name():
    custom = dataclasses.replace(tpr.READ_ONLY, name="custom_read_only")
    assert tpr.verify_envelope_mn(tpr.bake_mn(custom)) == []
    with pytest.raises(ValueError):
        tpr.bake_mn(dataclasses.replace(tpr.READ_ONLY))


@pytest.mark.parametrize("seed,credit", [(0, 1), (1, 2), (7, 3), (42, 4),
                                         (1234, 8), (99991, 5)])
def test_transport_conservation(seed, credit):
    """Messages are never lost or duplicated; per-VC occupancy never
    exceeds credits (``tests/test_properties.py``, on the port)."""
    rng = np.random.RandomState(seed)
    L, B = 16, 2
    ch = ttp.make_channel(L, B, device="cpu")
    credits = torch.full((ttp.N_VCS,), credit, dtype=torch.int32)
    delays = torch.as_tensor(ttp.DEFAULT_DELAYS)
    sent = np.zeros(L, np.int64)
    recv = np.zeros(L, np.int64)
    msg = torch.full((L,), int(MsgType.REQ_READ_SHARED), dtype=torch.int8)
    for _ in range(30):
        want = torch.as_tensor(rng.rand(L) < 0.5)
        ch, acc = ttp.submit(ch, ttp.CLASS_REMOTE_REQ, want, msg,
                             torch.zeros(L, dtype=torch.bool),
                             torch.zeros((L, B)), credits)
        sent += acc.numpy()
        occ = ttp.occupancy(ch, ttp.CLASS_REMOTE_REQ).numpy()
        assert (occ <= credit).all(), occ
        ch = ttp.tick(ch)
        ch, ready = ttp.deliver(ch, ttp.CLASS_REMOTE_REQ, delays)
        recv += ready.numpy()
    for _ in range(10):
        ch = ttp.tick(ch)
        ch, ready = ttp.deliver(ch, ttp.CLASS_REMOTE_REQ, delays)
        recv += ready.numpy()
    np.testing.assert_array_equal(sent, recv)
