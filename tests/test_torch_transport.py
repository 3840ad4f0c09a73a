"""The port's transport and agent primitives against the reference's, on
random planes (bit-exact; the per-row credit rank runs its plain
version here)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import agent as jag  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro_torch.core import agent as tag  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402

SEED = 77


def _channel(rng, shape, B=2):
    msg = np.where(rng.random(shape) < 0.4,
                   rng.integers(1, 12, shape), 0).astype(np.int8)
    dirty = rng.random(shape) < 0.3
    payload = rng.normal(size=shape + (B,)).astype(np.float32)
    age = rng.integers(0, 4, shape).astype(np.int32)
    return (jtp.Channel(*(jnp.asarray(x) for x in (msg, dirty, payload,
                                                     age))),
            ttp.Channel(*(torch.as_tensor(x) for x in (msg, dirty, payload,
                                                         age))))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("shape", [(16,), (4, 16), (3, 2, 9)])
@pytest.mark.parametrize("cls", [jtp.CLASS_REMOTE_REQ, jtp.CLASS_HOME_REQ])
def test_occupancy_and_credit_accept(shape, cls):
    rng = np.random.default_rng(SEED)
    jch, tch = _channel(rng, shape)
    _eq(ttp.occupancy(tch, cls), jtp.occupancy(jch, cls))
    cand = (rng.random(shape) < 0.5) & (np.asarray(jch.msg) == 0)
    credits = rng.integers(0, 4, jtp.N_VCS).astype(np.int32)
    for shared in (False, True):
        want = jtp.credit_accept(jch, cls, jnp.asarray(cand),
                                 jnp.asarray(credits), shared=shared)
        got = ttp.credit_accept(tch, cls, torch.as_tensor(cand),
                                torch.as_tensor(credits), shared=shared)
        _eq(got, want)


@pytest.mark.parametrize("unbounded", [False, True])
def test_submit_tick_deliver(unbounded):
    rng = np.random.default_rng(SEED + 1)
    shape = (5, 12)
    jch, tch = _channel(rng, shape)
    want_mask = rng.random(shape) < 0.6
    msg = rng.integers(1, 12, shape).astype(np.int8)
    dirty = rng.random(shape) < 0.5
    pay = rng.normal(size=shape + (2,)).astype(np.float32)
    credits = np.full(jtp.N_VCS, 3, np.int32)
    jout, jacc = jtp.submit(jch, jtp.CLASS_REMOTE_REQ, jnp.asarray(want_mask),
                            jnp.asarray(msg), jnp.asarray(dirty),
                            jnp.asarray(pay), jnp.asarray(credits),
                            unbounded=unbounded)
    tout, tacc = ttp.submit(tch, ttp.CLASS_REMOTE_REQ,
                            torch.as_tensor(want_mask), torch.as_tensor(msg),
                            torch.as_tensor(dirty), torch.as_tensor(pay),
                            torch.as_tensor(credits), unbounded=unbounded)
    _eq(tacc, jacc)
    for _ in range(3):
        jout, tout = jtp.tick(jout), ttp.tick(tout)
        delays = jnp.asarray(jtp.DEFAULT_DELAYS)
        jout, jarr = jtp.deliver(jout, jtp.CLASS_HOME_RESP, delays)
        tout, tarr = ttp.deliver(tout, ttp.CLASS_HOME_RESP,
                                 torch.as_tensor(jtp.DEFAULT_DELAYS))
        _eq(tarr, jarr)
        _eq(ttp.any_in_flight(tout), jtp.any_in_flight(jout))
        for a, b in zip(tout, jout):
            _eq(a, b)


def test_read_hit_values():
    rng = np.random.default_rng(SEED + 2)
    R, L, B = 3, 8, 2
    rs = rng.integers(0, 4, (R, L)).astype(np.int8)
    cache = rng.normal(size=(R, L, B)).astype(np.float32)
    mask = rng.random((R, L)) < 0.5
    j = jag.make_agent(L, B)._replace(remote_state=jnp.asarray(rs),
                                      cache=jnp.asarray(cache))
    t = tag.make_agent(L, B, lead=(R,))._replace(
        remote_state=torch.as_tensor(rs), cache=torch.as_tensor(cache))
    _eq(tag.read_hit_values(t, torch.as_tensor(mask)),
        jag.read_hit_values(j, jnp.asarray(mask)))
