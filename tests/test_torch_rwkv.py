"""The port's RWKV6 block against ``repro.models.rwkv6``, on the CPU.

The reference's ``jax.random`` parameters (with a nonzero bonus ``u``,
base decay and norm gains, so every term of the recurrence counts) and
the same numpy inputs go through both packages: the token shift, the
block in prefill (the time mix's ``lax.scan`` against the port's loop)
and in decode from a non-zero state, one token and several, with the new
state, all at 2e-4 in fp32; the decode state's layout; and decode
against prefill on the smoke config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-4
ARCH = "rwkv6-3b"
B = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _setup(key=1, S=8):
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    tcfg = tconfigs.get_config(ARCH, smoke=True)
    p = jrw.rwkv_params(jax.random.key(key), jcfg, jnp.float32)
    rng = np.random.default_rng(key)
    d = jcfg.d_model
    p["u"] = jnp.asarray(rng.standard_normal(d) * 0.5, jnp.float32)
    p["wlog"] = jnp.asarray(rng.standard_normal(d) * 0.5 - 1, jnp.float32)
    p["mix_k"] = jnp.asarray(rng.uniform(0, 1, d), jnp.float32)
    p["ln"] = p["ln"] + 0.1
    p["cm_ln"] = p["cm_ln"] - 0.1
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jcfg, tcfg, p, x


def _state(jcfg, key):
    rng = np.random.default_rng(key)
    d, hd = jcfg.d_model, jcfg.rwkv_head_dim
    return {"s": rng.standard_normal((B, d // hd, hd, hd)).astype(np.float32),
            "last": rng.standard_normal((B, d)).astype(np.float32),
            "cm_last": rng.standard_normal((B, d)).astype(np.float32)}


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_token_shift_equals_reference(decode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    mix = rng.uniform(0, 1, 64).astype(np.float32)
    last = rng.standard_normal((B, 64)).astype(np.float32) if decode \
        else None
    want = jrw._token_shift(jnp.asarray(x), jnp.asarray(mix),
                            None if last is None else jnp.asarray(last))
    got = trw._token_shift(torch.as_tensor(x), torch.as_tensor(mix),
                           None if last is None else torch.as_tensor(last))
    _close(got, want)


def test_rwkv_block_prefill_equals_reference():
    jcfg, tcfg, p, x = _setup()
    want, none = jrw.rwkv_block(p, jcfg, jnp.asarray(x))
    got, tnone = trw.rwkv_block(_t(p), tcfg, torch.as_tensor(x))
    assert none is None and tnone is None
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("S", [1, 4])
def test_rwkv_block_decode_from_nonzero_state_equals_reference(S):
    jcfg, tcfg, p, x = _setup(key=3, S=S)
    st = _state(jcfg, 4)
    want, wst = jrw.rwkv_block(p, jcfg, jnp.asarray(x),
                               state=jax.tree_util.tree_map(jnp.asarray, st))
    got, gst = trw.rwkv_block(_t(p), tcfg, torch.as_tensor(x), state=_t(st))
    _close(got, want)
    assert gst.keys() == wst.keys()
    for k in gst:
        assert tuple(gst[k].shape) == wst[k].shape, k
        _close(gst[k], wst[k])


def test_time_mix_final_state_equals_reference():
    """The recurrence's carried state after a prefill, from zeros: the
    port's loop against the reference's ``lax.scan``."""
    jcfg, tcfg, p, x = _setup(key=5, S=12)
    hd = jcfg.rwkv_head_dim
    s0 = np.zeros((B, jcfg.d_model // hd, hd, hd), np.float32)
    w_out, w_s, w_last = jrw._time_mix(p, jcfg, jnp.asarray(x),
                                       jnp.asarray(s0), None)
    g_out, g_s, g_last = trw._time_mix(_t(p), tcfg, torch.as_tensor(x),
                                       torch.as_tensor(s0), None)
    _close(g_out, w_out)
    _close(g_s, w_s)
    _close(g_last, w_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_and_params_layout(dtype):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                               dtype=dtype)
    want = jrw.rwkv_init_state(jcfg, 3)
    got = trw.rwkv_init_state(tcfg, 3, "cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert bool((got[k] == 0).all())
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    wp = jrw.rwkv_params(jax.random.key(0), jcfg, jdt)
    gp = trw.rwkv_params(torch.Generator().manual_seed(0), tcfg, tdt, "cpu")
    assert gp.keys() == wp.keys()
    for k in gp:
        assert tuple(gp[k].shape) == wp[k].shape, k
        assert str(gp[k].dtype).split(".")[-1] == str(wp[k].dtype), k
        if gp[k].dim() == 1:                       # constants, exactly
            np.testing.assert_array_equal(gp[k].float().numpy(),
                                          np.asarray(wp[k], np.float32))


def test_decode_matches_prefill():
    """fp32 decode through the carried state against prefill at 2e-4
    (``tests/test_models.py::test_decode_matches_prefill``)."""
    cfg = tconfigs.get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(3)
    params = T.init_params(cfg, generator=gen, device="cpu")
    assert all(layer.keys() == {"mixer"} for layer in params["layers"])
    toks = torch.randint(0, cfg.vocab, (B, 12), generator=gen)
    want = T.forward(params, cfg, toks)[:, -1]
    state = T.init_decode_state(cfg, B, 12, "cpu")
    for t in range(12):
        got, state = T.decode_step(params, cfg, toks[:, t], t, state)
    _close(got, want.numpy())
