"""The port's RWKV6 block against ``repro.models.rwkv6``, on the CPU.

The reference's ``jax.random`` parameters (with a nonzero bonus ``u``,
base decay and norm gains, so every term of the recurrence counts) and
the same numpy inputs go through both packages: the token shift, the
block in prefill (the time mix's ``lax.scan`` against the port's chunked
scan, ``wkv_chunked``) and in decode from a non-zero state, one token and
several, with the new state, all at 2e-4 in fp32; the decode state's
layout; and decode against prefill on the smoke config.

The chunked scan is held on two heads over sequences that end inside, on
and past a chunk's edge, with decays from below 1e-2 to above 0.95 (a
chunk's log-decays summing far below -80), from zero and non-zero
states, at other chunk lengths, and in its gradients against
``jax.grad`` of the reference's block; an operation count keeps the
token loop from coming back.
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
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

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
    port's chunked scan against the reference's ``lax.scan``."""
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


# -- the chunked scan -------------------------------------------------------

C = trw.WKV_CHUNK
#: within a chunk, one short of it, on it, one past it, ragged over several
SEQS = (1, C - 1, C, C + 1, 3 * C + 5, 256)
#: ``tests/test_torch_train.py``'s gradient tolerances
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
#: aten operations one rwkv6 block dispatched to decode one token from a
#: state through the token loop the chunked scan replaced; decode keeps
#: the scan's step and must not grow
DECODE_OPS = 108


def _wide(key, S):
    """A two-head block (d = 128) with decays spread wide: the base decay
    over (-5, 3.5), so that, whatever tanh(x W_w) in (-1, 1) adds, a
    channel above 2.53 has w < 1e-2 and one below -3.97 has w > 0.95, and
    a token's log-decay reaches -e^4.5 (about -90)."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                               d_model=128)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                               d_model=128)
    p = jrw.rwkv_params(jax.random.key(key), jcfg, jnp.float32)
    rng = np.random.default_rng(key)
    d = jcfg.d_model
    wlog = rng.uniform(-5.0, 3.5, d)
    assert (wlog > 2.53).any() and (wlog < -3.97).any()
    p["wlog"] = jnp.asarray(wlog, jnp.float32)
    p["u"] = jnp.asarray(rng.standard_normal(d) * 0.5, jnp.float32)
    p["mix_k"] = jnp.asarray(rng.uniform(0, 1, d), jnp.float32)
    p["ln"] = p["ln"] + 0.1
    p["cm_ln"] = p["cm_ln"] - 0.1
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "nonzero"])
@pytest.mark.parametrize("S", SEQS)
def test_time_mix_chunked_equals_reference(S, nonzero):
    """``_time_mix`` in prefill (no ``last``) from a zero or a non-zero
    state: output, final state and last token."""
    jcfg, tcfg, p, x = _wide(7, S)
    s0 = _state(jcfg, 8)["s"] if nonzero else np.zeros(
        (B, 2, 64, 64), np.float32)
    w_out, w_s, w_last = jrw._time_mix(p, jcfg, jnp.asarray(x),
                                       jnp.asarray(s0), None)
    g_out, g_s, g_last = trw._time_mix(_t(p), tcfg, torch.as_tensor(x),
                                       torch.as_tensor(s0), None)
    _close(g_out, w_out)
    _close(g_s, w_s)
    _close(g_last, w_last)


@pytest.mark.parametrize("decode", [False, True],
                         ids=["prefill", "decode"])
@pytest.mark.parametrize("S", SEQS)
def test_rwkv_block_chunked_equals_reference(S, decode):
    """``rwkv_block`` in prefill (zero state) and in a decode of S tokens
    from a non-zero state, with its new state."""
    jcfg, tcfg, p, x = _wide(9, S)
    st = _state(jcfg, 10) if decode else None
    want, wst = jrw.rwkv_block(
        p, jcfg, jnp.asarray(x),
        state=None if st is None else jax.tree_util.tree_map(jnp.asarray,
                                                              st))
    got, gst = trw.rwkv_block(_t(p), tcfg, torch.as_tensor(x),
                              state=None if st is None else _t(st))
    _close(got, want)
    if not decode:
        assert wst is None and gst is None
        return
    assert gst.keys() == wst.keys()
    for k in gst:
        _close(gst[k], wst[k])


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_time_mix_any_chunk_equals_reference(monkeypatch, chunk):
    """The chunk length changes nothing but the rounding: one token a
    chunk, chunks that do not divide S, one chunk longer than S."""
    monkeypatch.setattr(trw, "WKV_CHUNK", chunk)
    S = 3 * C + 5
    jcfg, tcfg, p, x = _wide(11, S)
    s0 = _state(jcfg, 12)["s"]
    w_out, w_s, _ = jrw._time_mix(p, jcfg, jnp.asarray(x), jnp.asarray(s0),
                                  None)
    g_out, g_s, _ = trw._time_mix(_t(p), tcfg, torch.as_tensor(x),
                                  torch.as_tensor(s0), None)
    _close(g_out, w_out)
    _close(g_s, w_s)


@pytest.mark.parametrize("decode", [False, True],
                         ids=["prefill", "decode"])
def test_rwkv_block_gradients_equal_reference(decode):
    """The gradients of a loss averaged over the tokens, as the training
    loss is (``sum(y * cotangent) / (B S)``), by the input, every
    parameter and (in decode) the state: autograd through the chunked
    scan against ``jax.grad`` through the reference's ``lax.scan``, at
    S = 3C + 5."""
    S = 3 * C + 5
    jcfg, tcfg, p, x = _wide(13, S)
    st = _state(jcfg, 14) if decode else None
    cot = (np.random.default_rng(15).standard_normal(x.shape)
           / (B * S)).astype(np.float32)

    def jloss(p, x, st):
        y, _ = jrw.rwkv_block(p, jcfg, x, state=st)
        return jnp.sum(y * cot)

    jst = None if st is None else jax.tree_util.tree_map(jnp.asarray, st)
    w_p, w_x, w_st = jax.grad(jloss, argnums=(0, 1, 2))(
        p, jnp.asarray(x), jst)
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.as_tensor(x).requires_grad_()
    tst = None if st is None else {k: v.requires_grad_()
                                   for k, v in _t(st).items()}
    y, _ = trw.rwkv_block(tp, tcfg, tx, state=tst)
    (y * torch.as_tensor(cot)).sum().backward()
    pairs = [(tx.grad, w_x)] + [(tp[k].grad, w_p[k]) for k in tp]
    if decode:
        pairs += [(tst[k].grad, w_st[k]) for k in tst]
    for got, want in pairs:
        assert got is not None
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S", [1, 4096])
def test_block_dispatches_no_token_loop(S):
    """One block on the smoke config: a prefill of 4096 tokens dispatches
    at most S / 2 aten operations (a loop over the tokens dispatches
    about a dozen a token); a one-token decode no more than it did
    through that loop."""
    cfg = tconfigs.get_config(ARCH, smoke=True)
    p = trw.rwkv_params(torch.Generator().manual_seed(0), cfg,
                        torch.float32, "cpu")
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    state = trw.rwkv_init_state(cfg, B, "cpu") if S == 1 else None
    with _Count() as count:
        y, _ = trw.rwkv_block(p, cfg, x, state=state)
    assert y.shape == x.shape and bool(y.isfinite().all())
    assert count.n <= (DECODE_OPS if S == 1 else S // 2), count.n
