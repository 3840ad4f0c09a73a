"""The port's encoder-decoder path against ``repro.models``, on the CPU.

whisper-small's smoke config (2 encoder layers over 16 frames, 2 decoder
layers) with the reference's ``jax.random`` parameters carried across by
``convert.model_params_to_torch``: the non-causal attention block and the
cross-attention block (and chameleon's, whose ``q_norm`` applies to the
cross query), ``encode``, the per-superlayer cross K/V (and
``convert.cross_kv_to_torch``), ``decode_step`` with the reference's
cross K/V and without it (the cross-attention skipped, as the
reference's), a forward without frames refused, and decode against
prefill — all at 2e-4 in fp32.  The reference's attention takes its
Pallas kernel in interpret mode, as the port's routing mirrors.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.transformer import _cross_kv, encode as j_encode  # noqa
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import models as K  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-4
ARCH = "whisper-small"
B, S = 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    tcfg = tconfigs.get_config(ARCH, smoke=True)
    jp = j_init_params(jax.random.key(11), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((B, jcfg.encoder.n_frames, jcfg.d_model)
                                 ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, frames, toks


def _attn(arch, key):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    p = jL.attn_params(jax.random.key(key), jcfg, jnp.float32)
    p = {k: v + 0.1 if k.endswith("norm") or k == "ln" else v
         for k, v in p.items()}                  # nonzero norm gains
    return jcfg, tcfg, p


@pytest.mark.parametrize("arch", [ARCH, "chameleon-34b"])
def test_attention_block_noncausal_equals_reference(arch):
    jcfg, tcfg, p = _attn(arch, 1)
    x = np.random.default_rng(1).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    pos = np.arange(16)
    want, _ = jL.attention_block(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 window=None, causal=False, use_kernel=True)
    got, _ = tL.attention_block(_t(p), tcfg, torch.as_tensor(x),
                                torch.as_tensor(pos), window=None,
                                causal=False)
    _close(got, want)
    causal, _ = tL.attention_block(_t(p), tcfg, torch.as_tensor(x),
                                   torch.as_tensor(pos), window=None)
    assert not torch.allclose(got, causal)       # the mask matters


@pytest.mark.parametrize("Sq", [1, 8])
@pytest.mark.parametrize("arch", [ARCH, "chameleon-34b"])
def test_attention_block_cross_equals_reference(arch, Sq):
    """Cross-attention over given K/V [B, Hkv, T=16, hd]: no k/v
    projection, no rotary, ``q_norm`` where the config has it, no cache,
    at one query (decode) and several."""
    jcfg, tcfg, p = _attn(arch, 2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, Sq, jcfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, jcfg.n_kv_heads, 16, jcfg.head_dim_)
                              ).astype(np.float32) for _ in range(2)]
    pos = np.arange(Sq) + 5
    cache = tuple(torch.zeros((B, jcfg.n_kv_heads, 4, jcfg.head_dim_))
                  for _ in range(2))
    for use_kernel in (True, False):
        want, wc = jL.attention_block(
            p, jcfg, jnp.asarray(x), jnp.asarray(pos), window=None,
            use_kernel=use_kernel, cross_kv=tuple(map(jnp.asarray, kv)))
        got, gc = tL.attention_block(
            _t(p), tcfg, torch.as_tensor(x), torch.as_tensor(pos),
            window=None, kv_cache=cache, cache_index=0,
            cross_kv=tuple(map(torch.as_tensor, kv)), use_kernel=use_kernel)
        assert wc is None and gc is None
        _close(got, want)
    assert all(bool((c == 0).all()) for c in cache)    # no cache written


def test_encode_equals_reference():
    jcfg, tcfg, jp, tp, frames, _ = _model()
    want = j_encode(jp, jcfg, jnp.asarray(frames), use_kernel=True)
    K.reset_launches()
    got = T.encode(tp, tcfg, torch.as_tensor(frames))
    assert K.launches["flash_attention"] == 0     # the CPU: plain versions
    assert got.shape == frames.shape
    _close(got, want)


def test_cross_kv_equals_reference():
    jcfg, tcfg, jp, tp, frames, _ = _model()
    enc = np.array(j_encode(jp, jcfg, jnp.asarray(frames)))
    wk, wv = _cross_kv(jp["cross"], jcfg, jnp.asarray(enc))
    got = T.cross_kv(tp, tcfg, torch.as_tensor(enc))
    assert len(got) == tcfg.n_superlayers == wk.shape[0]
    for li, (k, v) in enumerate(got):
        assert tuple(k.shape) == wk.shape[1:]
        _close(k, wk[li])
        _close(v, wv[li])
    conv = convert.cross_kv_to_torch((np.asarray(wk), np.asarray(wv)), "cpu")
    for li, (ck, cv) in enumerate(conv):
        np.testing.assert_array_equal(ck.numpy(), np.asarray(wk[li]))
        np.testing.assert_array_equal(cv.numpy(), np.asarray(wv[li]))


@pytest.mark.parametrize("with_cross", [True, False],
                         ids=["cross", "no_cross"])
def test_decode_steps_equal_reference(with_cross):
    """8 decode steps with the reference's cross K/V fed to both packages,
    and without (the cross-attention skipped in both)."""
    jcfg, tcfg, jp, tp, frames, toks = _model()
    cross = tcross = None
    if with_cross:
        cross = _cross_kv(jp["cross"], jcfg,
                          j_encode(jp, jcfg, jnp.asarray(frames)))
        tcross = convert.cross_kv_to_torch(_np(cross), "cpu")
    step = jax.jit(j_decode_step, static_argnums=(1,))
    js = j_init_state(jcfg, B, S)
    ts = T.init_decode_state(tcfg, B, S, "cpu")
    for t in range(S):
        want, js = step(jp, jcfg, jnp.asarray(toks[:, t]),
                        jnp.asarray(t, jnp.int32), js, cross)
        got, ts = T.decode_step(tp, tcfg, torch.as_tensor(toks[:, t]), t, ts,
                                cross=tcross)
        _close(got, want)
    back = convert.decode_state_to_numpy(ts, tcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np(js))[0]:
        node = back
        for key in path:
            node = node[key.key]
        _close(torch.as_tensor(node), leaf)


def test_forward_without_frames_raises():
    _, tcfg, _, tp, _, toks = _model()
    with pytest.raises(ValueError, match="frames"):
        T.forward(tp, tcfg, torch.as_tensor(toks))


def test_params_layout():
    """The port's own draw has the converted tree's layout: the encoder's
    layers and one cross-attention dict a superlayer."""
    _, tcfg, _, ref, _, _ = _model()
    got = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert got.keys() == ref.keys() == {"embed", "layers", "encoder",
                                        "cross"}
    assert len(got["encoder"]["layers"]) == tcfg.encoder.n_layers
    assert len(got["cross"]) == tcfg.n_superlayers

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    assert shapes(got) == shapes(ref)


def test_decode_matches_prefill():
    """fp32 decode (the cross K/V computed once) against prefill at 2e-4
    (``tests/test_models.py::test_decode_matches_prefill``)."""
    cfg = tconfigs.get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(4)
    params = T.init_params(cfg, generator=gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, 12), generator=gen)
    frames = torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                         generator=gen)
    want = T.forward(params, cfg, toks, frames=frames)[:, -1]
    cross = T.cross_kv(params, cfg, T.encode(params, cfg, frames))
    state = T.init_decode_state(cfg, B, 12, "cpu")
    for t in range(12):
        got, state = T.decode_step(params, cfg, toks[:, t], t, state,
                                   cross=cross)
    _close(got, want.numpy())
