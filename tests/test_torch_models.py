"""The port's model substrate against ``repro.models``, on the CPU.

The reference's parameters (``repro.models.init_params``, drawn from
``jax.random``) cross to the port through numpy
(``convert.model_params_to_torch``), so both packages compute the same
model on the same inputs: the config copies, each block (attention with
and without a KV cache, the three MLPs, the RG-LRU block in prefill and
decode, the LM head), and, for each of the ten smoke configs,
``forward`` (full and ``last_only``) and 12 ``decode_step``\\ s with their
final state, all in fp32 at the 2e-4 of ``tests/test_models.py``; for
whisper with the same frames and the reference's cross K/V fed to both.
The reference's forward takes its Pallas kernels (interpret mode), as the
port's routing mirrors; its ``decode_step`` is jitted once per config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.transformer import _cross_kv as j_cross_kv  # noqa: E402
from repro.models.transformer import encode as j_encode  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.serve import quantize as jq  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import models as K  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-4
SLICE_ARCHS = ["smollm-360m", "gemma2-9b", "granite-34b", "nemotron-4-340b",
               "chameleon-34b", "recurrentgemma-9b", "granite-moe-1b-a400m",
               "qwen3-moe-235b-a22b", "rwkv6-3b", "whisper-small"]
B, S, DECODE_S = 2, 16, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _jit_decode():
    return jax.jit(j_decode_step, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _run(arch):
    """The reference's and the port's forward, decode logits and final
    decode state for one smoke config, on the same parameters and tokens
    (computed once per config)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = j_init_params(jax.random.key(7), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S)
                                             ).astype(np.int32)
    tt = torch.as_tensor(toks).long()
    frames = cross = tframes = tcross = None
    if jcfg.encoder is not None:
        frames = np.random.default_rng(8).standard_normal(
            (B, jcfg.encoder.n_frames, jcfg.d_model)).astype(np.float32)
        tframes = torch.as_tensor(frames)
        cross = j_cross_kv(jp["cross"], jcfg,
                           j_encode(jp, jcfg, jnp.asarray(frames)))
        tcross = convert.cross_kv_to_torch(_np(cross), "cpu")
        frames = jnp.asarray(frames)
    out = {"j_fwd": np.asarray(j_forward(jp, jcfg, jnp.asarray(toks),
                                         frames=frames,
                                         use_kernel=True)[0]),
           "t_fwd": T.forward(tp, tcfg, tt, frames=tframes),
           "t_last": T.forward(tp, tcfg, tt, frames=tframes,
                               last_only=True)}
    step = _jit_decode()
    js = j_init_state(jcfg, B, DECODE_S)
    ts = T.init_decode_state(tcfg, B, DECODE_S, "cpu")
    out["j_dec"], out["t_dec"] = [], []
    for t in range(DECODE_S):
        lg, js = step(jp, jcfg, jnp.asarray(toks[:, t]),
                      jnp.asarray(t, jnp.int32), js, cross)
        out["j_dec"].append(np.asarray(lg))
        lg_t, ts = T.decode_step(tp, tcfg, tt[:, t], t, ts, cross=tcross)
        out["t_dec"].append(lg_t)
    out["j_state"] = _np(js)
    out["t_state"] = convert.decode_state_to_numpy(ts, tcfg)
    return out


# -- configs: copies of the reference's --------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_equal_reference(arch):
    for smoke in (False, True):
        j = jconfigs.get_config(arch, smoke=smoke)
        t = tconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.param_count(), t.active_param_count(), t.padded_vocab,
                t.head_dim_, t.all_blocks, t.sub_quadratic) == \
            (j.param_count(), j.active_param_count(), j.padded_vocab,
             j.head_dim_, j.all_blocks, j.sub_quadratic)
        assert len(T.layer_kinds(t)) == t.n_layers


def test_config_registry_equals_reference():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert [dataclasses.astuple(s) for s in tconfigs.SHAPES] == \
        [dataclasses.astuple(s) for s in jconfigs.SHAPES]
    for name in jconfigs.ARCHS:
        cfg = tconfigs.get_config(name)
        for shape in tconfigs.SHAPES:
            assert tconfigs.cell_applicable(cfg, shape) == \
                jconfigs.cell_applicable(jconfigs.get_config(name),
                                         jconfigs.SHAPE_BY_NAME[shape.name])
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")


# -- blocks ------------------------------------------------------------------

def _block_setup(arch, key=3):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    x = np.random.default_rng(key).standard_normal(
        (B, 8, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, x, torch.as_tensor(x)


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-9b",
                                  "chameleon-34b", "recurrentgemma-9b"])
def test_attention_block_equals_reference(arch):
    jcfg, tcfg, x, tx = _block_setup(arch)
    p = jL.attn_params(jax.random.key(1), jcfg, jnp.float32)
    p = {k: v + 0.1 if k.endswith("norm") or k == "ln" else v
         for k, v in p.items()}                  # nonzero norm gains
    pos = np.arange(8)
    for window in (None, jcfg.window or 3):
        want, _ = jL.attention_block(p, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), window=window,
                                     use_kernel=True)
        got, _ = tL.attention_block(_t(p), tcfg, tx, torch.as_tensor(pos),
                                    window=window)
        _close(got, want)


@pytest.mark.parametrize("index", [0, 5, 13])
def test_attention_block_with_cache_equals_reference(index):
    """One token written into a KV cache at ``index`` (13 past the last
    slot of 12: the start clamps, as ``dynamic_update_slice`` clamps)."""
    jcfg, tcfg, x, tx = _block_setup("granite-34b")
    p = jL.attn_params(jax.random.key(2), jcfg, jnp.float32)
    rng = np.random.default_rng(index)
    shape = (B, jcfg.n_kv_heads, 12, jcfg.head_dim_)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    pos = np.full((1,), index)
    want, (wk, wv) = jL.attention_block(
        p, jcfg, jnp.asarray(x[:, :1]), jnp.asarray(pos), window=None,
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_index=jnp.asarray(index, jnp.int32))
    tk, tv = torch.as_tensor(ck), torch.as_tensor(cv)
    got, (gk, gv) = tL.attention_block(
        _t(p), tcfg, tx[:, :1], torch.as_tensor(pos), window=None,
        kv_cache=(tk, tv), cache_index=index)
    assert gk is tk and gv is tv             # written in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("arch,mlp", [("smollm-360m", "swiglu"),
                                      ("nemotron-4-340b", "relu2"),
                                      ("whisper-small", "gelu")])
def test_mlp_block_equals_reference(arch, mlp):
    jcfg, tcfg, x, tx = _block_setup(arch)
    assert jcfg.mlp == mlp
    p = jL.mlp_params(jax.random.key(4), jcfg, jnp.float32)
    p["ln"] = p["ln"] + 0.3
    _close(tL.mlp_block(_t(p), tcfg, tx),
           jL.mlp_block(p, jcfg, jnp.asarray(x)))


def test_rglru_block_prefill_and_decode_equal_reference():
    jcfg, tcfg, x, tx = _block_setup("recurrentgemma-9b")
    p = jrg.rglru_params(jax.random.key(5), jcfg, jnp.float32)
    want, none = jrg.rglru_block(p, jcfg, jnp.asarray(x), use_kernel=True)
    got, tnone = trg.rglru_block(_t(p), tcfg, tx)
    assert none is None and tnone is None
    _close(got, want)
    rng = np.random.default_rng(6)
    st = {"h": rng.standard_normal((B, jcfg.d_model)).astype(np.float32),
          "conv": rng.standard_normal((B, 3, jcfg.d_model)
                                      ).astype(np.float32)}
    want, wst = jrg.rglru_block(p, jcfg, jnp.asarray(x[:, :1]),
                                state=jax.tree_util.tree_map(jnp.asarray, st))
    got, gst = trg.rglru_block(_t(p), tcfg, tx[:, :1], state=_t(st))
    _close(got, want)
    for k in ("h", "conv"):
        _close(gst[k], wst[k])


@pytest.mark.parametrize("arch", ["gemma2-9b", "smollm-360m", "granite-moe-1b-a400m"])
def test_logits_equal_reference(arch):
    """gemma2: final softcap, tied; smollm: tied; granite-moe: vocab 49155
    padded to 49408, its pad columns -1e30, and an untied head."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               vocab=300 if arch != "gemma2-9b" else 256,
                               tie_embeddings=arch != "granite-moe-1b-a400m",
                               moe=None)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               vocab=jcfg.vocab,
                               tie_embeddings=jcfg.tie_embeddings, moe=None)
    p = jL.embed_params(jax.random.key(8), jcfg, jnp.float32)
    x = np.random.default_rng(8).standard_normal(
        (B, 4, jcfg.d_model)).astype(np.float32) * 3
    want = jL.logits(p, jcfg, jnp.asarray(x))
    got = tL.logits(_t(p), tcfg, torch.as_tensor(x))
    assert got.shape == (B, 4, jcfg.padded_vocab)
    _close(got, want)
    if jcfg.padded_vocab != jcfg.vocab:
        assert bool((got[..., jcfg.vocab:] == -1e30).all())


# -- the slice: six smoke configs --------------------------------------------

@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_forward_equals_reference(arch):
    out = _run(arch)
    assert out["t_fwd"].shape == out["j_fwd"].shape
    assert out["t_fwd"].dtype == torch.float32
    _close(out["t_fwd"], out["j_fwd"])
    _close(out["t_last"], out["j_fwd"][:, -1:])


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_decode_steps_equal_reference(arch):
    out = _run(arch)
    for t, (got, want) in enumerate(zip(out["t_dec"], out["j_dec"])):
        assert got.shape == want.shape, t
        _close(got, want)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_final_decode_state_equals_reference(arch):
    out = _run(arch)
    want = jax.tree_util.tree_flatten_with_path(out["j_state"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(out["t_state"])[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        _close(got[path], leaf)


def test_ring_buffer_window_attention_equals_reference():
    """gemma2's local layers decode past their window of 16 (S = 24): the
    ring buffer against the reference's, and against the port's prefill."""
    jcfg = jconfigs.get_config("gemma2-9b", smoke=True)
    tcfg = tconfigs.get_config("gemma2-9b", smoke=True)
    assert tcfg.window == 16
    jp = j_init_params(jax.random.key(3), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (1, 24))
    tt = torch.as_tensor(toks)
    step = _jit_decode()
    js = j_init_state(jcfg, 1, 24)
    ts = T.init_decode_state(tcfg, 1, 24, "cpu")
    for t in range(24):
        want, js = step(jp, jcfg, jnp.asarray(toks[:, t], jnp.int32),
                        jnp.asarray(t, jnp.int32), js)
        got, ts = T.decode_step(tp, tcfg, tt[:, t], t, ts)
        _close(got, want)
    _close(got, T.forward(tp, tcfg, tt)[:, -1])


# -- parameters, states, refusals --------------------------------------------

def _flat(tree, path=""):
    """{path: tensor} over the port's nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}.{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m", "rwkv6-3b",
                                  "whisper-small"])
def test_init_params_layout_and_scales(arch):
    """The port's own draw has the converted tree's layout, dtypes and the
    reference's scales."""
    cfg = tconfigs.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    got = T.init_params(cfg, generator=gen, device="cpu")
    ref = convert.model_params_to_torch(
        _np(j_init_params(jax.random.key(0), jconfigs.get_config(
            arch, smoke=True))), cfg, "cpu")
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    for k in g:
        assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype, k
        if k.endswith(("ln", "norm")):
            assert bool((g[k] == 0).all()), k
        elif k.endswith("lam"):
            assert bool((g[k] == 2.0).all()), k
        elif g[k].dim() == 1:                 # RWKV's constant vectors
            assert torch.equal(g[k], r[k]), k
        elif g[k].numel() > 2000:
            # [fan_in, out] or [E, fan_in, out], except the embedding
            # table [vocab, d].
            fan_in = g[k].shape[-1 if k == ".embed.tok" else -2]
            assert abs(float(g[k].std()) * fan_in ** 0.5 - 1) < 0.1, k
    frames = (torch.zeros((1, cfg.encoder.n_frames, cfg.d_model))
              if cfg.encoder is not None else None)
    assert T.forward(got, cfg, torch.zeros((1, 4), dtype=torch.long),
                     frames=frames).isfinite().all()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_decode_state_round_trip(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    js = _np(j_init_state(jconfigs.get_config(arch, smoke=True), B, 8))
    rng = np.random.default_rng(9)
    js = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), js)
    back = convert.decode_state_to_numpy(
        convert.decode_state_to_torch(js, cfg, "cpu"), cfg)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(js)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["encdec_without_frames"])
def test_unported_paths_raise(what):
    """Every config runs; what is refused: an encoder-decoder forward
    without frames (the reference asserts)."""
    cfg = tconfigs.get_config("whisper-small", smoke=True)
    p = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    with pytest.raises(ValueError, match="frames"):
        T.forward(p, cfg, torch.zeros((1, 2), dtype=torch.long))


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_activation_and_ep_specs_leave_plain_tensors(arch):
    """The mesh builders' activation and expert layouts change nothing on
    plain tensors: forward and decode equal those with no layout set (the
    reference's constraints with no mesh context)."""
    import types

    from repro_torch.launch.sharding import NamedSharding, P
    cfg = tconfigs.get_config(arch, smoke=True)
    p = T.init_params(cfg, generator=torch.Generator().manual_seed(3),
                      device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(4))
    want = T.forward(p, cfg, toks)
    st = T.init_decode_state(cfg, 2, 8, "cpu")
    want_d, _ = T.decode_step(p, cfg, toks[:, 0], 0, st)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    T.set_activation_spec(NamedSharding(mesh, P("data", None, None)))
    tmoe.set_ep_spec(NamedSharding(mesh, P("model", None, None)))
    try:
        got = T.forward(p, cfg, toks)
        got_d, _ = T.decode_step(p, cfg, toks[:, 0], 0,
                                 T.init_decode_state(cfg, 2, 8, "cpu"))
    finally:
        T.set_activation_spec(None)
        tmoe.set_ep_spec(None)
    assert torch.equal(got, want) and torch.equal(got_d, want_d)


def test_quantized_mm_equals_reference():
    """``mm`` of a quantized ``{"q", "s"}`` weight (the reference's codes
    and scales) against ``repro.models.layers.mm``."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, 8, 64)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(rng.standard_normal((64, 96)),
                                        jnp.float32))
    tw = {k: torch.as_tensor(np.array(v)) for k, v in jw.items()}
    _close(tL.mm(torch.as_tensor(x), tw), jL.mm(jnp.asarray(x), jw))


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "rwkv6-3b"])
def test_quantized_forward_equals_reference(arch):
    """A smoke forward over int8 weights: the reference's quantized
    parameters carried across, against ``repro.models.forward``."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = jq.quantize_params(j_init_params(jax.random.key(8), jcfg),
                            min_size=64)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    layer = tp["layers"][0]
    assert isinstance(layer["ffn"]["w1"] if "ffn" in layer
                      else layer["mixer"]["w_r"], dict)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (B, S)
                                             ).astype(np.int32)
    _close(T.forward(tp, tcfg, torch.as_tensor(toks).long()),
           j_forward(jp, jcfg, jnp.asarray(toks), use_kernel=True)[0])


def test_cpu_forward_launches_no_kernel():
    cfg = tconfigs.get_config("recurrentgemma-9b", smoke=True)
    p = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                      device="cpu")
    before = dict(K.launches)
    T.forward(p, cfg, torch.zeros((1, 16), dtype=torch.long))
    assert K.launches == before


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("smollm-360m", smoke=True)
    for call in (lambda: T.init_params(cfg, generator=torch.Generator()),
                 lambda: T.init_decode_state(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
