"""Shared model layers: RMSNorm, RoPE, GQA attention (full/local/softcap),
MLP variants, embeddings.

The port of ``repro.models.layers``: plain functions over explicit
parameter dicts (the reference's keys), in the reference's cast order —
norms and activations in fp32, cast back to the block's dtype; the
logits multiplied in the model's dtype and cast to fp32.  Attention goes
through ``kernels.ops.attention``, which launches the CUDA kernel on the
shapes where the reference reaches its Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


class TP:
    """No tensor parallelism: a group of one, every op the identity.

    The model functions take ``tp`` (this, or None for it) and compute on
    the shards it names: ``launch.sharding.TPContext`` is the mesh's,
    whose ``size`` ranks of the ``model`` axis each hold a slice of the
    heads, FFN columns, channels, experts and vocab (the reference's
    sharding rules), and whose ``layer`` gathers a layer's FSDP shards.
    With this class (or a mesh of one device) every function runs the
    unsharded code.  The ops are ``launch.collectives``': ``copy``
    (identity forward, all-reduce backward), ``reduce`` (all-reduce
    forward), ``gather_cols`` (slice backward), ``gather_rs`` (reduce-
    scatter backward), ``pmax``."""

    size = 1
    rank = 0

    def copy(self, x):
        return x

    def reduce(self, x):
        return x

    def gather_cols(self, x):
        return x

    def gather_rs(self, x, dim: int = -1):
        return x

    def pmax(self, x):
        return x.detach()

    def layer(self, p):
        return p

    def cols(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (all of it on a group
        of one)."""
        if self.size == 1:
            return t
        c = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * c, c)


NO_TP = TP()


def as_tp(tp) -> TP:
    return NO_TP if tp is None else tp


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """Normal times ``fan_in ** -0.5``, drawn in fp32 from ``gen`` (on
    ``device``) and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * fan_in ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# matmul entry point
# ---------------------------------------------------------------------------


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a tensor or a quantized ``{"q": int8, "s":
    fp32}`` weight (``serve.quantize``), dequantized in x's dtype: the
    int8 codes cast before the product, the scale applied after it."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum`` with a tensor or a quantized ``{"q": int8 [..., in,
    out], "s": fp32 [..., out]}`` weight.  The scale multiplies the output
    over its second-to-last axis too (``s[..., None, :]``): an expert
    weight ``[E, d, f]`` has the scale ``[E, f]`` and the product ``[E, C,
    f]``.  (The reference multiplies by ``s`` unexpanded, which does not
    broadcast against ``[E, C, f]``: its int8 MoE raises.)"""
    if isinstance(w, dict):
        return torch.einsum(spec, x, w["q"].to(x.dtype)) * \
            w["s"].to(x.dtype)[..., None, :]
    return torch.einsum(spec, x, w)


# ---------------------------------------------------------------------------
# normalization / rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with scale ``1 + gamma``, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, H, S, D] with D even; positions: [B, S] or [S].  The two
    halves rotate (``cat``), not interleaved pairs; frequencies
    ``theta ** (-arange(half) / half)``, angles in fp32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs      # B, 1, S, half
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA / MQA / local / softcap / qk-norm)
# ---------------------------------------------------------------------------


def attn_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(gen, d, (d, h * hd), dtype, device),
        "wk": dense_init(gen, d, (d, hkv * hd), dtype, device),
        "wv": dense_init(gen, d, (d, hkv * hd), dtype, device),
        "wo": dense_init(gen, h * hd, (h * hd, d), dtype, device),
        "ln": torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, n, S, hd]."""
    B, S, _ = t.shape
    return t.reshape(B, S, n, hd).transpose(1, 2)


def heads_local(cfg: ModelConfig, tp) -> Tuple[bool, bool]:
    """(whether the query heads, whether the kv heads divide over the
    ``model`` ranks of ``tp``): a rank computes its own heads where they
    do; where they do not, the columns are gathered."""
    n = as_tp(tp).size
    return cfg.n_heads % n == 0, cfg.n_kv_heads % n == 0


def project_kv(p: Params, cfg: ModelConfig, xf: torch.Tensor, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v [B, Hkv', S, hd] of ``xf`` (the normed input, through
    ``tp.copy``): this rank's kv heads where they divide over ``model``,
    else every kv head, gathered — for this rank's query heads
    (``gather_rs``: each rank's cotangent is summed back) or, when the
    query heads do not divide either, for the work every rank repeats
    (``gather_cols``)."""
    tp = as_tp(tp)
    q_loc, kv_loc = heads_local(cfg, tp)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    out = []
    for w in (p["wk"], p["wv"]):
        t = mm(xf, w)
        if kv_loc:
            out.append(split_heads(t, hkv // tp.size, hd))
        else:
            t = tp.gather_rs(t) if q_loc else tp.gather_cols(t)
            out.append(split_heads(t, hkv, hd))
    return out[0], out[1]


def local_kv_heads(k: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The kv heads this rank's query heads use, of every kv head ``k``
    [B, Hkv, S, hd] (the query heads divide over ``model``, the kv heads
    do not): a slice where each rank's query heads meet whole groups or
    lie in one, else one kv head per query head."""
    h, hkv, n = cfg.n_heads, cfg.n_kv_heads, tp.size
    hq, rep = h // n, h // hkv
    q0 = tp.rank * hq
    if hq % rep == 0 or rep % hq == 0:
        return k[:, q0 // rep:q0 // rep + max(1, hq // rep)]
    idx = torch.arange(q0, q0 + hq, device=k.device) // rep
    return k.index_select(1, idx)


def attention_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, window: Optional[int],
                    kv_cache: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    cache_index: Optional[int] = None, causal: bool = True,
                    cross_kv: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    use_kernel: bool = True, tp=None
                    ) -> Tuple[torch.Tensor,
                               Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Pre-norm attention with residual: (y, kv_cache).

    ``kv_cache``: (k, v) [B, Hkv, S_max, hd], written IN PLACE at
    ``cache_index`` (clamped to ``[0, S_max - S]``, as
    ``jax.lax.dynamic_update_slice`` clamps) and attended over its valid
    prefix (``kv_length = cache_index + S``) — the decode path.

    ``cross_kv``: the encoder's (k, v) [B, Hkv, T, hd] (whisper's
    decoder): no k/v projection, no rotary on q, no cache, not causal;
    ``q_norm`` still applies.  ``use_kernel=False`` takes the plain
    attention as the reference's default does (its ``decode_step``).

    ``tp`` (a ``TP``): column-parallel q/k/v and a row-parallel ``wo``
    summed over ``model``.  Query heads that do not divide over the
    ranks are gathered before the heads split, every rank attends all of
    them, and the output's columns are sliced back before ``wo`` (the
    activation gather GSPMD inserts; the weights stay sharded).  The kv
    heads likewise (``project_kv``); ``cross_kv`` and ``kv_cache`` come
    in ``project_kv``'s layout (a cache: this rank's kv heads)."""
    tp = as_tp(tp)
    B, S, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q_loc, kv_loc = heads_local(cfg, tp)
    kv_length = None
    xn = tp.copy(rms_norm(x, p["ln"]))
    q = mm(xn, p["wq"])
    q = split_heads(q, h // tp.size, hd) if q_loc else \
        split_heads(tp.gather_cols(q), h, hd)
    # a norm's scale used on this rank's heads only: its cotangent summed.
    norm_p = tp.copy if q_loc else (lambda t: t)
    if cross_kv is not None:
        k, v = cross_kv
        kv_cache, causal = None, False
    else:
        k, v = project_kv(p, cfg, xn, tp)
        if cfg.qk_norm:
            k = rms_norm(k, norm_p(p["k_norm"]))
        k = rope(k, positions, cfg.rope_theta)
        if kv_cache is not None:
            ck, cv = kv_cache
            start = min(max(int(cache_index), 0), ck.shape[2] - S)
            ck[:, :, start:start + S] = k.to(ck.dtype)
            cv[:, :, start:start + S] = v.to(cv.dtype)
            k, v = ck, cv
            kv_length = int(cache_index) + S
    if q_loc and not kv_loc:
        k, v = local_kv_heads(k, cfg, tp), local_kv_heads(v, cfg, tp)
    if cfg.qk_norm:
        q = rms_norm(q, norm_p(p["q_norm"]))
    if cross_kv is None:
        q = rope(q, positions, cfg.rope_theta)

    o = kops.attention(q, k, v, causal=causal, window=window,
                       softcap=cfg.attn_softcap, kv_length=kv_length,
                       use_kernel=use_kernel)
    o = o.transpose(1, 2).reshape(B, S, q.shape[1] * hd)
    if not q_loc:
        o = tp.cols(tp.copy(o))
    return x + tp.reduce(mm(o, p["wo"])), kv_cache


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"ln": torch.zeros((d,), dtype=dtype, device=device),
         "w1": dense_init(gen, d, (d, f), dtype, device),
         "w2": dense_init(gen, f, (f, d), dtype, device)}
    if cfg.mlp == "swiglu":
        p["w3"] = dense_init(gen, d, (d, f), dtype, device)
    return p


def mlp_block(p: Params, cfg: ModelConfig, x: torch.Tensor, tp=None
              ) -> torch.Tensor:
    """Pre-norm MLP with residual: swiglu (silu in fp32), relu2
    (nemotron-4's squared ReLU) or gelu (the tanh form, in fp32, as
    ``jax.nn.gelu``'s default).  ``tp``: column-parallel ``w1``/``w3``,
    row-parallel ``w2``, summed over ``model``."""
    tp = as_tp(tp)
    xn = tp.copy(rms_norm(x, p["ln"]))
    if cfg.mlp == "swiglu":
        hmid = F.silu(mm(xn, p["w1"]).float()).to(x.dtype) * mm(xn, p["w3"])
    elif cfg.mlp == "relu2":
        r = torch.relu(mm(xn, p["w1"]))
        hmid = r * r
    else:
        hmid = F.gelu(mm(xn, p["w1"]).float(),
                      approximate="tanh").to(x.dtype)
    return x + tp.reduce(mm(hmid, p["w2"]))


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def embed_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    vp, d = cfg.padded_vocab, cfg.d_model
    p = {"tok": dense_init(gen, d, (vp, d), dtype, device),
         "final_ln": torch.zeros((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, d, (d, vp), dtype, device)
    return p


def embed(p: Params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The token rows of ``tok``.  ``tp``: this rank holds a block of the
    vocab's rows; a token outside it looks up zeros, and the rows are
    summed over ``model`` (each token's row from its one owner)."""
    tp = as_tp(tp)
    if tp.size == 1:
        return p["tok"][tokens]
    n = p["tok"].shape[0]
    lo = tp.rank * n
    mine = (tokens >= lo) & (tokens < lo + n)
    rows = p["tok"][torch.where(mine, tokens - lo, 0)]
    return tp.reduce(torch.where(mine[..., None], rows, 0))


def logits(p: Params, cfg: ModelConfig, x: torch.Tensor, tp=None
           ) -> torch.Tensor:
    """fp32 logits over the PADDED vocab; the pad columns are -1e30 and
    the final softcap applies where the config has one.  ``tp``: this
    rank's block of the vocab's columns (``tp.rank`` times its width on),
    the pad columns on the rank that holds them."""
    tp = as_tp(tp)
    xn = tp.copy(rms_norm(x, p["final_ln"]))
    out = xn @ p["tok"].T if cfg.tie_embeddings else mm(xn, p["head"])
    out = out.float()
    if cfg.logit_softcap is not None:
        out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
    lo = tp.rank * out.shape[-1]
    if cfg.padded_vocab != cfg.vocab and cfg.vocab - lo < out.shape[-1]:
        out[..., max(cfg.vocab - lo, 0):] = -1e30
    return out
