"""Model assembly: embeddings, a stack of blocks, the LM head, for every
family of the configs: dense llama-style decoders, gemma2, chameleon,
recurrentgemma, MoE (granite-moe, qwen3-moe), RWKV6 and the whisper
encoder-decoder.

The port of ``repro.models.transformer``.  Where the reference stacks
each slot's weights over superlayers and scans them, the port keeps one
parameter dict per layer in layer order and loops over them — the same
layers in the same order; the encoder's layers and the per-superlayer
cross-attention likewise.  ``cfg.remat`` recomputes each superlayer in
the backward pass.  ``set_activation_spec`` names the activations'
layout at every superlayer boundary: a DTensor is redistributed to it,
a plain tensor passes unchanged (as the reference's constraint with no
mesh context).  ``moe_group``: the process group whose ranks hold the
other rows of a batch sharded over data parallelism; a MoE layer then
routes the tokens of every rank as one batch (``moe.moe_block_global``),
as the reference's sharded step does.  ``tp`` (a ``layers.TP``; the
mesh builders pass ``launch.sharding.TPContext``): the parameters are
this rank's shards; each layer gathers its FSDP shards when it runs
(inside the remat region, so the backward pass gathers again rather
than keeping them), computes its ``model`` shard of the heads, columns,
channels and experts, and sums over ``model`` after each row-parallel
product; the head gives this rank's block of the vocab, and the loss is
a vocab-parallel cross entropy.  Without ``tp``, or on a group of one,
every function computes what it computes unsharded.

Entry points:
  ``init_params``       — parameters drawn from a ``torch.Generator``.
  ``forward``           — full-sequence logits (prefill).
  ``loss_fn``           — the training loss (token NLL with a chunked
                          head, plus the MoE aux loss).
  ``decode_step``       — one token over KV caches / recurrent states.
and, for the encoder-decoder, ``encode`` and ``cross_kv`` (the encoder's
K/V for each superlayer, computed once and handed to ``decode_step``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..kernels.ref import NEG_INF
from . import layers as L
from .config import ModelConfig
from .moe import moe_block, moe_block_global, moe_params
from .rglru import rglru_block, rglru_init_state, rglru_params
from .rwkv6 import rwkv_block, rwkv_init_state, rwkv_params

Params = Dict[str, Any]
CrossKV = List[Tuple[torch.Tensor, torch.Tensor]]

_MIXERS = {"ga": L.attn_params, "la": L.attn_params, "rg": rglru_params,
           "rwkv": rwkv_params}

#: the activations' layout at every superlayer boundary (a
#: ``launch.sharding.NamedSharding``; None: no constraint), set by the
#: mesh builders.
_ACT_SPEC: Any = None


def set_activation_spec(spec) -> None:
    global _ACT_SPEC
    _ACT_SPEC = spec


def _constrain(x):
    """``x`` in the activation layout: a DTensor on the spec's mesh is
    redistributed; anything else passes unchanged."""
    if _ACT_SPEC is None or not isinstance(x, DTensor) or \
            x.device_mesh is not _ACT_SPEC.mesh:
        return x
    from ..launch.sharding import placements
    mesh = _ACT_SPEC.mesh
    return x.redistribute(mesh, placements(mesh, _ACT_SPEC.spec, x.shape))


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in order: the superlayer pattern
    repeated, then the tail."""
    return list(cfg.block_pattern) * cfg.n_superlayers + \
        list(cfg.tail_pattern)


def cross_after(cfg: ModelConfig) -> Dict[int, int]:
    """{layer index: superlayer} of the layers that end a superlayer — an
    encoder-decoder runs its cross-attention after each of them; empty for
    a decoder-only config."""
    if cfg.encoder is None:
        return {}
    P = len(cfg.block_pattern)
    return {(li + 1) * P - 1: li for li in range(cfg.n_superlayers)}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Params:
    """{"embed": {...}, "layers": [{"mixer": {...}, "ffn": {...}}, ...]}
    in the model's dtype on ``device``, drawn from ``generator`` (which
    lies on that device) with the reference's scales: weights normal times
    fan_in^-0.5, norms 0, the RG-LRU's Lambda 2.0, RWKV's mixes 0.5 and
    base decay -1.  An ``rwkv`` layer has no ``ffn`` (its block holds its
    channel mix); a MoE config's ``ffn`` is the experts' (``moe.py``).
    An encoder-decoder adds ``"encoder": {"layers": [{"attn", "ffn"},
    ...], "final_ln"}`` and ``"cross"``, one attention dict a
    superlayer."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    params: Params = {"embed": L.embed_params(generator, cfg, dtype, dev)}
    layers = []
    for kind in layer_kinds(cfg):
        if kind not in _MIXERS:
            raise ValueError(kind)
        layer = {"mixer": _MIXERS[kind](generator, cfg, dtype, dev)}
        if kind != "rwkv":
            layer["ffn"] = (moe_params if cfg.moe is not None
                            else L.mlp_params)(generator, cfg, dtype, dev)
        layers.append(layer)
    params["layers"] = layers
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [{"attn": L.attn_params(generator, cfg, dtype, dev),
                        "ffn": L.mlp_params(generator, cfg, dtype, dev)}
                       for _ in range(cfg.encoder.n_layers)],
            "final_ln": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=dev)}
        params["cross"] = [L.attn_params(generator, cfg, dtype, dev)
                           for _ in range(cfg.n_superlayers)]
    return params


# ---------------------------------------------------------------------------
# encoder (whisper tower; the frontend is a stub: inputs are frame
# embeddings)
# ---------------------------------------------------------------------------


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           use_kernel: bool = True, tp=None) -> torch.Tensor:
    """frames [B, T, d] -> encoder states [B, T, d]: non-causal attention
    and MLP layers, then the final norm."""
    tp = L.as_tp(tp)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dtype_of(cfg))
    for p in params["encoder"]["layers"]:
        p = tp.layer(p)
        x, _ = L.attention_block(p["attn"], cfg, x, pos, window=None,
                                 causal=False, use_kernel=use_kernel, tp=tp)
        x = L.mlp_block(p["ffn"], cfg, x, tp)
    return L.rms_norm(x, params["encoder"]["final_ln"])


def cross_kv(params: Params, cfg: ModelConfig, enc: torch.Tensor,
             tp=None) -> CrossKV:
    """The encoder's K/V for each superlayer's cross-attention: one (k, v)
    [B, Hkv, T, hd] a superlayer (no norm, no rotary); with ``tp``, in
    ``layers.project_kv``'s layout."""
    tp = L.as_tp(tp)
    xf = tp.copy(enc)
    return [L.project_kv(tp.layer({"wk": p["wk"], "wv": p["wv"]}), cfg, xf,
                         tp) for p in params["cross"]]


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, moe_group=None,
         tp=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's FFN: (x, the MoE aux loss or None)."""
    if cfg.moe is not None:
        if moe_group is not None:
            return moe_block_global(p["ffn"], cfg, x, moe_group, tp)
        return moe_block(p["ffn"], cfg, x, tp)
    return L.mlp_block(p["ffn"], cfg, x, tp), None


def _block(kind: str, p: Params, cfg: ModelConfig, x: torch.Tensor,
           pos: torch.Tensor, use_kernel: bool, moe_group=None, tp=None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the stack, its FSDP shards gathered: its mixer, then
    its FFN (an ``rwkv`` layer has none): (x, the MoE aux loss or
    None)."""
    p = L.as_tp(tp).layer(p)
    if kind == "rg":
        x, _ = rglru_block(p["mixer"], cfg, x, use_kernel=use_kernel, tp=tp)
    elif kind == "rwkv":
        x, _ = rwkv_block(p["mixer"], cfg, x, tp=tp)
    else:
        x, _ = L.attention_block(
            p["mixer"], cfg, x, pos,
            window=cfg.window if kind == "la" else None,
            use_kernel=use_kernel, tp=tp)
    if kind == "rwkv":
        return x, None
    return _ffn(p, cfg, x, moe_group, tp)


#: the ops whose outputs ``remat_policy="dots"`` keeps for the backward
#: pass (the reference's ``dots_saveable``: the matrix products).
DOTS = ("mm", "bmm")


def _remat(fn, *args, policy: str):
    """``fn(*args)`` recomputed in the backward pass, as the reference's
    ``jax.checkpoint`` of a superlayer: nothing saved (``"full"``), or
    the outputs of the matrix products saved (``"dots"``)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if policy == "dots":
        ops = [getattr(torch.ops.aten, n).default for n in DOTS]
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(ops)
    elif policy != "full":
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def forward_body(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 frames: Optional[torch.Tensor] = None,
                 use_kernel: bool = True, moe_group=None, tp=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, d] before the head,
    the summed MoE aux loss, fp32 scalar).

    ``use_kernel=False`` takes the plain attention and RG-LRU scan, which
    autograd differentiates (the kernels have no backward and refuse an
    input that requires grad).  With ``cfg.remat`` each superlayer (one
    period of ``block_pattern``, with its cross-attention) is recomputed
    in the backward pass, as the reference's ``jax.checkpoint`` of its
    scan body; the tail layers are not, as in the reference."""
    tp = L.as_tp(tp)
    cross = None
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"encoder frames")
        cross = cross_kv(params, cfg, encode(params, cfg, frames,
                                             use_kernel, tp), tp)
    x = L.embed(params["embed"], tokens, tp).to(dtype_of(cfg))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kinds, P = layer_kinds(cfg), len(cfg.block_pattern)

    def superlayer(li: int, x: torch.Tensor, aux: torch.Tensor):
        x = _constrain(x)
        for j in range(li * P, (li + 1) * P):
            x, a = _block(kinds[j], params["layers"][j], cfg, x, pos,
                          use_kernel, moe_group, tp)
            if a is not None:
                aux = aux + a
        if cross is not None:
            x, _ = L.attention_block(tp.layer(params["cross"][li]), cfg, x,
                                     pos, window=None, cross_kv=cross[li],
                                     use_kernel=use_kernel, tp=tp)
        return x, aux

    for li in range(cfg.n_superlayers):
        if cfg.remat and torch.is_grad_enabled():
            x, aux = _remat(superlayer, li, x, aux, policy=cfg.remat_policy)
        else:
            x, aux = superlayer(li, x, aux)
    for j in range(cfg.n_superlayers * P, len(kinds)):
        x, a = _block(kinds[j], params["layers"][j], cfg, x, pos,
                      use_kernel, moe_group, tp)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            last_only: bool = False, use_kernel: bool = True
            ) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V_padded] fp32, on the parameters'
    device.  ``frames`` [B, T, d]: the encoder's input, which an
    encoder-decoder needs.  ``last_only=True`` (serving prefill): the LM
    head for the final position only, [B, 1, V_padded].  The kernels
    run where their shapes tile unless ``use_kernel=False``."""
    x, _ = forward_body(params, cfg, tokens, frames=frames,
                        use_kernel=use_kernel)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: Optional[torch.Tensor] = None,
                   use_kernel: bool = False, moe_group=None, tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward up to the final hidden states (no LM head), so that the
    loss can chunk the head: ``forward_body`` with the reference's
    signature and default (the plain attention and scan)."""
    return forward_body(params, cfg, tokens, frames=frames,
                        use_kernel=use_kernel, moe_group=moe_group, tp=tp)


def _vocab_parallel_nll(lg: torch.Tensor, targets: torch.Tensor, tp
                        ) -> torch.Tensor:
    """Each token's NLL from this rank's block of the vocab's logits [...,
    n] (global columns ``tp.rank * n`` on): the max, the sum of
    exponentials and the target's logit combined over ``model``."""
    m = tp.pmax(lg.amax(dim=-1))
    lse = m + torch.log(tp.reduce(torch.exp(lg - m[..., None]).sum(dim=-1)))
    t = targets.long() - tp.rank * lg.shape[-1]
    mine = (t >= 0) & (t < lg.shape[-1])
    tgt = lg.gather(-1, torch.where(mine, t, 0)[..., None])[..., 0]
    return lse - tp.reduce(torch.where(mine, tgt, 0.0))


def _nll_sum(embed_p: Params, cfg: ModelConfig, xc: torch.Tensor,
             tc: torch.Tensor, tp=None) -> torch.Tensor:
    """The summed token NLL of one chunk: the head's fp32 logits [B, c,
    V_padded], their logsumexp, less the target logit taken by a one-hot
    product (the pad columns' -1e30 times 0 is -0, finite).  ``tp``:
    ``_vocab_parallel_nll`` over this rank's block of the vocab."""
    lg = L.logits(embed_p, cfg, xc, tp)
    if L.as_tp(tp).size > 1:
        return _vocab_parallel_nll(lg, tc, tp).sum()
    lse = torch.logsumexp(lg, dim=-1)
    onehot = torch.zeros_like(lg).scatter_(-1, tc[..., None].long(), 1.0)
    tgt = (lg * onehot).sum(dim=-1)
    return (lse - tgt).sum()


def _chunk_nll(embed_p: Params, cfg: ModelConfig, x: torch.Tensor,
               targets: torch.Tensor, chunk: int = 512, tp=None
               ) -> torch.Tensor:
    """Mean token NLL without materialising the [B, S, V] logits: the
    head runs over sequence chunks of ``chunk`` tokens, each recomputed in
    the backward pass, so autograd keeps only the running sum.  When
    ``chunk`` does not divide S, one pass over the whole sequence, as in
    the reference."""
    from torch.utils.checkpoint import checkpoint
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        lg = L.logits(embed_p, cfg, x, tp)
        if L.as_tp(tp).size > 1:
            return _vocab_parallel_nll(lg, targets, tp).mean()
        lp = torch.log_softmax(lg, dim=-1)
        return -lp.gather(-1, targets[..., None].long())[..., 0].mean()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xc, tc = x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_nll_sum, embed_p, cfg, xc, tc, tp,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _nll_sum(embed_p, cfg, xc, tc, tp)
        total = total + part
    return total / total.new_full((), B * S)


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            targets: torch.Tensor, frames: Optional[torch.Tensor] = None,
            use_kernel: bool = False, moe_group=None, tp=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(token NLL + MoE aux loss, {"nll", "aux"}), fp32 scalars, over
    tokens and targets [B, S].  The default ``use_kernel=False`` is the
    reference's: its training path reaches no kernel."""
    x, aux = forward_hidden(params, cfg, tokens, frames, use_kernel,
                            moe_group, tp)
    nll = _chunk_nll(params["embed"], cfg, x, targets, tp=tp)
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# decode (single token over caches / recurrent states)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> List[Dict[str, torch.Tensor]]:
    """One state per layer: ``ga`` a KV cache {"k", "v"} [B, Hkv, max_seq,
    hd]; ``la`` a ring buffer of ``min(window, max_seq)`` slots; ``rg``
    {"h": [B, d] fp32, "conv": [B, 3, d]}; ``rwkv`` {"s": [B, H, hd, hd]
    fp32, "last", "cm_last": [B, d]}."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    state = []
    for kind in layer_kinds(cfg):
        if kind == "rg":
            state.append(rglru_init_state(cfg, batch, dev))
            continue
        if kind == "rwkv":
            state.append(rwkv_init_state(cfg, batch, dev))
            continue
        n = max_seq if kind == "ga" else min(cfg.window or max_seq, max_seq)
        state.append({"k": torch.zeros((batch, hkv, n, hd), dtype=dtype,
                                       device=dev),
                      "v": torch.zeros((batch, hkv, n, hd), dtype=dtype,
                                       device=dev)})
    return state


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                index: int, state: List[Dict[str, torch.Tensor]],
                cross: Optional[CrossKV] = None, moe_group=None, tp=None
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step: token [B] at position ``index`` (the cache
    occupancy) -> (logits [B, V_padded] fp32, new state).  KV caches and
    ring buffers are written in place; a recurrent layer's state is
    replaced.  Local attention reads a ring buffer of ``window`` slots
    (sub-quadratic memory).  ``cross``: the encoder's K/V (``cross_kv``);
    without it an encoder-decoder skips its cross-attention, as the
    reference's ``decode_step`` does.  A MoE layer routes the B tokens of
    the step as one batch (with ``moe_group``, the tokens of every rank
    of the group).

    ``tp``: the weights and caches are this rank's shards
    (``launch.sharding.kv_cache_spec``'s layout: the kv heads over
    ``model`` where they divide, else the sequence, ``_seq_attention``);
    recurrent states are whole on every rank; the logits are this rank's
    block of the vocab."""
    tp = L.as_tp(tp)
    index = int(index)
    x = L.embed(params["embed"], token[:, None], tp).to(dtype_of(cfg))
    pos = torch.full((1,), index, dtype=torch.int64, device=token.device)
    ends = cross_after(cfg) if cross is not None else {}
    P = len(cfg.block_pattern)
    seq = cfg.n_kv_heads % tp.size != 0
    new_state = []
    for li, (kind, p, st) in enumerate(zip(layer_kinds(cfg),
                                           params["layers"], state)):
        if li % P == 0 and li < cfg.n_superlayers * P:
            x = _constrain(x)
        p = tp.layer(p)
        if kind in ("ga", "la") and seq:
            x = _seq_attention(p["mixer"], cfg, x, pos, (st["k"], st["v"]),
                               index, tp, ring=kind == "la")
        elif kind == "ga":
            x, _ = L.attention_block(
                p["mixer"], cfg, x, pos, window=None,
                kv_cache=(st["k"], st["v"]), cache_index=index, tp=tp)
        elif kind == "la":
            x = _ring_attention(p["mixer"], cfg, x, pos, (st["k"], st["v"]),
                                index, tp)
        elif kind == "rg":
            x, st = rglru_block(p["mixer"], cfg, x, state=st, tp=tp)
        else:
            x, st = rwkv_block(p["mixer"], cfg, x, state=st, tp=tp)
        new_state.append(st)
        if kind != "rwkv":
            x, _ = _ffn(p, cfg, x, moe_group, tp)
        if li in ends:
            x, _ = L.attention_block(tp.layer(params["cross"][ends[li]]), cfg,
                                     x, pos, window=None,
                                     cross_kv=cross[ends[li]],
                                     use_kernel=False, tp=tp)
    return L.logits(params["embed"], cfg, x, tp)[:, 0], new_state


def _ring_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    pos: torch.Tensor, cache, index: int, tp=None
                    ) -> torch.Tensor:
    """Sliding-window decode over a ring-buffer KV cache of ``w`` slots.

    The newest entry overwrites slot ``index % w`` (in place).  All slots
    are valid once ``index >= w``, before that the first ``index + 1``;
    the window is exact because the buffer holds the last ``w``
    positions, and a softmax over the slots does not depend on their
    order.  ``tp``: this rank's heads (they divide over ``model``)."""
    tp = L.as_tp(tp)
    B, S, d = x.shape
    h, hkv = cfg.n_heads // tp.size, cfg.n_kv_heads // tp.size
    hd = cfg.head_dim_
    xn = tp.copy(L.rms_norm(x, p["ln"]))
    q = L.split_heads(L.mm(xn, p["wq"]), h, hd)
    k = L.split_heads(L.mm(xn, p["wk"]), hkv, hd)
    v = L.split_heads(L.mm(xn, p["wv"]), hkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, tp.copy(p["q_norm"]))
        k = L.rms_norm(k, tp.copy(p["k_norm"]))
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    ck, cv = cache
    w = ck.shape[2]
    ring = index % w
    ck[:, :, ring:ring + 1] = k.to(ck.dtype)
    cv[:, :, ring:ring + 1] = v.to(cv.dtype)
    valid = min(index + 1, w)
    age = (ring - torch.arange(w, device=x.device)) % w
    bias = torch.where(age < valid, 0.0, -1e30)
    o = _masked_attn(q, ck, cv, bias, cfg)
    o = o.transpose(1, 2).reshape(B, S, h * hd)
    return x + tp.reduce(L.mm(o, p["wo"]))


def _seq_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   pos: torch.Tensor, cache, index: int, tp, ring: bool
                   ) -> torch.Tensor:
    """One decode token over a KV cache (``ring``: a sliding window's
    ring buffer) whose sequence is split over ``model`` (the kv heads do
    not divide): every rank projects all heads (the columns gathered),
    the rank that holds the slot of position ``index`` writes the new
    k/v, each rank attends its block of slots, and the partial softmaxes
    combine by their max and sums over ``model``; the output's columns
    are sliced back before the row-parallel ``wo``."""
    B, S, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    xn = L.rms_norm(x, p["ln"])
    q, k, v = (L.split_heads(tp.gather_cols(L.mm(xn, p[w])), n, hd)
               for w, n in (("wq", h), ("wk", hkv), ("wv", hkv)))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    ck, cv = cache
    n = ck.shape[2]
    w = n * tp.size
    g = tp.rank * n + torch.arange(n, device=x.device)
    if ring:
        slot = index % w
        mask = (slot - g) % w < min(index + 1, w)
    else:
        slot = min(max(index, 0), w - 1)
        mask = g <= index
    if tp.rank * n <= slot < (tp.rank + 1) * n:
        ck[:, :, slot - tp.rank * n] = k[:, :, 0].to(ck.dtype)
        cv[:, :, slot - tp.rank * n] = v[:, :, 0].to(cv.dtype)
    rep = h // hkv
    q5 = q.reshape(B, hkv, rep, S, hd).float()
    lg = torch.einsum("bhrqd,bhkd->bhrqk", q5, ck.float()) * hd ** -0.5
    if cfg.attn_softcap is not None:
        lg = cfg.attn_softcap * torch.tanh(lg / cfg.attn_softcap)
    lg = torch.where(mask, lg, NEG_INF)
    m = lg.amax(dim=-1)
    dead = m <= -1e29
    pr = torch.where(dead[..., None], 0.0, torch.exp(lg - m[..., None]))
    part = torch.cat([torch.einsum("bhrqk,bhkd->bhrqd", pr, cv.float()),
                      pr.sum(dim=-1)[..., None]], dim=-1)
    alpha = torch.where(dead, 0.0, torch.exp(m - tp.pmax(m)))
    tot = tp.reduce(part * alpha[..., None])
    o = tot[..., :hd] / torch.where(tot[..., hd:] == 0.0, 1.0, tot[..., hd:])
    o = o.reshape(B, h, S, hd).to(q.dtype).transpose(1, 2).reshape(
        B, S, h * hd)
    return x + tp.reduce(L.mm(tp.cols(o), p["wo"]))


def _masked_attn(q, k, v, logits_bias, cfg: ModelConfig) -> torch.Tensor:
    rep = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1).float()
    vv = v.repeat_interleave(rep, dim=1).float()
    lg = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * \
        (q.shape[-1] ** -0.5)
    if cfg.attn_softcap is not None:
        lg = cfg.attn_softcap * torch.tanh(lg / cfg.attn_softcap)
    lg = lg + logits_bias
    pr = torch.softmax(lg, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", pr, vv).to(q.dtype)
