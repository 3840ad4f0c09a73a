"""Model assembly: embeddings, a stack of blocks, the LM head.

The port of ``repro.models.transformer`` for the block kinds ``ga``
(global attention), ``la`` (local, sliding-window attention) and ``rg``
(RG-LRU), with the configs' superlayer pattern and tail: dense llama-style
decoders, gemma2, chameleon and recurrentgemma.  Where the reference
stacks each slot's weights over superlayers and scans them, the port
keeps one parameter dict per layer in layer order and loops over them —
the same layers in the same order.  There is no remat and no sharding
constraint: those belong to training and meshes (ROADMAP Queue 1
item 17).

Three entry points:
  ``init_params``       — parameters drawn from a ``torch.Generator``.
  ``forward``           — full-sequence logits (prefill).
  ``decode_step``       — one token over KV caches / recurrent states.

MoE, RWKV6 and encoder-decoder configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig
from .rglru import rglru_block, rglru_init_state, rglru_params

Params = Dict[str, Any]

#: the ROADMAP item that ports the block kinds and paths not here yet.
MODELS_ITEM = "ROADMAP Queue 1 item 16 (moe.py, rwkv6.py, encoder-decoder)"


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks: {MODELS_ITEM}")
    if cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder: "
                                  f"{MODELS_ITEM}")
    other = sorted(set(cfg.all_blocks) - {"ga", "la", "rg"})
    if other:
        raise NotImplementedError(f"{cfg.name}: block kinds {other}: "
                                  f"{MODELS_ITEM}")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in order: the superlayer pattern
    repeated, then the tail."""
    return list(cfg.block_pattern) * cfg.n_superlayers + \
        list(cfg.tail_pattern)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Params:
    """{"embed": {...}, "layers": [{"mixer": {...}, "ffn": {...}}, ...]}
    in the model's dtype on ``device``, drawn from ``generator`` (which
    lies on that device) with the reference's scales: weights normal times
    fan_in^-0.5, norms 0, the RG-LRU's Lambda 2.0."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    params: Params = {"embed": L.embed_params(generator, cfg, dtype, dev)}
    layers = []
    for kind in layer_kinds(cfg):
        mixer = (rglru_params if kind == "rg" else L.attn_params)(
            generator, cfg, dtype, dev)
        layers.append({"mixer": mixer,
                       "ffn": L.mlp_params(generator, cfg, dtype, dev)})
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            last_only: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V_padded] fp32, on the parameters'
    device.  ``last_only=True`` (serving prefill): the LM head for the
    final position only, [B, 1, V_padded]."""
    check_supported(cfg)
    x = L.embed(params["embed"], tokens).to(dtype_of(cfg))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        if kind == "rg":
            x, _ = rglru_block(p["mixer"], cfg, x)
        else:
            x, _ = L.attention_block(
                p["mixer"], cfg, x, pos,
                window=cfg.window if kind == "la" else None)
        x = L.mlp_block(p["ffn"], cfg, x)
    if last_only:
        x = x[:, -1:]
    return L.logits(params["embed"], cfg, x)


# ---------------------------------------------------------------------------
# decode (single token over caches / recurrent states)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> List[Dict[str, torch.Tensor]]:
    """One state per layer: ``ga`` a KV cache {"k", "v"} [B, Hkv, max_seq,
    hd]; ``la`` a ring buffer of ``min(window, max_seq)`` slots; ``rg``
    {"h": [B, d] fp32, "conv": [B, 3, d]}."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    state = []
    for kind in layer_kinds(cfg):
        if kind == "rg":
            state.append(rglru_init_state(cfg, batch, dev))
            continue
        n = max_seq if kind == "ga" else min(cfg.window or max_seq, max_seq)
        state.append({"k": torch.zeros((batch, hkv, n, hd), dtype=dtype,
                                       device=dev),
                      "v": torch.zeros((batch, hkv, n, hd), dtype=dtype,
                                       device=dev)})
    return state


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                index: int, state: List[Dict[str, torch.Tensor]]
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step: token [B] at position ``index`` (the cache
    occupancy) -> (logits [B, V_padded] fp32, new state).  KV caches and
    ring buffers are written in place; a recurrent layer's state is
    replaced.  Local attention reads a ring buffer of ``window`` slots
    (sub-quadratic memory)."""
    check_supported(cfg)
    index = int(index)
    x = L.embed(params["embed"], token[:, None]).to(dtype_of(cfg))
    pos = torch.full((1,), index, dtype=torch.int64, device=token.device)
    new_state = []
    for kind, p, st in zip(layer_kinds(cfg), params["layers"], state):
        if kind == "ga":
            x, _ = L.attention_block(
                p["mixer"], cfg, x, pos, window=None,
                kv_cache=(st["k"], st["v"]), cache_index=index)
        elif kind == "la":
            x = _ring_attention(p["mixer"], cfg, x, pos, (st["k"], st["v"]),
                                index)
        else:
            x, st = rglru_block(p["mixer"], cfg, x, state=st)
        new_state.append(st)
        x = L.mlp_block(p["ffn"], cfg, x)
    return L.logits(params["embed"], cfg, x)[:, 0], new_state


def _ring_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    pos: torch.Tensor, cache, index: int) -> torch.Tensor:
    """Sliding-window decode over a ring-buffer KV cache of ``w`` slots.

    The newest entry overwrites slot ``index % w`` (in place).  All slots
    are valid once ``index >= w``, before that the first ``index + 1``;
    the window is exact because the buffer holds the last ``w``
    positions, and a softmax over the slots does not depend on their
    order."""
    B, S, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    xn = L.rms_norm(x, p["ln"])
    q = L.split_heads(L.mm(xn, p["wq"]), h, hd)
    k = L.split_heads(L.mm(xn, p["wk"]), hkv, hd)
    v = L.split_heads(L.mm(xn, p["wv"]), hkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
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
    return x + L.mm(o, p["wo"])


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
