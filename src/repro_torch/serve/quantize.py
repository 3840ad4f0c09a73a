"""Weight-only int8 quantization for the serving path.

The port of ``repro.serve.quantize``.  Decode sweeps every weight from
memory each step; per-output-channel symmetric int8 halves the sweep of
the matmul weights.  A quantized weight is the dict ``{"q": int8 [in,
out], "s": fp32 [out]}``; ``models.layers.mm`` dequantizes on use.

The reference walks its stacked parameter pytree (each superlayer slot's
weights stacked ``[n_superlayers, in, out]``); the port's parameters keep
one dict per layer (``models.transformer.init_params``).  Each leaf is
decided by its own key, as ``tree_map_with_path`` decides it, and the
size threshold is applied to the leaf as the reference stacks it when
the config is given (``cfg``), so the same weights are quantized.
"""
from __future__ import annotations

from typing import Any

import torch

from ..models.config import ModelConfig

#: param leaf names that stay full precision (norms, gates, embeddings —
#: the embedding table is a gather, not a matmul sweep).
_SKIP_PREFIX = ("ln", "mix", "cm_mix", "cm_ln", "final_ln", "q_norm",
                "k_norm", "lam", "u", "wlog", "conv_w", "router", "tok")


def _skip(name: str) -> bool:
    return any(name == p or name.startswith(p) for p in _SKIP_PREFIX) \
        or name.endswith("ln")


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric int8 over the CONTRACTION dim (-2): the scale has shape
    ``w.shape[:-2] + w.shape[-1:]`` (per output channel).  Rounding is
    half to even, as ``jnp.round``'s."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    # a divisor on the device: PyTorch's CUDA division by a CPU scalar
    # multiplies by its reciprocal, which is not the reference's quotient.
    scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127
                    ).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def quantize_params(params, min_size: int = 1 << 12, *,
                    cfg: ModelConfig):
    """Quantize every eligible matmul weight of the port's parameters
    (``{"embed": {...}, "layers": [...]}``, and ``"encoder"``/``"cross"``
    for an encoder-decoder) for the config ``cfg``; returns a new tree
    whose other leaves are the same tensors.  A leaf counts toward
    ``min_size`` as many times as the reference stacks it: a layer of the
    superlayer pattern and a cross-attention block ``cfg.n_superlayers``
    times, an encoder layer ``cfg.encoder.n_layers`` times.  An expert
    weight ``[E, d, f]`` gets the scale ``[E, f]``."""
    stacked = cfg.n_superlayers * len(cfg.block_pattern)

    def one(name, leaf, depth):
        if (name is None or _skip(name) or leaf.dim() < 2
                or leaf.shape[-2] < 8       # stacked vectors, not matmuls
                or leaf.numel() * depth < min_size
                or not leaf.is_floating_point()):
            return leaf
        return quantize_weight(leaf)

    def walk(node, name, depth):
        if isinstance(node, dict):
            return {k: walk(v, k, depth) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, depth) for v in node]
        return one(name, node, depth)

    def top(key, node):
        if key == "layers":
            return [walk(layer, None,
                         cfg.n_superlayers if li < stacked else 1)
                    for li, layer in enumerate(node)]
        if key == "cross":
            return [walk(blk, None, cfg.n_superlayers) for blk in node]
        if key == "encoder":
            return {"layers": [walk(layer, None, cfg.encoder.n_layers)
                               for layer in node["layers"]],
                    "final_ln": node["final_ln"]}
        return walk(node, key, 1)

    return {k: top(k, v) for k, v in params.items()}
