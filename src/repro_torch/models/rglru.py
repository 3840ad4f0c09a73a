"""RG-LRU recurrent block (recurrentgemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.rglru``.  The recurrence:

    a_t = exp(-c * softplus(Lambda) * sigmoid(x W_a))
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

with an input gate i_t and a linear output projection, inside Griffin's
recurrent block: a GeLU gate branch times the recurrence branch (a width-4
causal depthwise conv before the gates), projected out.

Prefill runs the whole sequence through ``kernels.ops.rglru`` (the CUDA
scan on the card, or its plain version with ``use_kernel=False``, which
training takes); decode updates the O(1) state inline, in plain
PyTorch, as the reference does outside Pallas.

With ``tp`` the recurrence's channels split over ``model``: ``w_x``,
``w_gate`` and ``conv_w`` give this rank's channels, the gates' products
take the conv's output with its channels gathered, the scan runs on this
rank's channels, and ``w_out`` is row-parallel; the decode state stays
whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import Params, as_tp, dense_init, mm, rms_norm

C_FACTOR = 8.0


def rglru_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = dr = cfg.d_model          # the recurrence is as wide as the model
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_x": dense_init(gen, d, (d, dr), dtype, device),
        "w_gate": dense_init(gen, d, (d, dr), dtype, device),
        "conv_w": dense_init(gen, 4, (4, dr), dtype, device),
        "w_a": dense_init(gen, dr, (dr, dr), dtype, device),
        "w_i": dense_init(gen, dr, (dr, dr), dtype, device),
        "lam": torch.full((dr,), 2.0, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, dr, (dr, d), dtype, device),
    }


def _gates(p: Params, xr: torch.Tensor, lam: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 recurrence gate ``a`` (in (0, 1)) and input gate ``i`` for the
    pre-activation xr [..., dr]; ``lam``: the channels' Lambda (default
    ``p["lam"]``)."""
    ra = torch.sigmoid(mm(xr, p["w_a"]).float())
    lam = F.softplus(p["lam"] if lam is None else lam)
    a = torch.exp(-C_FACTOR * lam * ra)
    i = torch.sigmoid(mm(xr, p["w_i"]).float())
    return a, i


def _causal_conv4(xr: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4: (out [B, S, dr], the last 3 inputs
    [B, 3, dr]).  ``state`` holds the 3 inputs before xr (zeros if None)."""
    B, S, dr = xr.shape
    if state is None:
        state = xr.new_zeros((B, 3, dr))
    xpad = torch.cat([state, xr], dim=1)                   # [B, S+3, dr]
    out = sum(xpad[:, i:i + S] * w[i] for i in range(4))
    return out, xpad[:, -3:]


def rglru_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                use_kernel: bool = True, tp=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: [B, S, d] -> (y, new_state).  ``state`` (decode, S = 1):
    {"h": [B, dr] fp32, "conv": [B, 3, dr]}; None in prefill, where the
    new state is None too.  ``use_kernel=False`` scans with the plain
    version (training: the kernel has no backward).  ``tp``: this rank's
    channels (the module's docstring)."""
    tp = as_tp(tp)
    xn = tp.copy(rms_norm(x, p["ln"]))
    gate = F.gelu(mm(xn, p["w_gate"]).float(),
                  approximate="tanh").to(x.dtype)
    xr = mm(xn, p["w_x"])
    xr, conv_state = _causal_conv4(
        xr, p["conv_w"], None if state is None else tp.cols(state["conv"]))
    a, i = _gates(p, tp.gather_rs(xr), tp.cols(tp.copy(p["lam"])))
    gx = (i * xr.float()).to(x.dtype)

    if state is None:
        # the gate is rounded to the block's dtype before the scan.
        h = kops.rglru(gx, a.to(gx.dtype), use_kernel=use_kernel)
        new_state = None
    else:
        beta = torch.sqrt(torch.clamp(1.0 - a[:, 0] ** 2, min=0.0))
        h1 = a[:, 0] * tp.cols(state["h"]).float() + beta * gx[:, 0].float()
        h = h1[:, None].to(x.dtype)
        new_state = {"h": tp.gather_cols(h1),
                     "conv": tp.gather_cols(conv_state)}

    return x + tp.reduce(mm(h * gate, p["w_out"])), new_state


def rglru_init_state(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    dr = cfg.d_model
    conv_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, 3, dr), dtype=conv_dtype,
                                device=device)}
