"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, and the squared-ReLU channel-mix FFN.

The port of ``repro.models.rwkv6``.  Per head (head_dim 64) a state S in
R^{dk x dv} evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t        (readout with bonus u)

with r, k, v projections of the token-shifted input and the decay
``w_t = exp(-exp(wlog + tanh(x W_w)))``.  The token shift mixes each
channel statically with the previous token, as the reference simplifies
Finch's low-rank interpolation.

The recurrence is a loop over the sequence of the reference's scan step,
in fp32, in plain PyTorch (the reference computes it outside Pallas);
decode is one step from the carried state.

With ``tp`` the channels split over ``model``: the receptance, key,
value and decay products and the channel mix's key are column-parallel,
``w_o`` and ``cm_v`` row-parallel.  Where the WKV heads divide over the
ranks each rank runs its own; where they do not (rwkv6-3b's 40 heads
over 16) the columns are gathered and every rank runs all of them.  The
decode state stays whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, as_tp, dense_init, mm, rms_norm


def rwkv_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff

    def full(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)

    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5),
        "w_r": dense_init(gen, d, (d, d), dtype, device),
        "w_k": dense_init(gen, d, (d, d), dtype, device),
        "w_v": dense_init(gen, d, (d, d), dtype, device),
        "w_w": dense_init(gen, d, (d, d), dtype, device),
        "wlog": full(-1.0),                         # base decay
        "u": full(0.0),                             # bonus
        "w_o": dense_init(gen, d, (d, d), dtype, device),
        # channel mix (squared relu)
        "cm_ln": torch.zeros((d,), dtype=dtype, device=device),
        "cm_mix": full(0.5),
        "cm_k": dense_init(gen, d, (d, f), dtype, device),
        "cm_v": dense_init(gen, f, (f, d), dtype, device),
        "cm_r": dense_init(gen, d, (d, d), dtype, device),
    }


def _token_shift(x: torch.Tensor, mix: torch.Tensor,
                 last: Optional[torch.Tensor]) -> torch.Tensor:
    """``mix * x_t + (1 - mix) * x_{t-1}`` in fp32, cast to x's dtype;
    x_{-1} is ``last`` [B, d] in decode, zeros in prefill."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = last[:, None]
    return (mix * x.float() + (1 - mix) * prev.float()).to(x.dtype)


def _time_mix(p: Params, cfg: ModelConfig, xn: torch.Tensor,
              state_s: torch.Tensor, last: Optional[torch.Tensor], tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B, S, d], final state [B, H, dk, dv] fp32, new last [B, d]).
    ``tp``: the state and its final value hold this rank's heads where
    they divide over ``model``, else all of them."""
    tp = as_tp(tp)
    B, S, d = xn.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    local = H % tp.size == 0
    r, k, v, wx = (mm(tp.copy(_token_shift(xn, p[m], last)), p[w])
                   for m, w in (("mix_r", "w_r"), ("mix_k", "w_k"),
                                ("mix_v", "w_v"), ("mix_w", "w_w")))
    if local:
        H //= tp.size
        wlog, u_p = tp.cols(tp.copy(p["wlog"])), tp.cols(tp.copy(p["u"]))
    else:
        r, k, v, wx = (tp.gather_cols(z) for z in (r, k, v, wx))
        wlog, u_p = p["wlog"], p["u"]
    # data-dependent decay in (0, 1)
    w = torch.exp(-torch.exp(wlog + torch.tanh(wx.float())))

    def heads(z):
        return z.reshape(B, S, H, hd).float()

    r, k, v, w = heads(r), heads(k), heads(v), heads(w)
    u = u_p.reshape(H, hd)[None, :, :, None]
    s = state_s
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # [B, H, dk, dv]
        outs.append(torch.einsum("bhkv,bhk->bhv", s + u * kv, r[:, t]))
        s = w[:, t, :, :, None] * s + kv
    out = torch.stack(outs, dim=1).reshape(B, S, H * hd).to(xn.dtype)
    if not local:
        out = tp.cols(tp.copy(out))
    return tp.reduce(mm(out, p["w_o"])), s, xn[:, -1]


def rwkv_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
               state: Optional[Dict[str, torch.Tensor]] = None, tp=None
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x [B, S, d] -> (y, new_state).  Decode ``state``: {"s": [B, H, dk,
    dv] fp32, "last": [B, d], "cm_last": [B, d]}; None in prefill, where
    the new state is None too.  ``tp``: this rank's channels (the
    module's docstring)."""
    tp = as_tp(tp)
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    local = (d // hd) % tp.size == 0
    xn = rms_norm(x, p["ln"])
    s0 = (x.new_zeros((B, d // hd, hd, hd), dtype=torch.float32)
          if state is None else state["s"])
    if local:
        s0 = tp.cols(s0, dim=1)
    last = None if state is None else state["last"]
    tm, s_final, new_last = _time_mix(p, cfg, xn, s0, last, tp)
    x = x + tm

    # channel mix (squared relu, with a receptance gate)
    xc = rms_norm(x, p["cm_ln"])
    cm_last = None if state is None else state["cm_last"]
    xs = tp.copy(_token_shift(xc, p["cm_mix"], cm_last))
    kk = torch.relu(mm(xs, p["cm_k"]))
    rr = tp.gather_cols(torch.sigmoid(mm(xs, p["cm_r"]).float()).to(x.dtype))
    x = x + rr * tp.reduce(mm(kk * kk, p["cm_v"]))

    new_state = None
    if state is not None:
        if local:
            s_final = tp.gather_rs(s_final, dim=1)
        new_state = {"s": s_final, "last": new_last, "cm_last": xc[:, -1]}
    return x, new_state


def rwkv_init_state(cfg: ModelConfig, batch: int,
                    device) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"s": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                             device=device),
            "last": torch.zeros((batch, d), dtype=dt, device=device),
            "cm_last": torch.zeros((batch, d), dtype=dt, device=device)}
