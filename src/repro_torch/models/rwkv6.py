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

The reference runs the recurrence as one ``lax.scan`` over the tokens,
outside Pallas.  Here it is plain PyTorch in fp32, exact, in chunks
(``wkv_chunked``): the recurrence is linear in the state, so inside a
chunk of C tokens each output is a sum over the chunk's earlier tokens
with pairwise decays, and only the state is carried from chunk to chunk
-- S / C steps of one operation where a loop over the tokens would
dispatch a dozen device operations a token.  A decode of one token keeps
the scan's step.

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


#: tokens a chunk of ``wkv_chunked``: its pairwise decays take
#: ``WKV_CHUNK`` times the memory of r, its carry S / ``WKV_CHUNK`` steps.
WKV_CHUNK = 16


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence of the module's docstring over r, k, v and the
    log-decay ``logw`` [B, S, H, hd] fp32 with the bonus ``u`` [H, hd],
    from the state ``s0`` [B, H, hd, hd]: (out [B, S, H, hd], the final
    state), the function of the reference's ``lax.scan``, in chunks.

    With L and L' the inclusive and exclusive cumulative sums of ``logw``
    inside a chunk of C = ``WKV_CHUNK`` tokens, and S0 the state the
    chunk starts from:

        o_t = (r_t * e^{L'_t}) S0 + (r_t . (u * k_t)) v_t
              + sum_{j<t} [sum_k r_t[k] k_j[k] e^{L'_t[k] - L_j[k]}] v_j
        S_C = e^{L_C} * S0 + sum_j (k_j * e^{L_C - L_j}) v_j^T

    Every exponent is a sum of only the log-decays it spans, so it is
    <= 0 and as exact as the scan's own products: the decay between two
    tokens, L'_t - L_j = sum_{j<i<t} logw_i, is a cumulative sum of the
    terms masked to the pair, formed for every pair with j < t and set
    to -inf elsewhere before the exponential.  It is never e^{L'_t}
    e^{-L_j}, which overflows once a chunk's decays sum below about -80,
    nor a difference of two cumulative sums, which loses the small
    decays beside a large one.  The sequence is padded to whole chunks
    with k = 0 and logw = 0, which leave the state as it is.  The terms
    inside the chunks are batched over all of them; only the carry
    loops, one ``addcmul`` a chunk."""
    B, S, H, hd = r.shape
    C = WKV_CHUNK
    N = -(-S // C)

    def chunks(z):                      # [B, S, H, hd] -> [B, H, N, C, hd]
        z = F.pad(z, (0, 0, 0, 0, 0, N * C - S))
        return z.reshape(B, N, C, H, hd).permute(0, 3, 1, 2, 4)

    r, k, v, logw = chunks(r), chunks(k), chunks(v), chunks(logw)
    prev = F.pad(logw, (0, 0, 1, 0))[..., :-1, :]         # logw_{t-1}
    tri = torch.ones((C, C), dtype=torch.bool, device=r.device)
    pair = (prev[..., :, None, :].masked_fill(~tri.tril(-2)[:, :, None], 0)
            .cumsum_(-3)                                  # [.., t, j, hd]
            .masked_fill_(~tri.tril(-1)[:, :, None], float("-inf"))
            .exp_())
    att = torch.einsum("bhntjk,bhntk->bhntj", pair * k[..., None, :, :], r)
    # the carry: each chunk's own k v^T decayed to its end, then S / C steps
    nxt = F.pad(logw, (0, 0, 0, 1))[..., 1:, :]           # logw_{j+1}
    to_end = nxt.flip(3).cumsum(3).flip(3)                # L_C - L_j
    own = torch.einsum("bhnjk,bhnjv->bhnkv", k * torch.exp(to_end), v)
    s, starts = s0, []
    for dec, kv in zip(torch.exp(logw.sum(3)).unsqueeze(-1).unbind(2),
                       own.unbind(2)):
        starts.append(s)
        s = torch.addcmul(kv, dec, s)
    out = (torch.einsum("bhntk,bhnkv->bhntv", r * torch.exp(prev.cumsum(3)),
                        torch.stack(starts, 2))
           + torch.einsum("bhntj,bhnjv->bhntv", att, v)
           + (r * u[:, None, None] * k).sum(-1, keepdim=True) * v)
    return out.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, hd)[:, :S], s


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
    # data-dependent decay w = exp(logw) in (0, 1); its log is taken from
    # the expression, never from an underflowed w
    logw = -torch.exp(wlog + torch.tanh(wx.float()))

    def heads(z):
        return z.reshape(B, S, H, hd).float()

    r, k, v, logw = heads(r), heads(k), heads(v), heads(logw)
    u = u_p.reshape(H, hd)
    if S == 1:                                   # decode: the scan's step
        kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]     # [B, H, dk, dv]
        out = torch.einsum("bhkv,bhk->bhv", state_s + u[..., None] * kv,
                           r[:, 0])
        s = torch.exp(logw[:, 0, :, :, None]) * state_s + kv
    else:
        out, s = wkv_chunked(r, k, v, logw, u, state_s)
    out = out.reshape(B, S, H * hd).to(xn.dtype)
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
