"""Mixture-of-Experts FFN with capacity-based dispatch.

The port of ``repro.models.moe`` (granite-3.0-moe, 32 experts top-8;
qwen3-moe, 128 experts top-8) on one device.  Tokens pick their top-k
experts through an fp32 router; each (token, k) slot takes a position in
its expert's capacity buffer ``[E, C, d]`` by arrival order, and slots
past the capacity are dropped.  The experts' swiglu FFNs run as batched
products over the buffer; the router carries the Switch load-balancing
loss.

Deterministic on the card: only kept slots are written to the buffer,
and their (expert, position) pairs are unique, so the scatter is a copy,
not an accumulation; each token's k contributions are summed over a
``[T, k, d]`` view in slot order, not with an atomic ``index_add_``.

``dispatch_int8=True`` sends the buffer and the experts' outputs through
int8 with a per-slot scale, as the reference's ``_dispatch_q8`` and
``_combine_q8`` do, with their custom gradients (``torch.autograd.Function`` subclasses:
the cotangent passes the wire unrounded).

On a mesh: ``moe_block_global`` routes the tokens of every rank of a
data-parallel group as one batch (capacity and aux loss over all of
them, the reference's sharded step); ``moe_block_local`` routes each
rank's own tokens (the reference's shard-local dispatch, per-shard
capacity).  ``set_ep_spec`` names the expert buffers' layout, which a
DTensor buffer is redistributed to; a plain tensor passes unchanged.
With ``tp`` (expert parallelism over ``model``, the reference's
``P("model", None, None)``) each rank of ``model`` runs only its own
experts' rows of the buffer, and the combine sums over ``model``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .config import ModelConfig
from .layers import Params, as_tp, dense_init, qeinsum, rms_norm

#: the (E, C, d) expert buffers' layout (a ``launch.sharding.
#: NamedSharding``; None: no constraint), set by the mesh builders.
_EP_SPEC = None


def set_ep_spec(spec) -> None:
    global _EP_SPEC
    _EP_SPEC = spec


def _constrain_ep(x):
    """``x`` in the expert layout: a DTensor on the spec's mesh is
    redistributed; anything else passes unchanged."""
    if _EP_SPEC is None or not isinstance(x, DTensor) or \
            x.device_mesh is not _EP_SPEC.mesh:
        return x
    from ..launch.sharding import placements
    mesh = _EP_SPEC.mesh
    return x.redistribute(mesh, placements(mesh, _EP_SPEC.spec, x.shape))


def moe_params(gen, cfg: ModelConfig, dtype, device) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.n_experts
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "router": dense_init(gen, d, (d, e), torch.float32, device),
        "w1": dense_init(gen, d, (e, d, f), dtype, device),
        "w3": dense_init(gen, d, (e, d, f), dtype, device),
        "w2": dense_init(gen, f, (e, f, d), dtype, device),
    }


def capacity(n_tok: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n_tok * top_k / n_experts * capacity_factor``
    in the reference's Python float arithmetic, at least ``top_k``."""
    m = cfg.moe
    return max(int(n_tok * m.top_k / m.n_experts * m.capacity_factor),
               m.top_k)


def dispatch_positions(flat_e: torch.Tensor, n_experts: int, cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each slot's position in its expert's buffer by arrival order.

    flat_e [T * k] expert of each slot -> (pos, keep, safe_pos): ``pos``
    the number of earlier slots with the same expert (int64), ``keep =
    pos < cap``, and ``safe_pos`` = ``pos`` where kept, else ``cap - 1``
    (the reference's clamp).  The reference counts through a one-hot
    ``[T * k, E]`` cumsum; here a stable sort groups the slots by expert
    in arrival order and a slot's position is its rank in its group —
    the same integers without the ``[T * k, E]`` plane, whose cumsum down
    65,536 rows of 32 took 14.6 ms a layer on an H100 (PERF.md)."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(
        n_experts, dtype=sorted_e.dtype, device=flat_e.device))
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) - \
        first[sorted_e]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    return pos, keep, safe_pos


def _scatter_kept(src: torch.Tensor, flat_e, pos, keep, n_experts: int,
                  cap: int) -> torch.Tensor:
    """``src`` [T * k, ...] rows into a zero buffer [E, C, ...] at (expert,
    position), kept slots only: a dropped slot goes to one spare row past
    the buffer, which is cut off.  The kept rows' targets are unique, so
    the copy is deterministic."""
    rows = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    buf = src.new_zeros((n_experts * cap + 1,) + src.shape[1:])
    buf.index_copy_(0, rows, src)
    return buf[:n_experts * cap].view((n_experts, cap) + src.shape[1:])


def _q8_scale(t: torch.Tensor) -> torch.Tensor:
    """Per-row int8 scale ``max(max |t|, 1e-9) / 127`` in fp32 over the
    last axis; the divisor lies on t's device (a CUDA division by a host
    scalar multiplies by its reciprocal, one bit off the reference)."""
    amax = t.float().abs().amax(dim=-1)
    return torch.clamp_min(amax, 1e-9) / amax.new_full((), 127.0)


def _q8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``t`` at ``scale`` (rounded half to even, as
    ``jnp.round``)."""
    return torch.clamp(torch.round(t.float() / scale[..., None]), -127, 127
                       ).to(torch.int8)


def _dispatch_q8_fwd(src, flat_e, pos, keep, n_experts: int, cap: int):
    """src [T * k, d] -> buffer [E, C, d] in src's dtype through an int8
    wire: per-slot codes and scales scattered, dequantized at the
    expert."""
    s_scale = _q8_scale(src)
    buf_q = _scatter_kept(_q8(src, s_scale), flat_e, pos, keep, n_experts,
                          cap)
    buf_s = _scatter_kept(s_scale, flat_e, pos, keep, n_experts, cap)
    return buf_q.to(src.dtype) * buf_s[..., None].to(src.dtype)


class _DispatchQ8(torch.autograd.Function):
    """The int8 dispatch with the reference's custom VJP
    (``_dispatch_q8_bwd``): rounding has no useful derivative, so the
    cotangent of the buffer goes straight back through the wire — each
    kept slot takes ``g[flat_e, safe_pos]``, a dropped one 0."""

    @staticmethod
    def forward(ctx, src, flat_e, pos, keep, n_experts, cap):
        ctx.save_for_backward(flat_e, pos, keep)
        return _dispatch_q8_fwd(src, flat_e, pos, keep, n_experts, cap)

    @staticmethod
    def backward(ctx, g):
        flat_e, pos, keep = ctx.saved_tensors
        safe_pos = torch.where(keep, pos, g.shape[1] - 1)
        g_src = torch.where(keep[:, None], _gather(g, flat_e, safe_pos), 0)
        return g_src, None, None, None, None, None


def _dispatch_q8(src, flat_e, pos, keep, n_experts: int, cap: int):
    """``_dispatch_q8_fwd`` with the reference's gradient."""
    return _DispatchQ8.apply(src, flat_e, pos, keep, n_experts, cap)


def _gather(buf: torch.Tensor, flat_e, safe_pos) -> torch.Tensor:
    """Rows ``buf[flat_e, safe_pos]`` of an ``[E, C, ...]`` buffer."""
    E, C = buf.shape[:2]
    return buf.reshape((E * C,) + buf.shape[2:]).index_select(
        0, flat_e * C + safe_pos)


def _combine_q8_fwd(out_buf, flat_e, safe_pos, keep):
    """out_buf [E, C, d] -> slot rows [T * k, d] through an int8 wire:
    quantized per buffer row at the expert, gathered, dequantized."""
    o_scale = _q8_scale(out_buf)
    out_q = _q8(out_buf, o_scale)
    slot_q = _gather(out_q, flat_e, safe_pos)
    slot_s = _gather(o_scale, flat_e, safe_pos)
    out = slot_q.to(out_buf.dtype) * slot_s[:, None].to(out_buf.dtype)
    return torch.where(keep[:, None], out, 0)


class _CombineQ8(torch.autograd.Function):
    """The int8 combine with the reference's custom VJP
    (``_combine_q8_bwd``): the kept slots' cotangent rows scattered into a
    zero ``[E, C, d]``.  Kept slots have unique (expert, position)
    targets, so the scatter is a copy (``_scatter_kept``): no atomics,
    deterministic on the card."""

    @staticmethod
    def forward(ctx, out_buf, flat_e, safe_pos, keep):
        ctx.save_for_backward(flat_e, safe_pos, keep)
        ctx.n_experts, ctx.cap = out_buf.shape[:2]
        return _combine_q8_fwd(out_buf, flat_e, safe_pos, keep)

    @staticmethod
    def backward(ctx, g):
        flat_e, safe_pos, keep = ctx.saved_tensors
        return (_scatter_kept(g, flat_e, safe_pos, keep, ctx.n_experts,
                              ctx.cap), None, None, None)


def _combine_q8(out_buf, flat_e, safe_pos, keep):
    """``_combine_q8_fwd`` with the reference's gradient."""
    return _CombineQ8.apply(out_buf, flat_e, safe_pos, keep)


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (x + MoE FFN of x, the router's aux loss, fp32
    scalar).  ``tp`` (expert parallelism over ``model``): every rank
    routes all the tokens, builds only its own ``E / tp.size`` experts'
    rows of the buffer, runs them with its local expert weights, and the
    combine sums over ``model``."""
    tp = as_tp(tp)
    m = cfg.moe
    B, S, d = x.shape
    n_tok, E, k = B * S, m.n_experts, m.top_k
    xn = rms_norm(x, p["ln"]).reshape(n_tok, d)

    gate_logits = xn.float() @ p["router"]                     # [T, E]
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, k, dim=-1)          # [T, k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch: E * sum_e f_e * p_e)
    flat_e = expert_idx.reshape(-1)                            # [T * k]
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    ce = ce / ce.new_full((), n_tok * k)       # counts: exact, any order
    aux = E * torch.sum(me * ce) * m.router_aux_weight

    cap = capacity(n_tok, cfg)
    pos, keep, safe_pos = dispatch_positions(flat_e, E, cap)
    slot_e = flat_e                 # each slot's expert among this rank's
    if tp.size > 1:
        E //= tp.size
        lo = tp.rank * E
        keep = keep & (flat_e >= lo) & (flat_e < lo + E)
        slot_e = torch.where(keep, flat_e - lo, 0)
    src = tp.copy(xn)[:, None].expand(n_tok, k, d).reshape(n_tok * k, d)
    if m.dispatch_int8:
        buf = _dispatch_q8(src, slot_e, pos, keep, E, cap)
    else:
        buf = _scatter_kept(src, slot_e, pos, keep, E, cap)
    buf = _constrain_ep(buf)

    # the experts' swiglu FFN over [E, C, d]
    h = qeinsum("ecd,edf->ecf", buf, p["w1"])
    g = qeinsum("ecd,edf->ecf", buf, p["w3"])
    h = F.silu(h.float()).to(x.dtype) * g
    out_buf = qeinsum("ecf,efd->ecd", h, p["w2"])              # [E, C, d]

    if m.dispatch_int8:
        slot_out = _combine_q8(out_buf, slot_e, safe_pos, keep)
    else:
        slot_out = torch.where(keep[:, None],
                               _gather(out_buf, slot_e, safe_pos), 0)
    slot_w = tp.copy(gate_w).reshape(-1).to(x.dtype)
    y = tp.reduce((slot_out * slot_w[:, None]).view(n_tok, k, d).sum(dim=1))
    return x + y.reshape(B, S, d), aux


def moe_block_global(p: Params, cfg: ModelConfig, x: torch.Tensor, group,
                     tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_block`` over the rows of ``x`` [b, S, d] of every rank of
    ``group`` (a process group over the data-parallel axes), as one
    batch: (this rank's rows of the output, the aux loss of the whole
    batch).  The gather is differentiable: each rank's cotangents reach
    the rows' owner.  On a group of one it is ``moe_block``.  ``tp``: see
    ``moe_block``."""
    from ..launch.collectives import gather_rows, group_size
    if group_size(group) == 1:
        return moe_block(p, cfg, x, tp)
    import torch.distributed as dist
    b = x.shape[0]
    r = dist.get_rank(group)
    y, aux = moe_block(p, cfg, gather_rows(x, group), tp)
    return y[r * b:(r + 1) * b], aux


def moe_block_local(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh,
                    dp_axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-local MoE dispatch: each data-parallel rank routes only its
    own tokens into capacity buffers of its own (per-shard capacity, the
    standard shard-local semantics), against the whole expert weights;
    the aux loss is the mean over the ranks.

    ``x`` [B, S, d]: a DTensor (redistributed to rows over ``dp_axes``)
    or the whole batch on every rank.  ``p``: plain tensors or DTensors
    (gathered).  Returns (y, a DTensor [B, S, d] with the batch over
    ``dp_axes``; aux, the same fp32 scalar on every rank)."""
    from ..launch import sharding as sh
    from ..launch.collectives import pmean
    dp = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
    spec = sh.P(dp, None, None)
    pl = sh.placements(mesh, spec, x.shape)
    if isinstance(x, DTensor):
        xl = x.redistribute(mesh, pl).to_local()
    else:
        b = x.shape[0] // sh.axes_size(mesh, dp)
        r = sh.axes_index(mesh, dp)
        xl = x[r * b:(r + 1) * b]
    y, aux = moe_block(sh.full_tree(p), cfg, xl)
    aux = pmean(aux, sh.axes_group(mesh, dp))
    y = DTensor.from_local(y, mesh, pl, run_check=False,
                           shape=torch.Size(x.shape),
                           stride=torch.empty(x.shape, device="meta").stride())
    return y, aux
