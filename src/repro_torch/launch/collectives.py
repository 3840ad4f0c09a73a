"""The collectives the mesh paths use, over a ``torch.distributed``
process group (``sharding.axes_group``): the ``all_gather``, ``psum``
and ``pmean`` of the reference's ``shard_map`` bodies, and the
differentiable pairs of a tensor-parallel layer (Megatron's conjugate
operators), which stand in for the collectives GSPMD inserts into the
reference's sharded steps:

* ``copy_to``: identity forward, all-reduce backward (where a tensor
  replicated over the group feeds this rank's shard of a product);
* ``reduce_from``: all-reduce forward, identity backward (after a
  row-parallel product);
* ``gather_cols``: the last dim gathered, the backward this rank's slice
  (where the gathered tensor feeds work every rank repeats);
* ``gather_dim``: a dim gathered, the backward a reduce-scatter (the
  FSDP gather of a parameter, and a gathered activation that feeds this
  rank's shard of a product);
* ``pmax``: an all-reduce ``MAX`` (the vocab-parallel softmax's shift;
  not differentiated).

A group of one is a copy: each op returns its input, and the sums and
means leave their input's bits unchanged, so a mesh of one device
computes what the unsharded code does, bit for bit.  Every op traces
under ``FakeTensorMode`` on a fake group (the dry run).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: ``x`` of every rank of ``group``, in group-rank
    order (``jax.lax.all_gather``).  Not differentiable."""
    n = group_size(group)
    if n == 1:
        return x.unsqueeze(0)
    x = x.contiguous()
    # gloo wants the output flat: [n * numel], viewed back.
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


class _GatherDim(torch.autograd.Function):
    """Every rank's block concatenated along ``dim``; the backward sums
    each block's cotangents over the ranks onto its owner (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        st = gather_stack(x, group)                    # [n, *x.shape]
        return torch.movedim(st, 0, dim).reshape(
            x.shape[:dim] + (-1,) + x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        n, d = dist.get_world_size(ctx.group), ctx.dim
        c = g.shape[d] // n
        g = torch.movedim(g.reshape(g.shape[:d] + (n, c) + g.shape[d + 1:]),
                          d, 0).contiguous()
        gx = g.new_empty(g.shape[1:])
        dist.reduce_scatter_tensor(gx.view(-1), g.view(-1), group=ctx.group)
        return gx, None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim``
    in group-rank order, differentiable with a reduce-scatter backward;
    ``x`` itself on a group of one."""
    if group_size(group) == 1:
        return x
    return _GatherDim.apply(x, dim % x.dim(), group)


class _GatherCols(torch.autograd.Function):
    """The last dim of every rank concatenated; the backward keeps this
    rank's slice of the cotangent (which every rank holds whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.c = group, x.shape[-1]
        st = gather_stack(x, group)                    # [n, ..., c]
        return torch.movedim(st, 0, -2).reshape(x.shape[:-1] + (-1,))

    @staticmethod
    def backward(ctx, g):
        r, c = dist.get_rank(ctx.group), ctx.c
        return g[..., r * c:(r + 1) * c].contiguous(), None


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """[..., n * c] from every rank's [..., c] in group-rank order, the
    backward this rank's slice; ``x`` itself on a group of one."""
    if group_size(group) == 1:
        return x
    return _GatherCols.apply(x, group)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose cotangent is summed over ``group`` in the backward
    pass: a tensor every rank holds whole, fed to this rank's shard of
    the work.  ``x`` itself on a group of one."""
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group forward; the cotangent passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (each rank's partial product of a
    row-parallel layer), whose cotangent passes unchanged to every rank.
    ``x`` itself on a group of one."""
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, detached (a
    softmax's shift, whose gradient is zero)."""
    if group_size(group) == 1:
        return x.detach()
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * b, ...] from every rank's [b, ...] in group-rank order,
    differentiable (autograd's own ``all_gather`` cannot take a subgroup
    on gloo); ``x`` itself on a group of one."""
    return gather_dim(x, 0, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a new tensor)."""
    x = x.clone()
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``, divided by a scalar
    on its device."""
    n = group_size(group)
    if n == 1:
        return x
    return psum(x, group) / torch.tensor(float(n), dtype=x.dtype,
                                         device=x.device)
