"""The few collectives the mesh paths use, over a ``torch.distributed``
process group (``sharding.axes_group``): the ``all_gather``, ``psum``
and ``pmean`` of the reference's ``shard_map`` bodies.

A group of one is a copy: the sums and means leave their input's bits
unchanged, so a mesh of one device computes what the unsharded code
does, bit for bit.
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


class _GatherRows(torch.autograd.Function):
    """Rows of every rank concatenated along dim 0; the backward sums
    each rank's cotangents of a block onto the block's owner (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_stack(x, group).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.contiguous()
        gx = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(gx.view(-1), g.view(-1), group=ctx.group)
        return gx, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * b, ...] from every rank's [b, ...] in group-rank order,
    differentiable (autograd's own ``all_gather`` cannot take a subgroup
    on gloo); ``x`` itself on a group of one."""
    if group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


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
