"""Pipeline parallelism: the GPipe schedule over a mesh axis.

The port of ``repro.runtime.pipeline``.  Stages hold contiguous layer
slices (the stage parameters' leading dim is the stage: rank ``s`` of
the axis keeps slice ``s``); micro-batches stream through the canonical
GPipe loop: at tick ``t`` stage ``s`` works on micro-batch ``t - s``,
and the activations hop to stage ``s + 1`` by point-to-point sends on
the axis's process group (the reference's ``ppermute``).  The loop runs
``n_micro + n_stages - 1`` ticks; the bubble fraction is
``(S - 1) / (M + S - 1)`` (``bubble_fraction``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..launch.collectives import psum
from ..launch.mesh import mesh_device
from ..tree import tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _hop(y: torch.Tensor, group, sid: int, n_stages: int) -> torch.Tensor:
    """Stage ``sid``'s ``y`` sent to stage ``sid + 1``; what stage
    ``sid - 1`` sent (zeros at stage 0, as ``ppermute`` gives a stage no
    one sends to)."""
    recv = torch.zeros_like(y)
    ops = []
    if sid + 1 < n_stages:
        ops.append(dist.P2POp(dist.isend, y.contiguous(),
                              dist.get_global_rank(group, sid + 1), group))
    if sid > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, sid - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def pipeline_apply(mesh, axis: str, layer_fn: Callable, stage_params,
                   x_micro: torch.Tensor) -> torch.Tensor:
    """Run micro-batches through the pipeline stages of ``axis``.

    ``layer_fn(params_slice, x) -> x``: one stage's computation.
    ``stage_params``: a tree whose leaves' leading dim is the stage (a
    DTensor sharded over ``axis`` or the whole tensor on every rank).
    ``x_micro`` [n_micro, mb, ...]: the micro-batches, the same on every
    rank.  Returns [n_micro, mb, ...], the last stage's outputs, on every
    rank (an all-reduce of the last stage's buffer, others masked to
    zero)."""
    group = mesh.get_group(axis)
    n_stages, sid = dist.get_world_size(group), dist.get_rank(group)
    dev = mesh_device(mesh)
    params = tree_map(lambda a: (a.to_local()[0] if isinstance(a, DTensor)
                                 else a[sid]).to(dev), stage_params)
    xs = x_micro.to(dev)
    n_micro = xs.shape[0]
    buf = torch.zeros_like(xs)                  # the last stage's outputs
    inflight = torch.zeros_like(xs[0])
    for t in range(n_micro + n_stages - 1):
        x_in = xs[min(t, n_micro - 1)] if sid == 0 else inflight
        y = layer_fn(params, x_in)
        inflight = _hop(y, group, sid, n_stages)
        done = t - (n_stages - 1)
        if sid == n_stages - 1 and done >= 0:
            buf[done] = y
    if sid != n_stages - 1:
        buf = torch.zeros_like(buf)
    return psum(buf, group)
