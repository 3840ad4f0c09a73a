"""Deterministic synthetic data pipeline, resumable from one integer.

The port of ``repro.data.pipeline``: the pipeline is a pure function of
(seed, step), so the whole data-loader state is ``data_step`` and a
restarted run consumes the same token stream bit for bit.  The draw is
numpy's Philox, exactly as the reference's, so both packages give the
same batches; the port hands them over as int32 tensors on its device.
On a mesh every rank draws the same batch and keeps its rows under
``batch_spec``: a DTensor whose blocks are the reference's shards, bit
for bit.  ``filtered_batch`` pushes a SELECT down to the shards that
hold the rows, as a data-plane operator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticPipeline:
    """Markov-ish synthetic token stream (not uniform noise, so loss curves
    mean something: with p=0.5 token t+1 is ``(7 * token t + 3) mod
    vocab``, else fresh).  Batches land on ``device`` (the card unless
    the caller names another); with a ``mesh``, on this rank's device of
    the mesh as DTensors with the batch over the data-parallel axes."""

    def __init__(self, cfg: DataConfig, mesh=None, device=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..launch.mesh import mesh_device
            self.device = mesh_device(mesh)
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(f"SyntheticPipeline: device {device} "
                                 f"against a {self.device.type} mesh")

    def _raw(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, 0, step]))
        noise = rng.integers(0, c.vocab, (c.global_batch, c.seq_len + 1),
                             dtype=np.int64)
        mixed = noise.copy()
        reuse = rng.random((c.global_batch, c.seq_len + 1)) < 0.5
        for t in range(1, c.seq_len + 1):
            mixed[:, t] = np.where(reuse[:, t],
                                   (mixed[:, t - 1] * 7 + 3) % c.vocab,
                                   noise[:, t])
        return mixed.astype(np.int32)

    def batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """{"tokens", "targets"}: int32 [global_batch, seq_len], the
        targets shifted by one token, on ``device`` (the pipeline's if
        None); on a mesh, DTensors under ``batch_spec(mesh)``."""
        dev = self.device if device is None else resolve_device(device)
        raw = torch.from_numpy(self._raw(int(step))).to(dev)
        out = {"tokens": raw[:, :-1].contiguous(),
               "targets": raw[:, 1:].contiguous()}
        if self.mesh is not None:
            from ..launch.sharding import batch_spec, distribute
            spec = batch_spec(self.mesh)
            out = {k: distribute(v, self.mesh, spec) for k, v in out.items()}
        return out


def filtered_batch(mesh, axis: str, table, x: float, y: float,
                   capacity: int):
    """The SELECT pushed down as a data-plane operator, SPMD over the
    mesh axis ``axis``: rank ``s`` of the axis takes the ``s``-th
    contiguous block of ``table``'s rows (the whole table on every rank,
    or a DTensor), runs ``core.pushdown.select_shard`` on it (one
    ``select_scan`` launch on the card), and the stitched matches and
    counts of every rank are all-gathered: a ``PushdownResult`` equal to
    ``pushdown_select`` over the same shards, on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ..core.pushdown import PushdownResult, select_shard
    from ..launch.collectives import gather_stack
    from ..launch.mesh import mesh_device
    group = mesh.get_group(axis)
    n_shards, s = dist.get_world_size(group), dist.get_rank(group)
    if isinstance(table, DTensor):
        table = table.full_tensor()
    n = table.shape[0]
    if n % n_shards:
        raise ValueError(f"filtered_batch: {n} rows do not split over "
                         f"{n_shards} shards")
    per = n // n_shards
    tbl = table[s * per:(s + 1) * per].to(mesh_device(mesh))
    rows, count = select_shard(tbl, capacity, x, y)
    counts = gather_stack(count, group)
    return PushdownResult(gather_stack(rows, group), counts,
                          counts.sum(dtype=torch.int32))
