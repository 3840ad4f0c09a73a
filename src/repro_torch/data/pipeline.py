"""Deterministic synthetic data pipeline, resumable from one integer.

The port of ``repro.data.pipeline``: the pipeline is a pure function of
(seed, step), so the whole data-loader state is ``data_step`` and a
restarted run consumes the same token stream bit for bit.  The draw is
numpy's Philox, exactly as the reference's, so both packages give the
same batches; the port hands them over as int32 tensors on its device.
Sharding a batch over a mesh, and ``filtered_batch`` (a SELECT pushed
down to the shards as a data-plane operator), wait for meshes: ROADMAP
Queue 1 item 17b.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

#: the ROADMAP item that ports meshes.
MESH_ITEM = "ROADMAP Queue 1 item 17b (launch/sharding.py, meshes)"


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
    the caller names another)."""

    def __init__(self, cfg: DataConfig, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(f"SyntheticPipeline(mesh=...): "
                                      f"{MESH_ITEM}")
        self.cfg = cfg
        self.device = resolve_device(device)

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
        None)."""
        dev = self.device if device is None else resolve_device(device)
        raw = torch.from_numpy(self._raw(int(step))).to(dev)
        return {"tokens": raw[:, :-1].contiguous(),
                "targets": raw[:, 1:].contiguous()}


def filtered_batch(mesh, axis: str, table, x: float, y: float,
                   capacity: int):
    raise NotImplementedError(f"filtered_batch: {MESH_ITEM}")
