"""Shape stand-ins for every model input: tensors on the ``meta`` device,
which carry a shape and a dtype and allocate nothing.

The port of ``repro.launch.specs`` (whose ``ShapeDtypeStruct``s these
are).  The trees are the port's (one dict or state per layer); the
parameters come from ``init_params`` on ``meta``, where ``randn`` draws
nothing from the generator.  ``input_specs(cfg, cell)`` is everything a
cell's step function takes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeCell
from ..models import init_decode_state, init_params
from ..models.config import ModelConfig
from ..optim import adamw
from ..train.train_step import TrainState
from ..tree import tree_map

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def params_specs(cfg: ModelConfig) -> Any:
    return init_params(cfg, generator=torch.Generator(), device=META)


def train_state_specs(cfg: ModelConfig) -> TrainState:
    p = params_specs(cfg)
    f32 = lambda t: tree_map(lambda s: _sds(s.shape, torch.float32), t)
    return TrainState(
        params=p,
        opt=adamw.OptState(step=_sds((), torch.int32), m=f32(p), v=f32(p)),
        data_step=_sds((), torch.int32))


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, S = cell.global_batch, cell.seq_len
    out = {"tokens": _sds((B, S), torch.int32),
           "targets": _sds((B, S), torch.int32)}
    if cfg.encoder is not None:
        out["frames"] = _sds((B, cfg.encoder.n_frames, cfg.d_model),
                             torch.bfloat16 if cfg.dtype == "bfloat16"
                             else torch.float32)
    return out


def decode_state_sds(cfg: ModelConfig, batch: int, max_seq: int) -> Any:
    return init_decode_state(cfg, batch, max_seq, META)


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell
                       ) -> Tuple[Any, Any, Any, Any]:
    """(params, token, index, state) stand-ins for a serve step."""
    B = cell.global_batch
    return (params_specs(cfg), _sds((B,), torch.int32),
            _sds((), torch.int32), decode_state_sds(cfg, B, cell.seq_len))


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Everything the cell's step function takes, as stand-ins."""
    if cell.kind == "train":
        return {"state": train_state_specs(cfg),
                "batch": batch_specs(cfg, cell)}
    if cell.kind == "prefill":
        b = batch_specs(cfg, cell)
        b.pop("targets")
        return {"params": params_specs(cfg), "batch": b}
    if cell.kind == "decode":
        p, tok, idx, st = decode_input_specs(cfg, cell)
        return {"params": p, "token": tok, "index": idx, "state": st}
    raise ValueError(cell.kind)
