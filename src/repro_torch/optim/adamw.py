"""AdamW with a warmup-cosine schedule and global-norm clipping, as pure
functions over explicit state.

The port of ``repro.optim.adamw``, over the port's parameter trees
(dicts and lists of tensors, ``repro_torch.tree``).  The moments are
fp32 and the parameters keep their dtype: each update is computed in
fp32 and cast back.  A quotient by a constant divides by a scalar on the
tensor's device (a CUDA division by a host scalar multiplies by its
reciprocal, one bit off the reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..tree import leaves, pick, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar, on the parameters' device
    m: Any
    v: Any


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def init(params) -> OptState:
    """Step 0 and zero fp32 moments shaped like ``params``."""
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """The fp32 learning rate at ``step``: linear warmup to ``peak_lr``,
    then a cosine down to ``min_lr_ratio * peak_lr`` at
    ``total_steps``."""
    step = torch.as_tensor(step)
    warm = step.float() / _scalar(step, max(cfg.warmup_steps, 1))
    prog = (step - cfg.warmup_steps).float() / _scalar(
        step, max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps,
                                     torch.clamp_max(warm, 1.0), cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled by ``min(1, max_norm / norm)``, in their dtypes; the
    fp32 norm).  ``norm``: the global norm when ``grads`` are this rank's
    shards of a tree sharded over a mesh (None: the norm of ``grads``)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp_max(
        _scalar(norm, max_norm) / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _decayable(path) -> bool:
    """Weight decay on matmul weights only (not norms, gates or
    scalars), decided by the leaf's own dict key."""
    name = str(path[-1])
    return not (name.startswith("ln") or name.endswith("ln")
                or name.startswith("mix") or name in
                ("lam", "u", "wlog", "final_ln", "q_norm", "k_norm",
                 "cm_mix"))


def update(cfg: OptimConfig, state: OptState, params, grads, norm=None
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm"}).  The
    gradients are clipped by their global norm first (``norm``, when the
    trees are one rank's shards; see ``clip_by_global_norm``); the bias
    corrections use the new step.  Every other operation is elementwise,
    so it runs on shards as on whole tensors."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(path, p, g, m, v):
        gf = g.float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        upd_ = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if _decayable(path):
            upd_ = upd_ + cfg.weight_decay * p.float()
        p2 = p.float() - lr * upd_
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.m, state.v, with_path=True)
    return pick(out, 0), OptState(step, pick(out, 1), pick(out, 2)), {
        "lr": lr, "grad_norm": gnorm}

