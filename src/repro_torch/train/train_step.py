"""The train step: micro-batched gradient accumulation and AdamW, with
parameters in the model's dtype and fp32 moments.

The port of ``repro.train.train_step`` on one device.  ``train_step`` is
a pure function of (state, batch): autograd differentiates ``loss_fn``
(the plain attention and scan, ``use_kernel=False``, as the reference's
training path) with respect to detached copies of the parameters, so the
state's own tensors never carry a graph.  ``make_train_step``, the step
sharded over a mesh, is ROADMAP Queue 1 item 17b.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import loss_fn
from ..optim import adamw
from ..tree import leaves_with_path, tree_map

#: the ROADMAP item that ports meshes.
MESH_ITEM = "ROADMAP Queue 1 item 17b (launch/sharding.py, meshes)"


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    data_step: torch.Tensor     # the whole data-pipeline state: int32


def init_state(params) -> TrainState:
    dev = next(leaves_with_path(params))[1].device
    return TrainState(params=params, opt=adamw.init(params),
                      data_step=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def _split_micro(batch: Dict[str, torch.Tensor], k: int
                 ) -> List[Dict[str, torch.Tensor]]:
    """``k`` micro-batches of ``batch``, each a ``1/k`` slice of the
    leading axis, in order."""
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def _value_and_grad(cfg: ModelConfig, params, mb: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients in the parameters' dtypes) of
    ``loss_fn`` on one micro-batch; a parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives it."""
    flat = [p for _, p in leaves_with_path(params)]
    live = {id(p): p.detach().requires_grad_(True) for p in flat}
    p2 = tree_map(lambda p: live[id(p)], params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p2, cfg, mb["tokens"], mb["targets"],
                                frames=mb.get("frames"))
        ins = [live[id(p)] for p in flat]
        gs = torch.autograd.grad(loss, ins, allow_unused=True)
    grads = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: grads[id(p)], params))


def train_step(cfg: ModelConfig, ocfg: adamw.OptimConfig,
               microbatches: int, state: TrainState,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: (new state, {"loss", "lr", "grad_norm"}).
    With one micro-batch the gradients come in the parameters' dtypes;
    with several, they are summed into fp32 zeros in micro-batch order
    and divided by their number, as the loss is."""
    if microbatches == 1:
        loss, _, grads = _value_and_grad(cfg, state.params, batch)
    else:
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        state.params)
        dev = state.data_step.device
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in _split_micro(batch, microbatches):
            l, _, g = _value_and_grad(cfg, state.params, mb)
            tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
            lsum = lsum + l
            del g
        k = torch.tensor(float(microbatches), device=dev)
        grads = tree_map(lambda g: g / k, gsum)
        loss = lsum / k
    new_params, new_opt, om = adamw.update(ocfg, state.opt, state.params,
                                           grads)
    return (TrainState(new_params, new_opt, state.data_step + 1),
            {"loss": loss, **om})


def make_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_train_step: {MESH_ITEM}")
