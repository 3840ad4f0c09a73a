"""The train step: micro-batched gradient accumulation and AdamW, with
parameters in the model's dtype and fp32 moments.

The port of ``repro.train.train_step``.  ``train_step`` is a pure
function of (state, batch): autograd differentiates ``loss_fn`` (the
plain attention and scan, ``use_kernel=False``, as the reference's
training path) with respect to detached copies of the parameters, so the
state's own tensors never carry a graph.  ``make_train_step`` is the
step sharded over a mesh (``launch.sharding``), partitioned as the
reference's rules partition it: the parameters and moments are
DTensors; the loss runs on this rank's shards and this rank's rows of
each micro-batch (``launch.sharding.TPContext``: tensor parallelism over
``model``, each layer's FSDP shards gathered when it runs, whose
backward reduce-scatters the gradients), the gradients are summed over
the data-parallel axes that do not shard them and divided by the
data-parallel size, and AdamW runs on the local shards.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import loss_fn
from ..optim import adamw
from ..tree import leaves, leaves_with_path, tree_map


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


def _value_and_grad(cfg: ModelConfig, params, mb: Dict[str, torch.Tensor],
                    moe_group=None, tp=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients in the parameters' dtypes) of
    ``loss_fn`` on one micro-batch; a parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives it.  ``moe_group``, ``tp``: see
    ``loss_fn``."""
    flat = [p for _, p in leaves_with_path(params)]
    live = {id(p): p.detach().requires_grad_(True) for p in flat}
    p2 = tree_map(lambda p: live[id(p)], params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p2, cfg, mb["tokens"], mb["targets"],
                                frames=mb.get("frames"),
                                moe_group=moe_group, tp=tp)
        ins = [live[id(p)] for p in flat]
        gs = torch.autograd.grad(loss, ins, allow_unused=True)
    grads = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: grads[id(p)], params))


def _loss_and_grads(cfg: ModelConfig, params, mbs, moe_group=None,
                    tp=None) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients) over the micro-batches ``mbs``.  With one the
    gradients come in the parameters' dtypes; with several, they are
    summed into fp32 zeros in micro-batch order and divided by their
    number, as the loss is."""
    if len(mbs) == 1:
        loss, _, grads = _value_and_grad(cfg, params, mbs[0], moe_group, tp)
        return loss, grads
    dev = leaves(params)[0].device
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in mbs:
        l, _, g = _value_and_grad(cfg, params, mb, moe_group, tp)
        tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
        lsum = lsum + l
        del g
    k = torch.tensor(float(len(mbs)), device=dev)
    return lsum / k, tree_map(lambda g: g / k, gsum)


def train_step(cfg: ModelConfig, ocfg: adamw.OptimConfig,
               microbatches: int, state: TrainState,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: (new state, {"loss", "lr", "grad_norm"})."""
    loss, grads = _loss_and_grads(
        cfg, state.params, [batch] if microbatches == 1
        else _split_micro(batch, microbatches))
    new_params, new_opt, om = adamw.update(ocfg, state.opt, state.params,
                                           grads)
    return (TrainState(new_params, new_opt, state.data_step + 1),
            {"loss": loss, **om})


def make_train_step(cfg: ModelConfig, ocfg: adamw.OptimConfig, mesh,
                    params_like, microbatches: int = 1, donate: bool = True,
                    sharding_mode: str = "2d"):
    """The train step sharded over ``mesh``: ``step(state, batch) ->
    (state, {"loss", "lr", "grad_norm"})``, computing what ``train_step``
    computes on the global batch.

    The state's params and moments come out as DTensors under
    ``param_specs(params_like, sharding_mode)`` (``"2d"``: TP x FSDP;
    ``"fsdp"``: DP + FSDP over both axes), ``step`` and ``data_step``
    replicated; a plain tensor given in their place is distributed first.
    ``batch`` holds the global batch: DTensors (``SyntheticPipeline(mesh=
    ...)``) or whole tensors.  The metrics are plain tensors, the same on
    every rank.  ``donate`` is accepted and ignored: nothing here aliases
    the input state.

    The global batch splits into micro-batches first, and each
    micro-batch then over the data-parallel ranks, as in the reference
    (a rank's own rows split otherwise would give other micro-batches,
    which a MoE's per-micro-batch capacity would see); with one
    micro-batch a rank's rows are its block of the batch, with several
    the (token) batch is gathered to cut them.  The loss runs on this
    rank's shards of the parameters (``TPContext(mesh, sharding_mode)``:
    the ``model`` axis splits heads, FFN columns, channels, experts and
    vocab in ``"2d"``, none in ``"fsdp"``; each layer gathers its FSDP
    shards when it runs, and their backward reduce-scatters its
    gradients).  A MoE layer routes every data-parallel rank's tokens of
    the micro-batch as one batch (``moe_block_global``).  A gradient is
    then summed over the data-parallel axes that do not shard its leaf
    and divided by their size: the mean of the ranks' gradients, right
    because their shards are of equal size, as the loss is the mean of
    the ranks' means.  A leaf that ``model`` replicates gets its whole
    gradient on every rank of ``model`` (the tensor-parallel ops sum the
    partial cotangents), as GSPMD gives it.  The gradient norm sums each
    distinct shard once: a rank counts a leaf only where its coordinate
    is 0 on every mesh axis that replicates the leaf.  Every collective
    of a mesh of one device is a copy, so there this step equals
    ``train_step`` bit for bit."""
    from torch.distributed.tensor import DTensor

    from ..launch import sharding as sh
    from ..launch.collectives import pmean, psum
    from ..launch.mesh import mesh_device
    from ..models import moe as moe_mod
    from ..models import transformer as tr
    dp = sh.dp_axes(mesh, sharding_mode)
    tr.set_activation_spec(sh.NamedSharding(mesh, sh.P(dp, None, None)))
    moe_mod.set_ep_spec(sh.NamedSharding(mesh, sh.P(
        None, ("data", "model"), None) if sharding_mode == "fsdp"
        else sh.P("model", None, None)))
    pspecs = sh.param_specs(params_like, sharding_mode)
    sh.param_shardings(mesh, params_like, sharding_mode)   # every dim divides
    names = tuple(mesh.mesh_dim_names)
    n_dp, r_dp = sh.axes_size(mesh, dp), sh.axes_index(mesh, dp)
    dp_group = sh.axes_group(mesh, dp)
    all_group = sh.axes_group(mesh, names)
    moe_group = dp_group if cfg.moe is not None and n_dp > 1 else None
    tp = sh.TPContext(mesh, sharding_mode)
    dev = mesh_device(mesh)
    coord = mesh.get_coordinate()
    # the leaves whose shard this rank counts in the global norm.
    owned = [all(isinstance(q, sh.Shard) or c == 0 for q, c in zip(
        sh.placements(mesh, s, p.shape), coord))
        for p, s in zip(leaves(params_like), leaves(pspecs))]
    # the data-parallel axes each leaf's gradient is summed over (those
    # its FSDP gather did not already reduce-scatter it over), and their
    # groups, made here: every rank makes them in the same order.
    sum_axes = tree_map(lambda s: sh.P(*(
        a for a in dp if a not in sh.spec_axes(s))), pspecs)
    groups = {a: sh.axes_group(mesh, a)
              for a in sorted(set(leaves(sum_axes)))}
    batch_pl = {}

    def as_dtensor(t, spec):
        return t if isinstance(t, DTensor) else \
            sh.distribute(t.to(dev), mesh, spec)

    def wrap(local, like):
        return DTensor.from_local(local, mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def reduce_grad(g, axes):
        """This rank's gradient summed over ``axes``, divided by the
        data-parallel size."""
        g = psum(g, groups[axes]) if axes else g
        return g if n_dp == 1 else g / torch.tensor(
            float(n_dp), dtype=g.dtype, device=g.device)

    def rows(x, B: int, b: int):
        """This rank's rows of each micro-batch of ``x`` [B, ...],
        concatenated: its block of the data-parallel split with one
        micro-batch, else cut from the gathered batch."""
        if isinstance(x, DTensor):
            if microbatches == 1:
                if x.ndim not in batch_pl:
                    batch_pl[x.ndim] = sh.placements(mesh, sh.batch_spec(
                        mesh, x.ndim, sharding_mode))
                return x.redistribute(mesh, batch_pl[x.ndim]).to_local(
                    ).to(dev)
            x = x.redistribute(mesh, [sh.Replicate()] * len(names)
                               ).to_local()
        x = x.to(dev)
        return torch.cat([x[i * (B // microbatches) + r_dp * b:][:b]
                          for i in range(microbatches)])

    def step(state: TrainState, batch: Dict[str, Any]):
        params = tree_map(as_dtensor, state.params, pspecs)
        m = tree_map(as_dtensor, state.opt.m, pspecs)
        v = tree_map(as_dtensor, state.opt.v, pspecs)
        local = tree_map(sh.local, params)
        B = batch["tokens"].shape[0]
        if B % (microbatches * n_dp):
            raise ValueError(f"make_train_step: a global batch of {B} does "
                             f"not split into {microbatches} micro-batches "
                             f"over {n_dp} data-parallel ranks")
        b = B // microbatches // n_dp
        mine = {k: rows(x, B, b) for k, x in batch.items()}
        loss, grads = _loss_and_grads(
            cfg, local, [{k: x[i * b:(i + 1) * b] for k, x in mine.items()}
                         for i in range(microbatches)], moe_group, tp)
        loss = pmean(loss, dp_group)
        grads = tree_map(reduce_grad, grads, sum_axes)
        sq = sum((torch.sum(torch.square(g.float()))
                  for g, own in zip(leaves(grads), owned) if own),
                 torch.zeros((), dtype=torch.float32, device=dev))
        norm = torch.sqrt(psum(sq, all_group))
        opt = adamw.OptState(sh.local(state.opt.step).to(dev),
                             tree_map(sh.local, m), tree_map(sh.local, v))
        new_p, new_opt, om = adamw.update(ocfg, opt, local, grads,
                                          norm=norm)
        out = TrainState(
            params=tree_map(wrap, new_p, params),
            opt=adamw.OptState(
                step=sh.distribute(new_opt.step, mesh, sh.P()),
                m=tree_map(wrap, new_opt.m, m),
                v=tree_map(wrap, new_opt.v, v)),
            data_step=sh.distribute(sh.local(state.data_step).to(dev) + 1,
                                    mesh, sh.P()))
        return out, {"loss": loss, **om}

    return step
