"""Sharding rules: the partition spec of every parameter, batch, activation
and cache, and their placements on a ``DeviceMesh``.

The port of ``repro.launch.sharding``.  Strategy:

* **TP** over ``model``: attention heads, FFN width, MoE experts, vocab.
* **FSDP** over ``data``: the other big dim of every matmul weight (and
  the matching optimizer moments).
* **DP** over ``pod`` (multi-pod): parameters replicated across pods;
  activations shard the batch over ``("pod", "data")``.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim,
``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over those axes, the first major).  It equals the reference's
``jax.sharding.PartitionSpec`` read as a tuple.  Rules are keyed by the
leaf's name.  The port's trees have no stacked-layer axis (one dict per
layer), so a leaf's spec is the reference's without the leading ``None``
that the reference gives leaves under ``layers``/``cross``/``encoder``.

``placements`` turns a spec on a mesh into DTensor placements: a dim
split over several axes is ``Shard(d)`` on each of their mesh dims,
which is the reference's major-to-minor layout only when the axes come
in the mesh's own order (checked; the rules keep it).  DTensor would
shard a dim that does not divide (``torch.chunk``); the reference does
not, so neither does the port: ``placements`` raises.
``distribute_tree`` and ``full_tree`` carry a tree onto a mesh and back.
``TPContext`` is a rank's view of a mesh for the model functions: the
``model`` group its heads, columns, channels, experts and vocab split
over, and each layer's FSDP gather (the sharded steps' partitioning).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..models.layers import TP
from ..tree import tree_map


class PartitionSpec(tuple):
    """``P("data", "model")``: one entry per tensor dim — ``None``, an
    axis name or a tuple of axis names (a tuple of one is its name, as
    JAX normalizes it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh (what ``set_activation_spec`` and ``set_ep_spec``
    take)."""
    mesh: Any
    spec: PartitionSpec


# name -> spec (no stacked-layer dim in the port).
_RULES: Dict[str, P] = {
    # embeddings / head
    "tok": P("model", None),            # vocab sharded
    "head": P(None, "model"),
    # attention
    "wq": P("data", "model"),
    "wk": P("data", "model"),
    "wv": P("data", "model"),
    "wo": P("model", "data"),
    # dense mlp
    "w1": P("data", "model"),
    "w3": P("data", "model"),
    "w2": P("model", "data"),
    # rg-lru
    "w_x": P("data", "model"),
    "w_gate": P("data", "model"),
    "w_a": P("data", "model"),
    "w_i": P("data", "model"),
    "w_out": P("model", "data"),
    "conv_w": P(None, "model"),
    # rwkv
    "w_r": P("data", "model"),
    "w_k": P("data", "model"),
    "w_v": P("data", "model"),
    "w_w": P("data", "model"),
    "w_o": P("model", "data"),
    "cm_k": P("data", "model"),
    "cm_v": P("model", "data"),
    "cm_r": P("data", "model"),
}

#: MoE expert weights: experts over model (EP), d_model over data (FSDP).
_MOE_RULES: Dict[str, P] = {
    "router": P("data", None),
    "w1": P("model", "data", None),
    "w3": P("model", "data", None),
    "w2": P("model", None, "data"),
}


def _path_names(path) -> Tuple[str, ...]:
    """A ``tree`` path as names: a field without its dot, a key or an
    index as a string."""
    return tuple(p[1:] if isinstance(p, str) and p.startswith(".")
                 else str(p) for p in path)


def param_spec(path, leaf) -> P:
    names = _path_names(path)
    name = names[-1]
    # weight-only-quantized leaves {"q": int8, "s": scales}: "q" shards
    # like its parent weight; "s" (the parent's shape less the
    # contraction dim) takes the parent's spec with the -2 axis dropped.
    quant_scale = False
    if name in ("q", "s") and len(names) >= 2:
        quant_scale = name == "s"
        name = names[-2]
    base_ndim = leaf.ndim + (1 if quant_scale else 0)
    in_moe = "ffn" in names and name in _MOE_RULES and (
        base_ndim == len(_MOE_RULES[name]))
    spec = (_MOE_RULES if in_moe else _RULES).get(name)
    if spec is None or len(spec) != base_ndim:
        # norms, gates, scalars, biases: replicate.
        spec = P(*([None] * base_ndim))
    if quant_scale:
        spec = P(*(list(spec)[:-2] + [spec[-1]]))
    return spec


def _remap_fsdp(spec: P) -> P:
    """The small-model mode: ``model`` retires from TP and joins FSDP —
    "model" -> dropped, "data" -> ("data", "model")."""
    return P(*(None if e == "model" else ("data", "model") if e == "data"
               else e for e in spec))


def _remap_serve(spec: P) -> P:
    """Serving layout: TP over ``model``, replicated over ``data``."""
    return P(*(None if e == "data" else e for e in spec))


def param_specs(params, mode: str = "2d") -> Any:
    """A tree of specs shaped like ``params``.  mode: "2d" (TP x FSDP,
    training's default), "serve" (TP only; replicated over data — the
    decode layout) or "fsdp" (DP + FSDP over both axes)."""
    remap = {"2d": None, "fsdp": _remap_fsdp, "serve": _remap_serve}
    if mode not in remap:
        raise ValueError(f"sharding mode {mode!r}: '2d', 'fsdp' or 'serve'")
    fn = remap[mode]
    return tree_map(lambda path, leaf: (param_spec(path, leaf) if fn is None
                                        else fn(param_spec(path, leaf))),
                    params, with_path=True)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def placements(mesh, spec: Sequence, shape: Optional[Sequence[int]] = None
               ) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  A
    dim over several axes is ``Shard(d)`` on each; its axes must come in
    the mesh's order, each axis may shard one dim, and with ``shape``
    each sharded dim must divide by its axes' sizes."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate()] * len(names)
    if shape is not None and len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{len(shape)} dims")
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not one of "
                                 f"the mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} must come in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} shards "
                                 f"two dims")
            out[i] = Shard(d)
        n = math.prod(sizes[a] for a in axes)
        if shape is not None and shape[d] % n:
            raise ValueError(f"spec {spec}: dim {d} of {tuple(shape)} does "
                             f"not divide over {axes} ({n})")
    return tuple(out)


def param_shardings(mesh, params, mode: str = "2d") -> Any:
    """The placements of every leaf of ``params`` on ``mesh`` under
    ``param_specs(params, mode)``."""
    return tree_map(lambda p, s: placements(mesh, s, p.shape), params,
                    param_specs(params, mode))


def distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor under
    ``spec``: each rank keeps its own block, with no communication."""
    return distribute_tensor(t, mesh, placements(mesh, spec, t.shape),
                             src_data_rank=None)


def distribute_tree(mesh, tree, specs) -> Any:
    """Every leaf of ``tree`` distributed under its spec in ``specs`` (a
    tree of ``tree``'s structure)."""
    return tree_map(lambda t, s: distribute(t, mesh, s), tree, specs)


def full(t):
    """A DTensor's whole tensor (gathered over the mesh); anything else
    as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's block on this rank; anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_tree(tree) -> Any:
    """The inverse of ``distribute_tree``: every DTensor leaf gathered."""
    return tree_map(full, tree)


def stand_ins(tree) -> Any:
    """``tree`` with every tensor (a DTensor by its global shape) as a
    ``meta`` tensor of its shape and dtype: a ``like`` tree for
    ``checkpoint.load`` that reads nothing and gathers nothing."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def dp_axes(mesh, mode: str = "2d") -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in ("pod", "data") if a in names)
    if mode == "fsdp":
        axes = axes + ("model",)
    return axes


def batch_spec(mesh, ndim: int = 2, mode: str = "2d") -> P:
    """Token batches: the batch dim over every DP axis, the rest
    replicated."""
    return P(dp_axes(mesh, mode), *([None] * (ndim - 1)))


def act_spec(mesh) -> P:
    """[B, S, D] activations: batch over DP, d_model over model."""
    return P(dp_axes(mesh), None, "model")


def kv_cache_spec(mesh, n_kv_heads: int, stacked: bool = True) -> P:
    """KV caches [L?, B, Hkv, S, hd]: batch over DP; heads over model when
    they divide, else the sequence over model (sequence parallelism).
    The port's caches are per layer: ``stacked=False``."""
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    if n_kv_heads % tp == 0:
        spec = (dp_axes(mesh), "model", None, None)
    else:
        spec = (dp_axes(mesh), None, "model", None)
    return P(None, *spec) if stacked else P(*spec)


def axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes`` (major to minor, in the mesh's
    order): its block of a dim sharded over them."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    r = 0
    for a in sorted(axes, key=names.index):
        r = r * sizes[a] + coord[a]
    return r


def axes_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ only in ``axes``, in
    the order of ``axes_index`` (a collective when several axes are
    flattened the first time: every rank must call it)."""
    axes = tuple(sorted(axes, key=tuple(mesh.mesh_dim_names).index))
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def fsdp_axes(mesh, mode: str = "2d") -> Tuple[str, ...]:
    """The axes a parameter's FSDP dim is sharded over: ``data`` in
    ``"2d"``, ``("data", "model")`` in ``"fsdp"``, none in ``"serve"``."""
    want = {"2d": ("data",), "fsdp": ("data", "model"), "serve": ()}[mode]
    return tuple(a for a in want if a in mesh.mesh_dim_names)


def tp_axes(mesh, mode: str = "2d") -> Tuple[str, ...]:
    """The tensor-parallel axis: ``model``, except in ``"fsdp"`` (which
    retires it into FSDP)."""
    return () if mode == "fsdp" or "model" not in mesh.mesh_dim_names \
        else ("model",)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis ``spec`` shards a dim over."""
    return tuple(a for e in spec for a in _axes(e))


class TPContext(TP):
    """This rank's place on a mesh, for the model functions: the
    ``model`` group (``size`` ranks, this one ``rank``) over which the
    heads, FFN columns, channels, experts and vocab are split, and the
    FSDP group over which ``layer`` gathers a layer's parameters when it
    runs.  A ``models.layers.TP`` with collectives (``launch.
    collectives``).  Built once by a mesh builder, outside any fake mode
    (a group of several axes is made here); every rank builds it."""

    def __init__(self, mesh, mode: str = "2d"):
        from . import collectives as C
        self._C = C
        tp = tp_axes(mesh, mode)
        self.group = axes_group(mesh, tp)
        self.size, self.rank = axes_size(mesh, tp), axes_index(mesh, tp)
        fs = fsdp_axes(mesh, mode)
        self.fsdp_group = axes_group(mesh, fs)
        self.fsdp_size = axes_size(mesh, fs)
        self._remap = {"2d": None, "fsdp": _remap_fsdp,
                       "serve": _remap_serve}[mode]

    def copy(self, x):
        return self._C.copy_to(x, self.group)

    def reduce(self, x):
        return self._C.reduce_from(x, self.group)

    def gather_cols(self, x):
        return self._C.gather_cols(x, self.group)

    def gather_rs(self, x, dim: int = -1):
        return self._C.gather_dim(x, dim, self.group)

    def pmax(self, x):
        return self._C.pmax(x, self.group)

    def layer(self, p):
        """``p`` (a layer's parameters, this rank's shards) with each
        leaf's FSDP dim gathered over the FSDP group, differentiably (the
        backward reduce-scatters the gradient onto the shards); ``p``
        itself when nothing is sharded over it."""
        if self.fsdp_size == 1:
            return p

        def gather(path, t):
            spec = param_spec(path, t)
            if self._remap is not None:
                spec = self._remap(spec)
            for d, e in enumerate(spec):
                if "data" in _axes(e):
                    return self._C.gather_dim(t, d, self.fsdp_group)
            return t

        return tree_map(gather, p, with_path=True)
