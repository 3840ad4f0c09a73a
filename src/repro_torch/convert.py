"""Carry engine state and counters between ``repro`` and the port.

``repro``'s ``EngineMNState``, two-node ``EngineState`` and ``Counters``,
given as pytrees of numpy arrays (``jax.tree_util.tree_map(np.asarray,
x)``), become the port's tensors on a device, and back.  Nothing here
imports ``repro``: the reference trees are read by their field names,
which the port's NamedTuples share.  Two representations differ:

* the counters' accumulators: the reference keeps hi/lo int32 pairs
  (``occ_sum_hi``/``occ_sum_lo``, ``mshr_sum_hi``/``mshr_sum_lo``), the
  port one int64 each;
* the packed directory words (``dir.view`` and ``hreq_pending`` of a
  packed state): uint32 in the reference, int32 with the same bits in the
  port — ``.view(np.int32)`` on the way in, ``.view(np.uint32)`` on the
  way out.  Dense states keep their int8 planes.

    st_t = engine_state_to_torch(np_state, "cpu")     # port state
    flat = flatten(engine_state_to_numpy(st_t))       # path -> array

The near-memory operators' data crosses the same way: a reference
``KVStore`` or ``ShardedKVS`` (numpy leaves) becomes the port's, its uint32
keys int32 with the same bits, and a reference ``DFA`` becomes the port's
transition and accept tensors.

Model parameters and decode states cross by layer: the reference stacks
each slot of the superlayer pattern over superlayers (``params["layers"]
["slot{j}"]`` with a leading ``[n_super]`` axis, then ``params["tail"]
["tail{j}"]``), the port keeps one dict per layer in layer order
(``model_params_to_torch``, ``decode_state_to_torch``,
``decode_state_to_numpy``); the encoder's stacked layers and the stacked
cross-attention likewise become lists, and the reference's stacked
cross K/V a list of (k, v) pairs (``cross_kv_to_torch``).  The way back
restacks them (``stack_model_params``, ``model_params_to_numpy``), and a
whole ``TrainState`` — params and AdamW's two moments, ``step`` and
``data_step`` — crosses both ways (``train_state_to_torch``,
``train_state_to_numpy``; ``stack_train_state`` keeps tensors, in their
dtype and on their device, for the checkpoint).  A bfloat16 leaf crosses
to numpy through float32, exactly.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .core.agent import AgentState
from .core.directory import DirectoryState
from .core.directory_mn import DirectoryMNState
from .core.engine import EngineState
from .core.engine_mn import EngineMNState
from .core.pushdown import ShardedKVS
from .core.transport import Channel
from .device import resolve_device
from .nmp.dfa import dfa_tables
from .nmp.kvstore import KVStore, as_records
from .traffic.counters import Counters
from .tree import tree_map

#: the reference's hi/lo accumulator split (``repro.traffic.counters``).
ACC_SHIFT = 30
ACC_MASK = (1 << ACC_SHIFT) - 1

#: the nested fields of each engine's state: N-remote and two-node.
_NESTED = {
    EngineMNState: {"dir": DirectoryMNState, "agents": AgentState,
                    "ch_req": Channel, "ch_resp": Channel,
                    "ch_hreq": Channel, "ch_hresp": Channel},
    EngineState: {"dir": DirectoryState, "agent": AgentState,
                  "ch_req": Channel, "ch_resp": Channel, "ch_hreq": Channel,
                  "ch_hresp": Channel},
}


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype == np.uint32:           # packed words: same bits as int32
        x = x.view(np.int32)
    return torch.as_tensor(x).to(device)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _state_type(st):
    """The port's state type for a state of either engine (a two-node
    state has one ``agent``, an N-remote state ``agents``)."""
    return EngineState if hasattr(st, "agent") else EngineMNState


def engine_state_to_torch(st, device=None):
    """A reference ``EngineMNState`` (numpy leaves, dense or packed) or
    two-node ``EngineState`` as the port's state on ``device``, dtype for
    dtype but uint32 words as int32."""
    dev = resolve_device(device)
    top = _state_type(st)
    fields = {}
    for name in top._fields:
        src = getattr(st, name)
        cls = _NESTED[top].get(name)
        fields[name] = (
            cls(*(_to_tensor(getattr(src, f), dev) for f in cls._fields))
            if cls is not None else _to_tensor(src, dev))
    return top(**fields)


def engine_state_to_numpy(st):
    """The port's state of either engine with numpy leaves (the
    reference's field names and dtypes: a packed state's int32 words come
    back as uint32)."""
    top = _state_type(st)
    fields = {}
    for name in top._fields:
        src = getattr(st, name)
        cls = _NESTED[top].get(name)
        fields[name] = (cls(*(_to_numpy(x) for x in src))
                        if cls is not None else _to_numpy(src))
    if fields["hreq_pending"].dtype == np.int32:          # packed layout
        fields["hreq_pending"] = fields["hreq_pending"].view(np.uint32)
        fields["dir"] = fields["dir"]._replace(
            view=fields["dir"].view.view(np.uint32))
    return top(**fields)


def counters_to_torch(ctr, device=None) -> Counters:
    """Reference ``Counters`` (numpy leaves, hi/lo pairs) as the port's
    ``Counters`` (int64 accumulators) on ``device``."""
    dev = resolve_device(device)

    def total(hi, lo):
        return (np.asarray(hi, np.int64) << ACC_SHIFT) + \
            np.asarray(lo, np.int64)

    return Counters(
        lat_hist=_to_tensor(ctr.lat_hist, dev),
        max_wait=_to_tensor(ctr.max_wait, dev),
        retired=_to_tensor(ctr.retired, dev),
        occ_sum=_to_tensor(total(ctr.occ_sum_hi, ctr.occ_sum_lo), dev),
        occ_peak=_to_tensor(ctr.occ_peak, dev),
        mshr_sum=_to_tensor(total(ctr.mshr_sum_hi, ctr.mshr_sum_lo), dev),
        mshr_peak=_to_tensor(ctr.mshr_peak, dev),
        steps=_to_tensor(ctr.steps, dev),
        active_steps=_to_tensor(ctr.active_steps, dev),
    )


def counters_to_reference(ctr: Counters) -> Dict[str, np.ndarray]:
    """The port's ``Counters`` in the reference's field names and dtypes
    (int32 hi/lo pairs for the accumulators)."""
    out = {}
    for name in Counters._fields:
        v = _to_numpy(getattr(ctr, name))
        if name in ("occ_sum", "mshr_sum"):
            v = np.asarray(v, np.int64)
            out[f"{name}_hi"] = (v >> ACC_SHIFT).astype(np.int32)
            out[f"{name}_lo"] = (v & ACC_MASK).astype(np.int32)
        else:
            out[name] = v
    return out


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"dir.view": array, ...}`` over any NamedTuple tree (the
    reference's or the port's), leaves as numpy arrays — the leaf-by-leaf
    form the tests compare."""
    out = {}
    for name in tree._fields:
        v = getattr(tree, name)
        path = f"{prefix}{name}"
        if hasattr(v, "_fields"):
            out.update(flatten(v, path + "."))
        else:
            out[path] = _to_numpy(v)
    return out


def kvstore_to_torch(kvs, device=None) -> KVStore:
    """A reference ``KVStore`` (numpy leaves) as the port's on
    ``device``: keys int32 with the uint32 bits, keys and nxt as
    records."""
    dev = resolve_device(device)
    t = {f: _to_tensor(getattr(kvs, f), dev) for f in KVStore._fields}
    t["keys"], t["nxt"] = as_records(t["keys"], t["nxt"])
    return KVStore(**t)


def sharded_kvs_to_torch(skvs, device=None) -> ShardedKVS:
    """A reference ``ShardedKVS`` (numpy leaves) as the port's on
    ``device``, keys and nxt as records."""
    dev = resolve_device(device)
    t = {f: _to_tensor(getattr(skvs, f), dev)
         for f in ShardedKVS._fields[:-1]}
    t["keys"], t["nxt"] = as_records(t["keys"], t["nxt"])
    return ShardedKVS(**t, n_buckets=int(skvs.n_buckets))


def kvs_to_numpy(kvs) -> Dict[str, np.ndarray]:
    """A port ``KVStore`` or ``ShardedKVS`` as numpy arrays in the
    reference's dtypes (keys back to uint32), by field name."""
    out = {f: _to_numpy(getattr(kvs, f)) for f in kvs._fields
           if f != "n_buckets"}
    out["keys"] = out["keys"].view(np.uint32)
    return out


def dfa_to_torch(dfa, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(transitions [n_states, 256] int32, accept [n_states] bool) of a
    reference ``DFA`` on ``device`` — what ``kernels.ops.regex_match``
    takes."""
    return dfa_tables(dfa, resolve_device(device))


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no torch buffer
        return torch.as_tensor(a.astype(np.float32)).to(device,
                                                        torch.bfloat16)
    return _to_tensor(a, device)


def _take(t, li, device: torch.device):
    """A (nested dict of) stacked leaf, sliced at ``li`` (all of it if
    None), as tensors on ``device``."""
    if isinstance(t, dict):
        return {k: _take(v, li, device) for k, v in t.items()}
    return _leaf_to_torch(np.asarray(t) if li is None
                          else np.asarray(t)[li], device)


def _unstack(tree, n: int, device: torch.device) -> list:
    """A tree stacked over a leading axis of ``n`` as ``n`` trees."""
    return [_take(tree, li, device) for li in range(n)]


def _by_layer(tree, cfg, device: torch.device) -> list:
    """The reference's stacked ``{"slot{j}": ..., "tail": {"tail{j}":
    ...}}`` tree as one dict of tensors per layer, in layer order."""
    out = [_take(tree[f"slot{j}"], li, device)
           for li in range(cfg.n_superlayers)
           for j in range(len(cfg.block_pattern))]
    out += [_take(tree["tail"][f"tail{j}"], None, device)
            for j in range(len(cfg.tail_pattern))]
    return out


def model_params_to_torch(np_params, cfg, device=None) -> dict:
    """The reference's parameter pytree (numpy leaves, from
    ``repro.models.init_params``, dense or quantized) as the port's
    ``{"embed": {...}, "layers": [...]}`` (with ``"encoder"`` and
    ``"cross"`` for an encoder-decoder) on ``device``
    (``models.transformer.init_params``'s layout)."""
    dev = resolve_device(device)
    tree = dict(np_params["layers"])
    if cfg.tail_pattern:
        tree["tail"] = np_params["tail"]
    out = {"embed": _take(np_params["embed"], None, dev),
           "layers": _by_layer(tree, cfg, dev)}
    if cfg.encoder is not None:
        enc = np_params["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["layers"], cfg.encoder.n_layers, dev),
            "final_ln": _leaf_to_torch(enc["final_ln"], dev)}
        out["cross"] = _unstack(np_params["cross"], cfg.n_superlayers, dev)
    return out


def cross_kv_to_torch(np_cross, device=None) -> list:
    """The reference's cross K/V (``transformer._cross_kv``: a pair of
    ``[n_super, B, Hkv, T, hd]`` arrays) as the port's list of one (k, v)
    a superlayer (``models.transformer.cross_kv``'s form)."""
    dev = resolve_device(device)
    k, v = (np.asarray(a) for a in np_cross)
    return [(_leaf_to_torch(k[i], dev), _leaf_to_torch(v[i], dev))
            for i in range(k.shape[0])]


def decode_state_to_torch(np_state, cfg, device=None) -> list:
    """The reference's decode state (``repro.models.init_decode_state``'s
    layout, numpy leaves) as the port's list of per-layer states."""
    return _by_layer(np_state, cfg, resolve_device(device))


def decode_state_to_numpy(state, cfg) -> dict:
    """The port's per-layer decode state in the reference's stacked layout
    (numpy leaves; bfloat16 as float32)."""
    def np_of(t):
        return _to_numpy(t.float() if t.dtype == torch.bfloat16 else t)

    P = len(cfg.block_pattern)
    out = {f"slot{j}": {k: np.stack([np_of(state[li * P + j][k])
                                     for li in range(cfg.n_superlayers)])
                        for k in state[j]}
           for j in range(P)}
    base = cfg.n_superlayers * P
    if cfg.tail_pattern:
        out["tail"] = {f"tail{j}": {k: np_of(v)
                                    for k, v in state[base + j].items()}
                       for j in range(len(cfg.tail_pattern))}
    return out


def _stack_trees(trees: list):
    """A list of trees of one structure as one tree of stacked leaves
    (``torch.stack`` over a new leading axis)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _slice_tree(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


def stack_model_params(params, cfg) -> dict:
    """The port's per-layer parameter tree (or a tree of its structure:
    AdamW's moments) in the reference's stacked layout, as tensors on
    their device in their dtype: ``layers/slot{j}`` stacked over the
    superlayers, ``tail/tail{j}``, the encoder's layers and ``cross``
    stacked.  The inverse of ``unstack_model_params``."""
    P, n = len(cfg.block_pattern), cfg.n_superlayers
    lay = params["layers"]
    out = {"embed": params["embed"],
           "layers": {f"slot{j}": _stack_trees([lay[li * P + j]
                                                for li in range(n)])
                      for j in range(P)}}
    if cfg.tail_pattern:
        out["tail"] = {f"tail{j}": lay[n * P + j]
                       for j in range(len(cfg.tail_pattern))}
    if cfg.encoder is not None:
        out["encoder"] = {
            "layers": _stack_trees(params["encoder"]["layers"]),
            "final_ln": params["encoder"]["final_ln"]}
        out["cross"] = _stack_trees(params["cross"])
    return out


def unstack_model_params(stacked, cfg) -> dict:
    """The reference's stacked layout (tensors) as the port's per-layer
    tree; each layer's leaves are views of the stacked tensors."""
    P, n = len(cfg.block_pattern), cfg.n_superlayers
    lay = stacked["layers"]
    out = {"embed": stacked["embed"],
           "layers": [_slice_tree(lay[f"slot{j}"], li)
                      for li in range(n) for j in range(P)]}
    out["layers"] += [stacked["tail"][f"tail{j}"]
                      for j in range(len(cfg.tail_pattern))]
    if cfg.encoder is not None:
        enc = stacked["encoder"]
        out["encoder"] = {
            "layers": [_slice_tree(enc["layers"], li)
                       for li in range(cfg.encoder.n_layers)],
            "final_ln": enc["final_ln"]}
        out["cross"] = [_slice_tree(stacked["cross"], li)
                        for li in range(n)]
    return out


def _np_leaf(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bfloat16 as float32, exactly."""
    return _to_numpy(t.float() if t.dtype == torch.bfloat16 else t)


def model_params_to_numpy(params, cfg) -> dict:
    """The port's parameters in the reference's stacked layout with numpy
    leaves (bfloat16 as float32): the inverse of
    ``model_params_to_torch``."""
    return tree_map(_np_leaf, stack_model_params(params, cfg))


def stack_train_state(state, cfg):
    """A port ``TrainState`` in the reference's stacked layout (params
    and both moments), tensors on their device: what the ``Trainer``
    checkpoints, so that ``repro.checkpoint.load`` restores it."""
    from .optim.adamw import OptState
    return type(state)(
        params=stack_model_params(state.params, cfg),
        opt=OptState(step=state.opt.step,
                     m=stack_model_params(state.opt.m, cfg),
                     v=stack_model_params(state.opt.v, cfg)),
        data_step=state.data_step)


def unstack_train_state(stacked, cfg):
    """The inverse of ``stack_train_state``: a port ``TrainState``."""
    from .optim.adamw import OptState
    from .train.train_step import TrainState
    return TrainState(
        params=unstack_model_params(stacked.params, cfg),
        opt=OptState(step=stacked.opt.step,
                     m=unstack_model_params(stacked.opt.m, cfg),
                     v=unstack_model_params(stacked.opt.v, cfg)),
        data_step=stacked.data_step)


def train_state_to_numpy(state, cfg):
    """A port ``TrainState`` as the reference's: the stacked layout with
    numpy leaves (bfloat16 as float32; ``step`` and ``data_step`` int32
    scalars), in a ``TrainState`` whose fields the reference's shares."""
    return tree_map(_np_leaf, stack_train_state(state, cfg))


def train_state_to_torch(np_state, cfg, device=None):
    """The reference's ``TrainState`` (numpy leaves, read by field name)
    as the port's on ``device``: params and both moments per layer,
    ``step`` and ``data_step`` int32 scalars."""
    from .optim.adamw import OptState
    from .train.train_step import TrainState
    dev = resolve_device(device)
    opt = np_state.opt
    return TrainState(
        params=model_params_to_torch(np_state.params, cfg, dev),
        opt=OptState(step=_leaf_to_torch(opt.step, dev).to(torch.int32),
                     m=model_params_to_torch(opt.m, cfg, dev),
                     v=model_params_to_torch(opt.v, cfg, dev)),
        data_step=_leaf_to_torch(np_state.data_step, dev).to(torch.int32))
