"""Carry engine state and counters between ``repro`` and the port.

``repro``'s ``EngineMNState`` and ``Counters``, given as pytrees of numpy
arrays (``jax.tree_util.tree_map(np.asarray, x)``), become the port's
tensors on a device, and back.  Nothing here imports ``repro``: the
reference trees are read by their field names, which the port's
NamedTuples share.  The one difference is the counters' accumulators:
the reference keeps hi/lo int32 pairs (``occ_sum_hi``/``occ_sum_lo``,
``mshr_sum_hi``/``mshr_sum_lo``), the port one int64 each.

    st_t = engine_state_to_torch(np_state, "cpu")     # port state
    flat = flatten(engine_state_to_numpy(st_t))       # path -> array
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.agent import AgentState
from .core.directory_mn import DirectoryMNState
from .core.engine_mn import EngineMNState
from .core.transport import Channel
from .device import resolve_device
from .traffic.counters import Counters

#: the reference's hi/lo accumulator split (``repro.traffic.counters``).
ACC_SHIFT = 30
ACC_MASK = (1 << ACC_SHIFT) - 1

_NESTED = {"dir": DirectoryMNState, "agents": AgentState,
           "ch_req": Channel, "ch_resp": Channel, "ch_hreq": Channel,
           "ch_hresp": Channel}


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True)).to(device)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def engine_state_to_torch(st, device=None) -> EngineMNState:
    """A reference ``EngineMNState`` (numpy leaves, dense layout) as the
    port's state on ``device``, dtype for dtype."""
    dev = resolve_device(device)
    fields = {}
    for name in EngineMNState._fields:
        src = getattr(st, name)
        cls = _NESTED.get(name)
        fields[name] = (
            cls(*(_to_tensor(getattr(src, f), dev) for f in cls._fields))
            if cls is not None else _to_tensor(src, dev))
    return EngineMNState(**fields)


def engine_state_to_numpy(st: EngineMNState) -> EngineMNState:
    """The port's state with numpy leaves (the reference's field names
    and dtypes)."""
    fields = {}
    for name in EngineMNState._fields:
        src = getattr(st, name)
        cls = _NESTED.get(name)
        fields[name] = (cls(*(_to_numpy(x) for x in src))
                        if cls is not None else _to_numpy(src))
    return EngineMNState(**fields)


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
