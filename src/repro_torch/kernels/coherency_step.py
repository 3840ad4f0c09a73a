"""The coherency step's four kernels: wrappers over ``csrc/coherency_step.cu``.

Each wrapper replaces one Pallas kernel of ``repro.kernels.coherency_step``:

* ``credit_rank`` — parity-split credit ranking (``transport.credit_accept``);
* ``arb_winner``  — per-line rotating-priority arbitration
  (``core.engine_mn.step_mn`` phase 4);
* ``count_fold``  — the delivered-message counter fold (``core.engine._count``);
* ``lat_hist``    — the retirement-latency histogram
  (``traffic.counters.update_counters``).

Dispatch is by the device of the tensors given: on the CPU a wrapper runs
its plain version (``kernels.ref``); on a CUDA device it checks device,
dtype, shape and contiguity, launches its kernel on the current stream
(adding one to ``launches[name]``) and raises if the launch fails.  There
is no fallback from the card to the plain version.

What bounds each kernel on the card, and how its design answers it, is
noted beside each kernel in ``csrc/coherency_step.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import ref

#: the latency histogram's bucket edges (engine steps), fixed in the CUDA
#: source as ``lat_bucket``'s ``edges``.
LAT_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

#: kernel launches per wrapper since the last ``reset_launches()``.
launches: Dict[str, int] = {"credit_rank": 0, "arb_winner": 0,
                            "count_fold": 0, "lat_hist": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "coh_credit_rank": (_P, _P, _P, _I, _I, _P),
    "coh_arb_winner": (_P, _P, _P, _I, _I, _I, _P),
    "coh_count_fold": (_P, _P, _P, _P, ctypes.c_longlong, _P),
    "coh_lat_hist": (_P, _P, _P, _I, _I, _P),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        from .build import load
        lib = load("coherency_step")
        for sym, argtypes in _SIGS.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[sym] = fn
        f = _fns[name]
    return f


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: runs on 'cuda' or 'cpu' tensors, got "
                         f"{device}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(kernel: str, sym: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(sym)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    launches[kernel] += 1


def credit_rank(active: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[..., L] int32: per initiator row, the occupancy of the line's
    odd/even VC plus the count of earlier same-parity candidates."""
    if active.device.type == "cpu":
        return ref.credit_rank_ref(active, cand)
    if cand.shape != active.shape:
        raise ValueError(f"credit_rank: shapes {tuple(active.shape)} and "
                         f"{tuple(cand.shape)} differ")
    _check("credit_rank", active, torch.bool, active.device)
    _check("credit_rank", cand, torch.bool, active.device)
    L = active.shape[-1]
    rows = active.numel() // max(L, 1)
    out = torch.empty(active.shape, dtype=torch.int32, device=active.device)
    _launch("credit_rank", "coh_credit_rank", active.data_ptr(),
            cand.data_ptr(), out.data_ptr(), rows, L)
    return out


def arb_winner(ready_all: torch.Tensor, arb_rr: torch.Tensor
               ) -> torch.Tensor:
    """[..., L] int32: per line, the ready participant of the ``[..., P,
    L]`` plane with the lowest ``(p - arb_rr) mod P``; the lowest id wins
    ties (which occur only when no participant is ready)."""
    if ready_all.device.type == "cpu":
        return ref.arb_winner_ref(ready_all, arb_rr)
    P, L = ready_all.shape[-2:]
    if tuple(arb_rr.shape) != tuple(ready_all.shape[:-2]) + (L,):
        raise ValueError(f"arb_winner: arb_rr shape {tuple(arb_rr.shape)} "
                         f"does not match ready {tuple(ready_all.shape)}")
    _check("arb_winner", ready_all, torch.bool, ready_all.device)
    _check("arb_winner", arb_rr, torch.int32, ready_all.device)
    n = arb_rr.numel() // max(L, 1)
    out = torch.empty(arb_rr.shape, dtype=torch.int32,
                      device=ready_all.device)
    _launch("arb_winner", "coh_arb_winner", ready_all.data_ptr(),
            arb_rr.data_ptr(), out.data_ptr(), n, P, L)
    return out


def count_fold(mask: torch.Tensor, msg: torch.Tensor,
               has_payload: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta [16] int32, payload delta [] int32): the histogram of the
    int8 ``msg`` codes under ``mask`` over all axes, and the count of
    masked lanes with ``has_payload``."""
    if mask.device.type == "cpu":
        return ref.count_fold_ref(mask, msg, has_payload)
    if not (mask.shape == msg.shape == has_payload.shape):
        raise ValueError("count_fold: mask, msg and has_payload must have "
                         "one shape")
    _check("count_fold", mask, torch.bool, mask.device)
    _check("count_fold", msg, torch.int8, mask.device)
    _check("count_fold", has_payload, torch.bool, mask.device)
    out = torch.zeros(17, dtype=torch.int32, device=mask.device)
    _launch("count_fold", "coh_count_fold", mask.data_ptr(), msg.data_ptr(),
            has_payload.data_ptr(), out.data_ptr(), mask.numel())
    return out[:16], out[16]


def lat_hist(lat: torch.Tensor, retired: torch.Tensor) -> torch.Tensor:
    """[R, 10] int32 latency histogram of the retired lanes of ``[R, L]``:
    bucket ``sum_e (lat >= LAT_EDGES[e])``."""
    if lat.device.type == "cpu":
        return ref.lat_hist_ref(lat, retired, LAT_EDGES)
    if lat.dim() != 2 or retired.shape != lat.shape:
        raise ValueError("lat_hist: lat and retired must be one [R, L] "
                         "shape")
    _check("lat_hist", lat, torch.int32, lat.device)
    _check("lat_hist", retired, torch.bool, lat.device)
    R, L = lat.shape
    out = torch.empty((R, len(LAT_EDGES) + 1), dtype=torch.int32,
                      device=lat.device)
    _launch("lat_hist", "coh_lat_hist", lat.data_ptr(), retired.data_ptr(),
            out.data_ptr(), R, L)
    return out
