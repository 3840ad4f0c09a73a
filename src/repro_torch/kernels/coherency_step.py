"""The coherency step's six kernels: wrappers over ``csrc/coherency_step.cu``.

Each wrapper replaces one Pallas kernel of ``repro.kernels.coherency_step``:

* ``credit_rank`` — parity-split credit ranking (``transport.credit_accept``);
* ``arb_winner``  — per-line rotating-priority arbitration
  (``core.engine_mn.step_mn`` phase 4);
* ``count_fold``  — the delivered-message counter fold, running totals
  included (``core.engine._count``);
* ``lat_hist``    — the retirement-latency histogram
  (``traffic.counters.update_counters``);
* ``packed_any``  — any bit set per line of a packed word plane
  (``core.directory_mn.any_bits``);
* ``packed_fanout`` — the packed fan-out target words
  (``core.directory_mn.needed_words``).

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
from typing import Dict, Optional, Tuple

import torch

from . import ref
from .build import Library

#: the latency histogram's bucket edges (engine steps), fixed in the CUDA
#: source as ``lat_bucket``'s ``edges``.
LAT_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "coh_credit_rank": (_P, _P, _P, _I, _I),
    "coh_arb_winner": (_P, _P, _P, _I, _I, _I),
    "coh_count_fold": (_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _I),
    "coh_lat_hist": (_P, _P, _P, _I, _I),
    "coh_packed_any": (_P, _P, ctypes.c_longlong, _I),
    "coh_packed_fanout": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                          _I),
}
_LIB = Library("coherency_step", _SIGS,
               ("credit_rank", "arb_winner", "count_fold", "lat_hist",
                "packed_any", "packed_fanout"))
#: kernel launches per wrapper since the last ``reset_launches()``.
launches: Dict[str, int] = _LIB.launches
reset_launches = _LIB.reset_launches
_launch = _LIB.launch

#: int64 elements between ``count_fold``'s 17 accumulators (256 bytes:
#: each on a line of its own).
FOLD_ACC_STRIDE = 32
_FOLD_ACC: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device, layout: str = "contiguous") -> None:
    """Raise unless ``t`` lies on the CUDA ``device`` with ``dtype`` and
    the argument's ``layout``: ``"contiguous"``; ``"rows"``, a 2-D tensor
    whose rows are contiguous, at any row stride of at least their width
    and any storage offset (``rows_stride`` gives the stride); or
    ``"strided"``, no rule here, the wrapper checks the strides itself."""
    if device.type != "cuda":
        raise ValueError(f"{name}: runs on 'cuda' or 'cpu' tensors, got "
                         f"{device}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if layout == "contiguous" and not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if layout == "rows" and not (
            t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)
            and rows_stride(t) >= t.shape[1]):
        raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} and "
                         f"strides {t.stride()}, expected [rows, width] "
                         f"with contiguous rows at a stride >= width")


def rows_stride(t: torch.Tensor) -> int:
    """The row stride, in elements, of a 2-D tensor (its width when it
    has one row, whatever stride PyTorch gives that row)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


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


def _fold_acc(device: torch.device) -> torch.Tensor:
    """``count_fold``'s 17 int64 accumulators, ``FOLD_ACC_STRIDE`` apart,
    on ``device``'s current stream, zeroed at its first call there: each
    launch leaves them at 0 again, so launches on one stream share them
    in turn."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    acc = _FOLD_ACC.get(key)
    if acc is None:
        acc = _FOLD_ACC[key] = torch.zeros(17 * FOLD_ACC_STRIDE,
                                           dtype=torch.int64, device=device)
    return acc


def count_fold(mask: torch.Tensor, msg: torch.Tensor,
               has_payload: torch.Tensor,
               base: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta [16] int32, payload delta [] int32): the histogram of the
    int8 ``msg`` codes under ``mask`` over all axes, and the count of
    masked lanes with ``has_payload``.  With ``base=(msg_count [16],
    payload_msgs [])`` int32, the running totals plus those, from the
    same launch."""
    if mask.device.type == "cpu":
        return ref.count_fold_ref(mask, msg, has_payload, base)
    if not (mask.shape == msg.shape == has_payload.shape):
        raise ValueError("count_fold: mask, msg and has_payload must have "
                         "one shape")
    dev = mask.device
    _check("count_fold", mask, torch.bool, dev)
    _check("count_fold", msg, torch.int8, dev)
    _check("count_fold", has_payload, torch.bool, dev)
    base_c = base_p = None
    if base is not None:
        counts, pay = base
        if tuple(counts.shape) != (16,) or tuple(pay.shape) != ():
            raise ValueError(f"count_fold: base shapes "
                             f"{tuple(counts.shape)} and {tuple(pay.shape)}"
                             f", expected (16,) and ()")
        _check("count_fold", counts, torch.int32, dev)
        _check("count_fold", pay, torch.int32, dev)
        base_c, base_p = counts.data_ptr(), pay.data_ptr()
    acc = _fold_acc(dev)
    out = torch.empty(17, dtype=torch.int32, device=dev)
    _launch("count_fold", "coh_count_fold", mask.data_ptr(), msg.data_ptr(),
            has_payload.data_ptr(), base_c, base_p, out.data_ptr(),
            mask.numel(), acc.data_ptr(), FOLD_ACC_STRIDE)
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


def packed_any(words: torch.Tensor) -> torch.Tensor:
    """[..., L] bool: any bit set in the line's ``[..., L, W]`` int32
    words."""
    if words.device.type == "cpu":
        return ref.packed_any_ref(words)
    _check("packed_any", words, torch.int32, words.device)
    W = words.shape[-1]
    out = torch.empty(words.shape[:-1], dtype=torch.bool,
                      device=words.device)
    _launch("packed_any", "coh_packed_any", words.data_ptr(),
            out.data_ptr(), out.numel(), W)
    return out


def packed_fanout(pres: torch.Tensor, excl: torch.Tensor,
                  node: torch.Tensor, shared_req: torch.Tensor,
                  excl_req: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recall_w, inval_w) ``[..., L, W]`` int32: ``excl & ~hot(node)``
    on the lines of ``shared_req`` and ``pres & ~hot(node)`` on those of
    ``excl_req``, zero elsewhere."""
    if pres.device.type == "cpu":
        return ref.packed_fanout_ref(pres, excl, node, shared_req, excl_req)
    lines = tuple(pres.shape[:-1])
    if tuple(excl.shape) != tuple(pres.shape) or not (
            tuple(node.shape) == tuple(shared_req.shape)
            == tuple(excl_req.shape) == lines):
        raise ValueError(f"packed_fanout: word planes {tuple(pres.shape)} "
                         f"and {tuple(excl.shape)} need per-line inputs "
                         f"of shape {lines}")
    dev = pres.device
    _check("packed_fanout", pres, torch.int32, dev)
    _check("packed_fanout", excl, torch.int32, dev)
    _check("packed_fanout", node, torch.int32, dev)
    _check("packed_fanout", shared_req, torch.bool, dev)
    _check("packed_fanout", excl_req, torch.bool, dev)
    recall = torch.empty_like(pres)
    inval = torch.empty_like(pres)
    _launch("packed_fanout", "coh_packed_fanout", pres.data_ptr(),
            excl.data_ptr(), node.data_ptr(), shared_req.data_ptr(),
            excl_req.data_ptr(), recall.data_ptr(), inval.data_ptr(),
            node.numel(), pres.shape[-1])
    return recall, inval
