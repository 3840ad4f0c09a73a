"""The coherency step's six kernels: wrappers over ``csrc/coherency_step.cu``.

Each wrapper replaces one Pallas kernel of ``repro.kernels.coherency_step``:

* ``credit_rank`` — parity-split credit ranking (``transport.credit_accept``);
* ``arb_winner``  — per-line rotating-priority arbitration
  (``core.engine_mn.step_mn`` phase 4);
* ``count_fold``  — the delivered-message counter fold, running totals
  included (``core.engine._count``);
* ``lat_hist``    — the retirement-latency histogram
  (``traffic.counters.update_counters``);
* ``packed_any``  — any bit set per line of a packed word plane, or of
  the OR of up to four (``core.directory_mn.any_bits``);
* ``packed_fanout`` — the packed fan-out target words, with the home-side
  fan-out on the lines of optional home flags
  (``core.directory_mn.needed_words``).

Dispatch is by the device of the tensors given: on the CPU a wrapper runs
its plain version (``kernels.ref``); on a CUDA device it checks device,
dtype, shape and layout, launches its kernel on the current stream
(adding one to ``launches[name]``) and raises if the launch fails.  There
is no fallback from the card to the plain version.  The packed kernels
read their word planes where they lie (``plane_stride``): a slice of the
packed ``[H, 2, L, W]`` view is no copy.

What bounds each kernel on the card, and how its design answers it, is
noted beside each kernel in ``csrc/coherency_step.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import ref
from .build import Library, refuse_dtensor

#: the latency histogram's bucket edges (engine steps), fixed in the CUDA
#: source as ``lat_bucket``'s ``edges``.
LAT_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGS = {
    "coh_credit_rank": (_P, _P, _P, _I, _I),
    "coh_arb_winner": (_P, _P, _P, _I, _I, _I),
    "coh_count_fold": (_P, _P, _P, _P, _P, _P, _LL, _I, _P, _I, _LL, _LL),
    "coh_lat_hist": (_P, _P, _P, _I, _I),
    "coh_packed_any": (_P,) * 4 + (_LL,) * 4 + (_I, _P, _LL, _LL, _I),
    "coh_packed_fanout": (_P, _LL, _P, _LL) + (_P,) * 7 + (_LL, _LL, _I),
    "coh_empty": (_I, _I),
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
    and any storage offset (``rows_stride`` gives the stride); ``"plane"``,
    a word plane that ``plane_stride`` takes; or ``"strided"``, no rule
    here, the wrapper checks the strides itself."""
    if device.type != "cuda":
        raise ValueError(f"{name}: runs on 'cuda' or 'cpu' tensors, got "
                         f"{device}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if layout == "contiguous" and not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if layout == "rows" and not rows_layout(t):
        raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} and "
                         f"strides {t.stride()}, expected [rows, width] "
                         f"with contiguous rows at a stride >= width")
    if layout == "plane" and plane_stride(t) is None:
        raise ValueError(f"{name}: word plane of shape {tuple(t.shape)} "
                         f"and strides {t.stride()}, expected [..., L, W] "
                         f"with its last two dims dense and its leading "
                         f"dims one axis at any stride")


def rows_stride(t: torch.Tensor) -> int:
    """The row stride, in elements, of a 2-D tensor (its width when it
    has one row, whatever stride PyTorch gives that row)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def rows_layout(t: torch.Tensor) -> bool:
    """Whether ``t`` is ``[rows, width]`` with contiguous rows at a row
    stride of at least their width (``_check``'s ``"rows"``)."""
    return (t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)
            and rows_stride(t) >= t.shape[1])


def plane_stride(t: torch.Tensor) -> Optional[int]:
    """The words between the ``[L, W]`` blocks of a word plane ``[..., L,
    W]`` whose last two dims are dense and whose leading dims collapse into
    one axis (``L * W`` for a contiguous plane, ``2 * L * W`` for a slice
    ``[..., p, :, :]`` of the packed ``[..., 2, L, W]`` view); None for
    any other layout."""
    if t.dim() < 2:
        return None
    L, W = t.shape[-2:]
    if (W > 1 and t.stride(-1) != 1) or (L > 1 and t.stride(-2) != W):
        return None
    stride, span = L * W, None
    for size, st in zip(reversed(t.shape[:-2]), reversed(t.stride()[:-2])):
        if size == 1:
            continue
        if span is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return stride


#: the packed kernels index words in 32 bits: every word they read or
#: write lies below this many words past its plane's start.
WORD_INDEX_LIMIT = 1 << 31


def check_plane_span(name: str, *planes: torch.Tensor) -> None:
    """Raise unless the packed kernels' 32-bit index reaches every word of
    the ``[..., L, W]`` word ``planes`` (one shape, each of a layout that
    ``plane_stride`` takes) and of a contiguous output of their shape."""
    L, W = planes[0].shape[-2:]
    blocks = planes[0].numel() // max(L * W, 1)
    spans = [planes[0].numel()] + [
        (blocks - 1) * plane_stride(p) + L * W if blocks else 0
        for p in planes]
    if max(spans) >= WORD_INDEX_LIMIT:
        raise ValueError(f"{name}: word planes of shape "
                         f"{tuple(planes[0].shape)} and strides "
                         f"{[p.stride() for p in planes]} span "
                         f"{max(spans)} words; the kernels index fewer "
                         f"than 2^31")


def credit_rank(active: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[..., L] int32: per initiator row, the occupancy of the line's
    odd/even VC plus the count of earlier same-parity candidates."""
    refuse_dtensor("credit_rank", active, cand)
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
    refuse_dtensor("arb_winner", ready_all, arb_rr)
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


def _fold_acc(device: torch.device, groups: int = 1) -> torch.Tensor:
    """``count_fold``'s 17 int64 accumulators per group, ``FOLD_ACC_STRIDE``
    apart, on ``device``'s current stream, zeroed when made: each launch
    leaves them at 0 again, so launches on one stream share them in turn.
    The set grows (a new zeroed one) when a call has more groups than it
    holds."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    acc = _FOLD_ACC.get(key)
    if acc is None or acc.numel() < groups * 17 * FOLD_ACC_STRIDE:
        acc = _FOLD_ACC[key] = torch.zeros(groups * 17 * FOLD_ACC_STRIDE,
                                           dtype=torch.int64, device=device)
    return acc


def count_fold(mask: torch.Tensor, msg: torch.Tensor,
               has_payload: torch.Tensor,
               base: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               grouped: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta [16] int32, payload delta [] int32): the histogram of the
    int8 ``msg`` codes under ``mask`` over all axes, and the count of
    masked lanes with ``has_payload``.  With ``base=(msg_count [16],
    payload_msgs [])`` int32, the running totals plus those, from the
    same launch.

    ``grouped=True`` makes the leading axis of the planes a group axis of
    G: each group folds into its own row, ``([G, 16], [G])``, onto a
    ``base`` of those shapes, all in one launch (G = 1 is the ungrouped
    launch).  The grouped base is read where it lies: rows of 16
    contiguous counts at any row stride, payload counts at any stride,
    such as the views of the last call's output."""
    refuse_dtensor("count_fold", mask, msg, has_payload, *(base or ()))
    if mask.device.type == "cpu":
        return ref.count_fold_ref(mask, msg, has_payload, base,
                                  grouped=grouped)
    if not (mask.shape == msg.shape == has_payload.shape):
        raise ValueError("count_fold: mask, msg and has_payload must have "
                         "one shape")
    dev = mask.device
    _check("count_fold", mask, torch.bool, dev)
    _check("count_fold", msg, torch.int8, dev)
    _check("count_fold", has_payload, torch.bool, dev)
    if grouped and mask.dim() == 0:
        raise ValueError("count_fold: a grouped fold needs a leading "
                         "group axis")
    G = mask.shape[0] if grouped else 1
    lead = (G,) if grouped else ()
    base_c = base_p = None
    c_stride = p_stride = 0
    if base is not None:
        counts, pay = base
        if tuple(counts.shape) != lead + (16,) or tuple(pay.shape) != lead:
            raise ValueError(f"count_fold: base shapes "
                             f"{tuple(counts.shape)} and {tuple(pay.shape)}"
                             f", expected {lead + (16,)} and {lead}")
        layout = "strided" if grouped else "contiguous"
        _check("count_fold", counts, torch.int32, dev, layout)
        _check("count_fold", pay, torch.int32, dev, layout)
        if grouped:
            if counts.stride(1) != 1:
                raise ValueError("count_fold: each base row of counts "
                                 "must be contiguous")
            c_stride, p_stride = counts.stride(0), pay.stride(0)
        base_c, base_p = counts.data_ptr(), pay.data_ptr()
    acc = _fold_acc(dev, G)
    out = torch.empty(lead + (17,), dtype=torch.int32, device=dev)
    _launch("count_fold", "coh_count_fold", mask.data_ptr(), msg.data_ptr(),
            has_payload.data_ptr(), base_c, base_p, out.data_ptr(),
            mask.numel() // max(G, 1), G, acc.data_ptr(), FOLD_ACC_STRIDE,
            c_stride, p_stride)
    return out[..., :16], out[..., 16]


def lat_hist(lat: torch.Tensor, retired: torch.Tensor) -> torch.Tensor:
    """[R, 10] int32 latency histogram of the retired lanes of ``[R, L]``:
    bucket ``sum_e (lat >= LAT_EDGES[e])``."""
    refuse_dtensor("lat_hist", lat, retired)
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


#: word planes one ``packed_any`` launch ORs together.
MAX_PLANES = 4


def packed_any(*planes: torch.Tensor) -> torch.Tensor:
    """[..., L] bool: any bit set in the line's words of the OR of 1 to
    ``MAX_PLANES`` ``[..., L, W]`` int32 word planes of one shape (with
    one plane the reference's ``packed_any``; with several the OR of its
    verdicts, since ``any(x) | any(y) == any(x | y)``).  On the card each
    plane is read where it lies (``plane_stride``), and planes with a
    word 2^31 or more past their start are refused
    (``check_plane_span``)."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"packed_any: {len(planes)} word planes, expected "
                         f"1 to {MAX_PLANES}")
    refuse_dtensor("packed_any", *planes)
    if planes[0].device.type == "cpu":
        return ref.packed_any_ref(*planes)
    shape, dev = tuple(planes[0].shape), planes[0].device
    if len(shape) < 2 or any(tuple(p.shape) != shape for p in planes):
        raise ValueError(f"packed_any: word planes of shapes "
                         f"{[tuple(p.shape) for p in planes]}, expected one "
                         f"[..., L, W] shape")
    ptrs, strides = [None] * MAX_PLANES, [0] * MAX_PLANES
    for k, p in enumerate(planes):
        _check("packed_any", p, torch.int32, dev, layout="plane")
        ptrs[k], strides[k] = p.data_ptr(), plane_stride(p)
    check_plane_span("packed_any", *planes)
    L, W = shape[-2:]
    out = torch.empty(shape[:-1], dtype=torch.bool, device=dev)
    _launch("packed_any", "coh_packed_any", *ptrs, *strides, len(planes),
            out.data_ptr(), out.numel(), L, W)
    return out


def packed_fanout(pres: torch.Tensor, excl: torch.Tensor,
                  node: torch.Tensor, shared_req: torch.Tensor,
                  excl_req: torch.Tensor,
                  home_read: Optional[torch.Tensor] = None,
                  home_write: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recall_w, inval_w) ``[..., L, W]`` int32: ``excl & ~hot(node)``
    on the lines of ``shared_req`` and ``pres & ~hot(node)`` on those of
    ``excl_req``, zero elsewhere.  With the per-line ``home_read`` and
    ``home_write`` (both or neither), a line where either is set takes the
    home-side fan-out instead: ``inval = pres`` where ``home_write``,
    ``recall = excl & ~inval`` where ``home_read`` (the reference's
    ``home_needed_words``).  On the card ``pres`` and ``excl`` are read
    where they lie (``plane_stride``; planes with a word 2^31 or more
    past their start are refused, ``check_plane_span``), the per-line
    inputs contiguous."""
    if (home_read is None) != (home_write is None):
        raise ValueError("packed_fanout: home_read and home_write go "
                         "together")
    refuse_dtensor("packed_fanout", pres, excl, node, shared_req, excl_req,
                   home_read, home_write)
    if pres.device.type == "cpu":
        return ref.packed_fanout_ref(pres, excl, node, shared_req, excl_req,
                                     home_read, home_write)
    lines = tuple(pres.shape[:-1])
    per_line = [node, shared_req, excl_req] + (
        [] if home_read is None else [home_read, home_write])
    if tuple(excl.shape) != tuple(pres.shape) or \
            any(tuple(t.shape) != lines for t in per_line):
        raise ValueError(f"packed_fanout: word planes {tuple(pres.shape)} "
                         f"and {tuple(excl.shape)} need per-line inputs "
                         f"of shape {lines}")
    dev = pres.device
    _check("packed_fanout", pres, torch.int32, dev, layout="plane")
    _check("packed_fanout", excl, torch.int32, dev, layout="plane")
    check_plane_span("packed_fanout", pres, excl)
    _check("packed_fanout", node, torch.int32, dev)
    for t in per_line[1:]:
        _check("packed_fanout", t, torch.bool, dev)
    recall = torch.empty(pres.shape, dtype=torch.int32, device=dev)
    inval = torch.empty(pres.shape, dtype=torch.int32, device=dev)
    home = (None, None) if home_read is None else \
        (home_read.data_ptr(), home_write.data_ptr())
    _launch("packed_fanout", "coh_packed_fanout", pres.data_ptr(),
            plane_stride(pres), excl.data_ptr(), plane_stride(excl),
            node.data_ptr(), shared_req.data_ptr(), excl_req.data_ptr(),
            *home, recall.data_ptr(), inval.data_ptr(), node.numel(),
            pres.shape[-2], pres.shape[-1])
    return recall, inval


def empty_launch(blocks: int, threads: int = 256) -> None:
    """Launch the empty kernel, ``blocks`` CTAs of ``threads``, on the
    current stream: the device time of a launch that does no work, through
    the same ctypes route as the kernels (``chip_smoke.py`` times it).  It
    adds to no launch count."""
    err = _LIB.call("coh_empty", blocks, threads)
    if err != 0:
        raise RuntimeError(f"empty kernel: CUDA launch failed with error "
                           f"{err}")
