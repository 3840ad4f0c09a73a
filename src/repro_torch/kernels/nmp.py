"""The near-memory operators' three kernels: wrappers over ``csrc/nmp.cu``.

Each wrapper replaces one Pallas kernel of ``repro.kernels``:

* ``select_scan`` — the SELECT predicate and per-block compaction
  (``repro.kernels.select_scan``);
* ``regex_dfa``   — the table-driven DFA walk (``repro.kernels.regex_dfa``);
* ``hash_probe``  — the Fibonacci-hash chained probe
  (``repro.kernels.hash_probe``).

Dispatch is by the device of the tensors given, as in
``kernels.coherency_step``: on the CPU a wrapper runs its plain version
(``kernels.ref``); on a CUDA device it checks device, dtype, shape and
layout, launches its kernel on the current stream (adding one to
``launches[name]``) and raises if the launch fails.  There is no fallback
from the card to the plain version.  ``regex_dfa`` reads a string field
in place (contiguous rows at any row stride); ``hash_probe`` takes keys
and next pointers as records (the columns of one ``[n, 2]`` tensor, as
``build_kvs`` lays them out) or as two contiguous arrays, which it
interleaves first.

What bounds each kernel on the card, and how its design answers it, is
noted beside each kernel in ``csrc/nmp.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..nmp.kvstore import records
from ..nmp.select import scalar
from . import ref
from .build import Library, refuse_dtensor
from .coherency_step import _check, rows_stride

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGS = {
    "nmp_select_scan": (_P, _I, ctypes.c_double, ctypes.c_double, _LL, _I,
                        _I, _P, _P),
    "nmp_regex_dfa": (_P, _P, _I, _P, _LL, _I, _LL, _P),
    "nmp_hash_probe": (_P, _I, _P, _P, _LL, _I, _P, _P),
}
_LIB = Library("nmp", _SIGS, ("select_scan", "regex_dfa", "hash_probe"))
#: kernel launches per wrapper since the last ``reset_launches()``.
launches: Dict[str, int] = _LIB.launches
reset_launches = _LIB.reset_launches
_launch = _LIB.launch

#: the table dtypes ``select_scan`` takes on the card, as the CUDA
#: entry point numbers them (``csrc/nmp.cu``, ``nmp_select_scan``).
SELECT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                 torch.int32: 3}


def select_scan(table: torch.Tensor, x, y, block_rows: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed [n/block_rows, block_rows, w], counts [n/block_rows]
    int32): per block of rows of ``table`` [n, w], the rows with
    ``col0 > x & col1 < y`` first in row order, zeros after.  ``x`` and
    ``y`` are rounded to the table's dtype and compared in it, as the
    reference's weak-typed scalars are.  On the card the table is one of
    ``SELECT_DTYPES`` and ``block_rows`` a multiple of 32 up to 1024."""
    refuse_dtensor("select_scan", table)
    if table.device.type == "cpu":
        return ref.select_scan_ref(table, x, y, block_rows)
    if table.dim() != 2 or table.shape[1] < 2:
        raise ValueError(f"select_scan: table of shape "
                         f"{tuple(table.shape)}, expected [n, w >= 2]")
    n, w = table.shape
    if block_rows % 32 or not 32 <= block_rows <= 1024 or n % block_rows:
        raise ValueError(f"select_scan: block_rows={block_rows} must be a "
                         f"multiple of 32 in [32, 1024] dividing n={n}")
    if table.dtype not in SELECT_DTYPES:
        raise TypeError(f"select_scan: dtype {table.dtype}, expected one of "
                        f"{sorted(str(d) for d in SELECT_DTYPES)}")
    _check("select_scan", table, table.dtype, table.device)
    nb = n // block_rows
    packed = torch.empty((nb, block_rows, w), dtype=table.dtype,
                         device=table.device)
    counts = torch.empty(nb, dtype=torch.int32, device=table.device)
    # the bounds rounded to the table's dtype, exact in a double.
    xd, yd = (float(scalar(v, table.dtype)) for v in (x, y))
    _launch("select_scan", "nmp_select_scan", table.data_ptr(),
            SELECT_DTYPES[table.dtype], xd, yd, nb, block_rows, w,
            packed.data_ptr(), counts.data_ptr())
    return packed, counts


def regex_dfa(trans: torch.Tensor, accept: torch.Tensor,
              strings: torch.Tensor) -> torch.Tensor:
    """[rows] bool: ``accept`` of the state each row of ``strings``
    ([rows, width] uint8) ends in, walking ``trans`` ([n_states, 256]
    int32) from state 0.  ``strings`` may be a view of a wider table: its
    rows must be contiguous, at any row stride of at least their width and
    any storage offset, and are read where they lie.  The kernel writes
    the answer, so a call is one device operation."""
    refuse_dtensor("regex_dfa", trans, accept, strings)
    if strings.device.type == "cpu":
        return ref.regex_dfa_ref(trans, accept, strings)
    dev = strings.device
    if trans.dim() != 2 or trans.shape[1] != 256 or \
            tuple(accept.shape) != (trans.shape[0],) or strings.dim() != 2:
        raise ValueError(f"regex_dfa: trans {tuple(trans.shape)}, accept "
                         f"{tuple(accept.shape)}, strings "
                         f"{tuple(strings.shape)}; expected [S, 256], [S], "
                         f"[rows, width]")
    _check("regex_dfa", trans, torch.int32, dev)
    _check("regex_dfa", accept, torch.bool, dev)
    _check("regex_dfa", strings, torch.uint8, dev, layout="rows")
    out = torch.empty(strings.shape[0], dtype=torch.bool, device=dev)
    _launch("regex_dfa", "nmp_regex_dfa", trans.data_ptr(),
            accept.data_ptr(), trans.shape[0], strings.data_ptr(),
            strings.shape[0], strings.shape[1], rows_stride(strings),
            out.data_ptr())
    return out


def chains_layout(keys: torch.Tensor, nxt: torch.Tensor) -> bool:
    """Whether ``hash_probe`` takes ``keys`` and ``nxt`` on the card: the
    two columns of one 8-byte-aligned ``[n, 2]`` tensor (chased as they
    lie), or two contiguous arrays (interleaved first)."""
    rec = records(keys, nxt)
    return (rec is not None and rec.data_ptr() % 8 == 0) or \
        (keys.is_contiguous() and nxt.is_contiguous())


def hash_probe(heads: torch.Tensor, keys: torch.Tensor, nxt: torch.Tensor,
               queries: torch.Tensor, max_chain: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found_idx [q] int32, -1 on a miss; steps [q] int32): each query's
    bucket ``fib_hash(query) % len(heads)`` and at most ``max_chain``
    entries of its chain.  Keys and queries are int32 with the uint32
    bits.  On the card ``keys`` and ``nxt`` are the two columns of one
    ``[n, 2]`` tensor (the records layout of ``nmp.kvstore.as_records``,
    launched as it lies: one device operation) or two contiguous arrays,
    interleaved into records first (one more device operation)."""
    refuse_dtensor("hash_probe", heads, keys, nxt, queries)
    if queries.device.type == "cpu":
        return ref.hash_probe_ref(heads, keys, nxt, queries, max_chain)
    dev = queries.device
    if heads.dim() != 1 or heads.shape[0] == 0 or keys.dim() != 1 or \
            tuple(nxt.shape) != tuple(keys.shape) or queries.dim() != 1:
        raise ValueError(f"hash_probe: heads {tuple(heads.shape)}, keys "
                         f"{tuple(keys.shape)}, nxt {tuple(nxt.shape)}, "
                         f"queries {tuple(queries.shape)}; expected "
                         f"[n_buckets > 0], [n], [n], [q]")
    for t in (heads, queries):
        _check("hash_probe", t, torch.int32, dev)
    for t in (keys, nxt):
        _check("hash_probe", t, torch.int32, dev, layout="strided")
    if not chains_layout(keys, nxt):
        raise ValueError("hash_probe: keys and nxt must be the two "
                         "columns of one [n, 2] tensor, 8-byte aligned, or "
                         "two contiguous arrays")
    rec = records(keys, nxt)
    if rec is None or rec.data_ptr() % 8:
        rec = torch.stack((keys, nxt), 1)
    found = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    steps = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    _launch("hash_probe", "nmp_hash_probe", heads.data_ptr(),
            heads.shape[0], rec.data_ptr(), queries.data_ptr(),
            queries.shape[0], int(max_chain), found.data_ptr(),
            steps.data_ptr())
    return found, steps
