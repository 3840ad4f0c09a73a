"""Public entry points of the kernels, with the reference's padding and
routing (``repro.kernels.ops``).

The near-memory ones call their wrapper in ``kernels.nmp`` — the CUDA
kernel for tensors on the card, the plain version for tensors on the
CPU; ``select`` and ``probe`` pad their rows to a multiple of the block
first, and ``probe`` slices the padding off.  ``attention`` and
``rglru`` route as the reference does with ``use_kernel=True``: the
shapes that reach its Pallas kernel reach the wrapper in
``kernels.models``, the others its plain versions, on either device.
One call launches at most one kernel.

The wrappers refuse some layouts on the card that the reference's entry
points take (a strided table, rows that are not contiguous, keys and
next pointers that are neither records nor two arrays, a bf16 attention
operand off a 16-byte boundary).  Each entry point here copies such an
argument into a layout its kernel takes first, and hands every other
argument on as it lies: a view that the kernel reads in place stays one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import models as _models
from . import nmp as _nmp
from . import ref as _ref
from .coherency_step import rows_layout


def pad_fill(dtype: torch.dtype):
    """What ``select`` pads rows with: the dtype's lowest finite value
    (0 for integers), which ``a > x`` rejects for any ``x`` above it."""
    return torch.finfo(dtype).min if dtype.is_floating_point else 0


def _pad_rows(x: torch.Tensor, mult: int, fill=0) -> Tuple[torch.Tensor,
                                                            int]:
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail]), n


def select(table: torch.Tensor, x, y, *, block_rows: int = 256
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT pushdown hot loop: (packed [blocks, block_rows, w], counts
    [blocks] int32), the padding rows kept.  Padding rows hold
    ``pad_fill(table.dtype)`` in every column, so they match only when
    ``x`` is below that value (``x = -inf``)."""
    padded, _ = _pad_rows(table, block_rows, pad_fill(table.dtype))
    return _nmp.select_scan(padded.contiguous(), x, y, block_rows)


def regex_match(trans: torch.Tensor, accept: torch.Tensor,
                strings: torch.Tensor) -> torch.Tensor:
    """[rows] bool: whether each NUL-padded row of ``strings`` matches.
    The kernel takes any number of rows (the reference pads to its
    block), so a view of a table's string columns is read in place; a
    field whose rows are not contiguous is copied first."""
    if not rows_layout(strings):
        strings = strings.contiguous()
    return _nmp.regex_dfa(trans, accept, strings)


def probe(heads: torch.Tensor, keys: torch.Tensor, nxt: torch.Tensor,
          queries: torch.Tensor, *, max_chain: int = 32, block_q: int = 256
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found_idx [q] int32, -1 on a miss; steps [q] int32) of a chained
    probe of at most ``max_chain`` entries per query.  ``keys`` and
    ``nxt`` in another layout than the two the kernel takes are
    interleaved into records first."""
    if not _nmp.chains_layout(keys, nxt):
        rec = torch.stack((keys, nxt), 1)
        keys, nxt = rec[:, 0], rec[:, 1]
    padded, n = _pad_rows(queries, block_q)
    found, steps = _nmp.hash_probe(heads, keys, nxt, padded, max_chain)
    return found[:n], steps[:n]


#: the reference's block sizes (``repro.kernels.ops``): a shape reaches
#: its Pallas kernel when each length is a multiple of ``min(BLOCK, .)``.
BLOCK = 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              kv_length=None, use_kernel: bool = True) -> torch.Tensor:
    """Attention entry point of the model layers: q [B, Hq, Sq, D] over
    k, v [B, Hkv, Sk, D].

    The kernel (``kernels.models.flash_attention``) takes the shapes the
    reference's Pallas kernel takes: no ``kv_length``, ``Sq`` and ``Sk``
    multiples of their blocks (``min(BLOCK, S)``).  Otherwise, or with
    ``use_kernel=False``, a large or decode shape (``Sq * Sk > 256 *
    256``, or ``kv_length`` set) runs ``ref.chunked_attention`` and a
    small one ``ref.flash_attention_ref``."""
    Sq, Sk = q.shape[2], k.shape[2]
    if (not use_kernel or Sq % min(BLOCK, Sq) or Sk % min(BLOCK, Sk)
            or kv_length is not None):
        if Sq * Sk > 256 * 256 or kv_length is not None:
            return _ref.chunked_attention(q, k, v, causal=causal,
                                          window=window, softcap=softcap,
                                          kv_length=kv_length)
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    return _models.flash_attention(_operand(q), _operand(k), _operand(v),
                                   causal=causal, window=window,
                                   softcap=softcap)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """An attention operand as the kernel takes it: contiguous, and for
    bf16 (TMA's rule) starting on a 16-byte boundary — a fresh aligned
    clone of a contiguous tensor that does not."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        t = t.clone()
    return t


def rglru(x: torch.Tensor, a: torch.Tensor, *,
          use_kernel: bool = True) -> torch.Tensor:
    """The RG-LRU scan over x, a [B, S, D]: the kernel
    (``kernels.models.rglru_scan``) where ``S`` and ``D`` are multiples of
    their blocks (``min(BLOCK, .)``), as the reference's Pallas kernel
    needs, else (or with ``use_kernel=False``) ``ref.rglru_scan_ref``."""
    S, D = x.shape[1], x.shape[2]
    if not use_kernel or S % min(BLOCK, S) or D % min(BLOCK, D):
        return _ref.rglru_scan_ref(x, a)
    return _models.rglru_scan(x.contiguous(), a.contiguous())
