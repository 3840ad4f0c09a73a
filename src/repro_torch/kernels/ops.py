"""Public entry points of the near-memory kernels, with the reference's
padding (``repro.kernels.ops``).

Each pads its rows to a multiple of the block, calls its wrapper in
``kernels.nmp`` — the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU — and, except for ``select``, slices the
padding off.  One call launches its kernel once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import nmp as _nmp


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
    return _nmp.select_scan(padded, x, y, block_rows)


def regex_match(trans: torch.Tensor, accept: torch.Tensor,
                strings: torch.Tensor, *, block_rows: int = 256
                ) -> torch.Tensor:
    """[rows] bool: whether each NUL-padded row of ``strings`` matches."""
    padded, n = _pad_rows(strings, block_rows)
    return _nmp.regex_dfa(trans, accept, padded)[:n]


def probe(heads: torch.Tensor, keys: torch.Tensor, nxt: torch.Tensor,
          queries: torch.Tensor, *, max_chain: int = 32, block_q: int = 256
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found_idx [q] int32, -1 on a miss; steps [q] int32) of a chained
    probe of at most ``max_chain`` entries per query."""
    padded, n = _pad_rows(queries, block_q)
    found, steps = _nmp.hash_probe(heads, keys, nxt, padded, max_chain)
    return found[:n], steps[:n]
