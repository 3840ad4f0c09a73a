"""SELECT-pushdown operator (paper §5.4), on tensors.

The port of ``repro.nmp.select``.  The paper's query shape is
``SELECT * FROM S WHERE S.a > X AND S.b < Y`` over 128-byte rows: a *row*
is a fixed-width vector whose first two attributes are the filter
columns; the operator evaluates the predicate over a shard of rows and
compacts the matches to the front (the FIFO analogue), stably, into a
fixed ``capacity`` with zeros past the count.

``make_table`` draws from numpy (``jax.random``'s stream cannot be
reproduced in torch): the tests make one table and feed it to both
packages.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


def make_table(rng: Union[int, np.random.Generator], n_rows: int,
               row_width: int, selectivity: float,
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """A table whose rows match ``a > 0 AND b < 1`` with probability
    ``selectivity``: column 0 (``a``) is +1 on a matching row and -1
    otherwise, column 1 (``b``) 0 and +2, the other columns normal
    payload.  ``rng`` is a seed or a ``numpy.random.Generator``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng)
    match = rng.random(n_rows) < selectivity
    table = np.empty((n_rows, row_width), np.float32)
    table[:, 0] = np.where(match, 1.0, -1.0)
    table[:, 1] = np.where(match, 0.0, 2.0)
    table[:, 2:] = rng.standard_normal((n_rows, row_width - 2),
                                       dtype=np.float32)
    return torch.as_tensor(table).to(dtype).to(dev)


def predicate(table: torch.Tensor, x, y, a_col: int = 0,
              b_col: int = 1) -> torch.Tensor:
    """The paper's predicate: a > X AND b < Y.  [rows] bool."""
    return (table[:, a_col] > x) & (table[:, b_col] < y)


def scalar(v, dtype: torch.dtype) -> torch.Tensor:
    """``v`` as a 0-d CPU tensor of ``dtype`` (the reference's
    ``jnp.asarray(v, table.dtype)``): compared with a tensor on any
    device, it adds no host-to-card copy."""
    return torch.as_tensor(v, dtype=torch.float64).to(dtype)


def compact(rows: torch.Tensor, mask: torch.Tensor,
            capacity: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed [capacity, w] — the rows of ``mask`` first, in row order,
    zeros past the count —, count [] int32): what the reference's stable
    argsort of ``~mask`` gives, from the mask's nonzero indices (one
    host sync).  Only the rows kept are gathered.  ``capacity`` is at
    most the number of rows; 0 or ``None`` means all of them (the
    reference's ``capacity or n``)."""
    capacity = capacity or rows.shape[0]
    if not 0 < capacity <= rows.shape[0]:
        raise ValueError(f"capacity {capacity} must be in [1, "
                         f"{rows.shape[0]}], the rows given")
    idx = mask.nonzero().squeeze(1)[:capacity]
    packed = rows.new_zeros((capacity,) + tuple(rows.shape[1:]))
    packed[:idx.shape[0]] = rows[idx]
    return packed, mask.sum(dtype=torch.int32)


def select_scan(table: torch.Tensor, x, y,
                capacity: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan + filter + compact.

    Returns (packed [capacity, row_width] matches-first in row order,
    count [] int32, mask [rows] bool).  Rows past ``count`` in ``packed``
    are zeros.
    """
    mask = predicate(table, scalar(x, table.dtype), scalar(y, table.dtype))
    packed, count = compact(table, mask, capacity)
    return packed, count, mask
