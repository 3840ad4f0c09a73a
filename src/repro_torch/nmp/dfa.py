"""DFA execution over fixed-width byte fields (paper §5.6), on tensors.

The port of ``repro.nmp.dfa``.  The operator works on a fixed-width byte
field within each row (the paper's 62-byte string inside a 128-byte row)
and runs the DFA one character per step over all rows at once.  Strings
are NUL-padded; accept states absorb, so a row matches iff the DFA ends in
an accept state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .regex import DFA
from .select import compact


def dfa_tables(dfa: DFA, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(transitions [n_states, 256] int32, accept [n_states] bool) of
    ``dfa`` on ``device``."""
    return (torch.as_tensor(dfa.transitions, dtype=torch.int32).to(device),
            torch.as_tensor(dfa.accept, dtype=torch.bool).to(device))


def field_bytes(field: torch.Tensor) -> torch.Tensor:
    """``field`` as uint8, as the reference's ``.astype(jnp.uint8)`` casts
    it: a float saturates to [0, 255] and NaN becomes 0 (``.to(uint8)``
    alone wraps: 376.0 would become 120, ``x``); an integer keeps its low
    8 bits.  The same on the CPU and on the card."""
    if field.dtype.is_floating_point:
        field = torch.nan_to_num(field, nan=0.0).clamp(0, 255)
    return field.to(torch.uint8)


def dfa_match(dfa: DFA, strings: torch.Tensor,
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[rows] bool: each row of ``strings`` ([rows, width] uint8) run
    through the DFA.  With ``lengths`` ([rows] int32), transitions past a
    row's length are frozen."""
    trans, accept = dfa_tables(dfa, strings.device)
    rows, width = strings.shape
    state = torch.zeros((rows,), dtype=torch.int64, device=strings.device)
    chars = strings.to(torch.int64)
    for pos in range(width):
        nxt = trans[state, chars[:, pos]].to(torch.int64)
        state = nxt if lengths is None else torch.where(pos < lengths, nxt,
                                                        state)
    return accept[state]


def dfa_select(dfa: DFA, table: torch.Tensor, str_lo: int, str_hi: int,
               capacity: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Regex-filter a table whose columns ``[str_lo, str_hi)`` hold the
    string field, cast to uint8 by ``field_bytes``.  Same packing contract
    as ``nmp.select.select_scan``: (packed, count, mask); ``capacity`` 0 or
    ``None`` is every row."""
    mask = dfa_match(dfa, field_bytes(table[:, str_lo:str_hi]))
    packed, count = compact(table, mask, capacity)
    return packed, count, mask
