"""Plain PyTorch versions of the coherency-step kernels.

Each function mirrors its twin in ``repro.kernels.ref`` (the engine's
own expressions there) on tensors.  The wrappers in
``kernels.coherency_step`` run these for tensors on the CPU — the path
the tests hold against ``repro`` — and ``chip_smoke.py`` compares every
CUDA kernel with its plain version on the card.  All four are integer
arithmetic, so the contract is bit-exact equality.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _parity_odd(L: int, device) -> torch.Tensor:
    return (torch.arange(L, device=device) & 1).bool()


def credit_rank_ref(active: torch.Tensor, cand: torch.Tensor
                    ) -> torch.Tensor:
    """[..., L] int32 parity-split credit rank (``transport.credit_accept``).

    For each leading-axis initiator row: a candidate's rank against its
    odd/even VC is the VC's current occupancy plus the number of EARLIER
    candidates (stable line order) on the same parity."""
    L = active.shape[-1]
    odd = _parity_odd(L, active.device)
    c_o = (cand & odd).to(torch.int32)
    c_e = (cand & ~odd).to(torch.int32)
    occ_o = (active & odd).sum(-1, keepdim=True, dtype=torch.int32)
    occ_e = (active & ~odd).sum(-1, keepdim=True, dtype=torch.int32)
    rank_o = torch.cumsum(c_o, dim=-1, dtype=torch.int32) - c_o
    rank_e = torch.cumsum(c_e, dim=-1, dtype=torch.int32) - c_e
    return torch.where(odd, occ_o + rank_o, occ_e + rank_e)


def arb_winner_ref(ready_all: torch.Tensor, arb_rr: torch.Tensor
                   ) -> torch.Tensor:
    """[..., L] int32 rotating-priority winner select (``step_mn`` phase 4).

    Participant p's priority on a line is ``(p - arb_rr) mod P`` (floor
    modulo, as ``jnp``'s ``%``; torch's ``%`` on integers is a floor
    modulo too); the winner is the ready participant of minimum priority,
    ties — only at the not-ready fill value P — going to the LOWEST id."""
    P = ready_all.shape[-2]
    p = torch.arange(P, device=ready_all.device, dtype=torch.int32)
    prio = (p[:, None] - arb_rr.to(torch.int32)[..., None, :]) % P
    score = torch.where(ready_all, prio, torch.full_like(prio, P))
    return torch.argmin(score, dim=-2).to(torch.int32)


def count_fold_ref(mask: torch.Tensor, msg: torch.Tensor,
                   has_payload: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delivered-message fold (``engine._count``): a 16-bin histogram of
    ``msg`` under ``mask`` over ALL axes, plus the count of masked lanes
    carrying a payload.  Returns (delta [16] int32, payload delta []
    int32); codes outside 0..15 land in no bin."""
    types = torch.arange(16, device=msg.device, dtype=torch.int32)
    eq = msg.to(torch.int32)[..., None] == types
    hist = (eq & mask[..., None]).reshape(-1, 16).sum(0, dtype=torch.int32)
    return hist, (mask & has_payload).sum(dtype=torch.int32)


def lat_hist_ref(lat: torch.Tensor, retired: torch.Tensor,
                 edges: Tuple[int, ...]) -> torch.Tensor:
    """[R, NB] int32 retirement-latency histogram delta
    (``traffic.counters.update_counters``): bucket ``searchsorted(edges,
    lat, side="right")``, i.e. ``sum_e (lat >= e)``; only ``retired``
    lanes count, and a negative latency lands in bucket 0."""
    e = torch.as_tensor(edges, dtype=torch.int32, device=lat.device)
    nb = len(edges) + 1
    bucket = torch.bucketize(lat.to(torch.int32), e, right=True)
    onehot = bucket[..., None] == torch.arange(nb, device=lat.device)
    return (onehot & retired[..., None]).sum(1, dtype=torch.int32)
