"""The comparison that decides ``correct``: every compared member of the
window's fleets against the plain reference, exactly.

A member's record holds, as host arrays: its final engine state (every
leaf; a packed directory's word planes unpacked to the dense views they
encode, and each ``[R, L, B]`` line-data plane as one checksum per
remote), its messages delivered by type and those carrying data, its
counters, its retirement trace and whether it completed.  The numbers
compared count the members whose records differ in each part; each
limit is 0, since the engine is integer and deterministic.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

#: compared number -> its limit (members that may differ).
LIMITS = {"state_mismatch": 0, "messages_mismatch": 0,
          "retirement_mismatch": 0, "counters_mismatch": 0,
          "completion_mismatch": 0}
_PART = {"state": "state_mismatch", "msg_count": "messages_mismatch",
         "payload_msgs": "messages_mismatch",
         "retire": "retirement_mismatch", "counters": "counters_mismatch",
         "completed": "completion_mismatch"}


def unpack(words: torch.Tensor, n_remotes: int) -> torch.Tensor:
    """``[..., L, W]`` int32 bit words -> ``[..., R, L]`` bool: bit
    ``r % 32`` of word ``r // 32`` is remote ``r``."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1            # [..., L, W, 32]
    bits = bits.flatten(-2)[..., :n_remotes]          # [..., L, R]
    return bits.movedim(-1, -2) != 0


def dense_view(words: torch.Tensor, n_remotes: int) -> torch.Tensor:
    """A packed ``[2, L, W]`` view (present, exclusive) as dense int8
    views: EM where exclusive, S where present, else I."""
    pres = unpack(words[..., 0, :, :], n_remotes)
    excl = unpack(words[..., 1, :, :], n_remotes)
    return torch.where(excl, 2, torch.where(pres, 1, 0)).to(torch.int8)


def dense_pending(words: torch.Tensor, n_remotes: int) -> torch.Tensor:
    """A packed ``[2, L, W]`` pending mask (recall, invalidate) as the
    dense int8 plane of the downgrade codes (6, 7)."""
    recall = unpack(words[..., 0, :, :], n_remotes)
    inval = unpack(words[..., 1, :, :], n_remotes)
    return torch.where(recall, 6, torch.where(inval, 7, 0)).to(torch.int8)


def checksum(x: torch.Tensor) -> torch.Tensor:
    """``[R, L, B]`` float32 -> ``[R]`` int64: the words' bits weighted by
    position (wrapping int64 arithmetic; any change of one word moves
    its remote's sum)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    B, L = bits.shape[-1], bits.shape[-2]
    wb = torch.arange(B, device=x.device, dtype=torch.int64) * 2 + 1
    wl = torch.arange(L, device=x.device, dtype=torch.int64) * 2 + 1
    return ((bits * wb).sum(-1) * wl * 2654435761).sum(-1)


def _leaves(tree, prefix: str, n_remotes: int, out: Dict[str, torch.Tensor]):
    for name in tree._fields:
        x = getattr(tree, name)
        key = f"{prefix}.{name}"
        if isinstance(x, tuple):
            _leaves(x, key, n_remotes, out)
        elif x.dtype == torch.int32 and name in ("view", "hreq_pending") \
                and x.dim() == 3 and x.shape[0] == 2:
            out[key] = (dense_view if name == "view" else dense_pending)(
                x, n_remotes)
        elif x.is_floating_point() and x.dim() == 3 \
                and x.shape[0] == n_remotes:
            out[key] = checksum(x)
        else:
            out[key] = x


def record(state, counters, msg_count, payload_msgs, retire, completed,
           n_remotes: int) -> Dict[str, np.ndarray]:
    """One member's record as host arrays; ``state`` and ``counters`` are
    the member's trees (named tuples of tensors, no member axis)."""
    leaves: Dict[str, torch.Tensor] = {}
    _leaves(state, "state", n_remotes, leaves)
    _leaves(counters, "counters", n_remotes, leaves)
    rec = {k: v.cpu().numpy() for k, v in leaves.items()}
    rec["msg_count"] = np.asarray(msg_count, np.int64).reshape(-1)
    rec["payload_msgs"] = np.asarray([int(payload_msgs)], np.int64)
    rec["retire"] = np.asarray(retire)
    rec["completed"] = np.asarray([bool(completed)])
    return rec


def member(tree, i: int):
    """Member ``i`` of a tree with a leading member axis (0-dim leaves
    are shared)."""
    if isinstance(tree, tuple):
        return type(tree)(*(member(x, i) for x in tree))
    return tree if tree.dim() == 0 else tree[i]


def compare(got: List[Dict[str, np.ndarray]],
            want: List[Dict[str, np.ndarray]]) -> Dict[str, int]:
    """Members whose records differ, per compared number."""
    out = dict.fromkeys(LIMITS, 0)
    for g, w in zip(got, want):
        bad = set()
        for key in set(g) | set(w):
            a, b = g.get(key), w.get(key)
            if a is None or b is None or a.shape != b.shape or \
                    not np.array_equal(a, b):
                bad.add(_PART[key.split(".")[0]])
        for name in bad:
            out[name] += 1
    return out


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
