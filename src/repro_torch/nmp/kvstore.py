"""KVS pointer-chasing operator (paper §5.5), on tensors.

The port of ``repro.nmp.kvstore``: a hash table with separate chaining,
pointer = row index, -1 = nil:

    heads  [n_buckets] int32     bucket -> first (newest) entry
    keys   [n_entries] int32     the reference's uint32 keys, same bits
    values [n_entries, v_width]
    nxt    [n_entries] int32     next (older) entry of the same bucket

``keys`` and ``nxt`` hold the reference's arrays, value for value, but
the build functions lay them out as records: the two columns of one
``[n_entries, 2]`` int32 tensor (``as_records``), so an entry's key and
next pointer share one 8-byte word and the ``hash_probe`` kernel reads one
sector a hop.

PyTorch on the CPU has no uint32 shift or product, so keys are int32 with
the reference's bits (compare through ``.view``), and ``fib_hash`` works
in int64 on the unsigned value with the multiplier cut into 16-bit halves,
so that no product passes 2^48 and the uint32 wraparound is a mask.

``kvs_lookup`` walks every query's chain in lockstep: the plain version
of the ``hash_probe`` kernel that ``core.pushdown.pushdown_lookup`` runs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

#: the Fibonacci multiplier, 2^32 / golden ratio, and its 16-bit halves.
FIB = 2654435769
_FIB_HI, _FIB_LO = FIB >> 16, FIB & 0xFFFF


class KVStore(NamedTuple):
    heads: torch.Tensor    # [n_buckets] int32
    keys: torch.Tensor     # [n_entries] int32 (uint32 bits)
    values: torch.Tensor   # [n_entries, v_width]
    nxt: torch.Tensor      # [n_entries] int32


def key_bits(keys, device) -> torch.Tensor:
    """uint32 keys (numpy, a list, or a tensor of their int32 bits or of
    their int64 values) as an int32 tensor of the same bits on
    ``device``."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"keys: dtype {keys.dtype}, expected int32 "
                            f"bits or int64 values")
        return keys.to(device=device, dtype=torch.int32) \
            if keys.dtype == torch.int32 else \
            ((keys & 0xFFFFFFFF) - ((keys & 0x80000000) << 1)).to(
                device=device, dtype=torch.int32)
    k = np.asarray(keys, np.uint32).view(np.int32)
    return torch.as_tensor(k.copy()).to(device)


def fib_hash(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Fibonacci multiplicative hash: ``((key * FIB) mod 2^32 >> 16) %
    n_buckets`` on the unsigned key, as int32."""
    k = key.to(torch.int64) & 0xFFFFFFFF
    prod = (k * _FIB_LO + (((k * _FIB_HI) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return ((prod >> 16) % n_buckets).to(torch.int32)


def chain_links(bucket: torch.Tensor, n_buckets: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heads [n_buckets], nxt [n]) int32 of chains built by inserting
    entries ``0..n-1`` in order at the head of their bucket: head = the
    newest entry, ``nxt[i]`` = the previous entry of ``i``'s bucket.  A
    stable sort by bucket puts each bucket's entries in insertion order."""
    n = bucket.shape[0]
    dev = bucket.device
    b, order = torch.sort(bucket.to(torch.int64), stable=True)
    order = order.to(torch.int32)
    nxt = torch.full((n,), -1, dtype=torch.int32, device=dev)
    heads = torch.full((n_buckets,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return heads, nxt
    same = b[1:] == b[:-1]
    nxt[order[1:].to(torch.int64)] = torch.where(same, order[:-1], -1)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = ~same
    heads[b[last]] = order[last]
    return heads, nxt


def as_records(keys: torch.Tensor, nxt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, nxt) with the same values, as the two columns of one new
    ``[..., n, 2]`` tensor: the records layout."""
    rec = torch.stack((keys, nxt), -1)
    return rec[..., 0], rec[..., 1]


def records(keys: torch.Tensor, nxt: torch.Tensor
            ) -> Optional[torch.Tensor]:
    """The ``[n, 2]`` tensor whose two columns the 1-D ``keys`` and
    ``nxt`` are, or None when they are not."""
    if keys.dim() != 1 or nxt.shape != keys.shape or \
            nxt.dtype != keys.dtype or keys.stride(0) != 2 or \
            nxt.stride(0) != 2 or nxt.device != keys.device or \
            nxt.untyped_storage().data_ptr() != \
            keys.untyped_storage().data_ptr() or \
            nxt.storage_offset() != keys.storage_offset() + 1:
        return None
    return keys.as_strided((keys.shape[0], 2), (2, 1))


def chains_to(keys: torch.Tensor, nxt: torch.Tensor, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``keys`` and ``nxt`` on ``device``, still the columns of one
    tensor there when they are here."""
    rec = records(keys, nxt)
    if rec is None:
        return keys.to(device), nxt.to(device)
    rec = rec.to(device)
    return rec[:, 0], rec[:, 1]


def build_kvs(keys, values, n_buckets: int, device=None) -> KVStore:
    """The reference's host-side build, vectorised: chains in insertion
    order with head = newest; identical arrays, duplicate keys and bucket
    collisions included, ``keys`` and ``nxt`` as records."""
    dev = resolve_device(device)
    k = key_bits(keys, dev)
    heads, nxt = chain_links(fib_hash(k, n_buckets), n_buckets)
    k, nxt = as_records(k, nxt)
    return KVStore(heads, k, torch.as_tensor(values).to(dev), nxt)


def kvs_lookup(kvs: KVStore, queries: torch.Tensor, max_chain: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chase all query chains in lockstep, ``max_chain`` steps.

    ``queries`` are int32 key bits.  Returns (values [q, v_width] — zeros
    on a miss —, found [q] bool, steps [q] int32: the entries each query
    read, the quantity of the paper's Fig. 6).
    """
    found_idx, steps = walk_chains(kvs.heads, kvs.keys, kvs.nxt, queries,
                                   max_chain)
    found = found_idx >= 0
    vals = torch.where(found[:, None],
                       kvs.values[found_idx.clamp(min=0).to(torch.int64)], 0)
    return vals, found, steps


def walk_chains(heads: torch.Tensor, keys: torch.Tensor, nxt: torch.Tensor,
                queries: torch.Tensor, max_chain: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found_idx [q] int32, -1 on a miss; steps [q] int32): the lockstep
    walk of ``max_chain`` steps from each query's bucket head."""
    q = queries.to(torch.int32)
    ptr = heads[fib_hash(q, heads.shape[0]).to(torch.int64)]
    found = torch.full_like(ptr, -1)
    steps = torch.zeros_like(ptr)
    for _ in range(max_chain):
        live = (ptr >= 0) & (found < 0)
        safe = ptr.clamp(min=0).to(torch.int64)
        hit = live & (keys[safe] == q)
        found = torch.where(hit, ptr, found)
        steps = steps + live.to(torch.int32)
        ptr = torch.where(live & ~hit, nxt[safe], ptr)
    return found, steps
