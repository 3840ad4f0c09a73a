"""Operator pushdown: run the operator at the data's home, move only the
matches (paper §3.4 and §5, Figs. 3/4).

The port of ``repro.core.pushdown``.  There a ``shard_map`` over a mesh
axis gives each *home shard* its rows, runs the operator there and
gathers the compacted matches; here the mesh is a list of devices and the
shard map a loop over it:

* shard ``s`` holds the ``s``-th contiguous block of rows (what
  ``P(axis, None)`` gives) and runs its hot loop through
  ``kernels.ops`` — the CUDA kernel on the card, the plain version on the
  CPU, so ``["cpu"] * S`` holds an ``S``-shard combine on one host;
* ``all_gather`` stacks the per-shard results on the first device, and
  ``psum`` is a sum there.

A device may appear in the list once, as in a mesh, except the CPU.
``devices=None`` takes every CUDA device and raises without one.  All
outputs have a fixed capacity with explicit counts, the FIFO-with-
occupancy structure of the paper's operator interface (Fig. 3); they
equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..nmp.dfa import dfa_tables, field_bytes
from ..nmp.kvstore import as_records, chain_links, chains_to, fib_hash, \
    key_bits
from ..nmp.regex import DFA
from ..nmp.select import compact, scalar


class PushdownResult(NamedTuple):
    """Fixed-capacity gathered matches, per-shard counts, rows moved."""

    rows: torch.Tensor        # [n_shards, capacity, row_width]
    counts: torch.Tensor      # [n_shards] int32
    moved_rows: torch.Tensor  # [] int32 — rows that crossed the interconnect


def shard_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a shard map: ``None`` is every CUDA device (raising
    without one); a CUDA device named twice raises, since no mesh holds a
    device twice."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("pushdown: no devices given")
    cuda = [torch.device("cuda", d.index if d.index is not None
                         else torch.cuda.current_device())
            for d in devs if d.type == "cuda"]
    if len(set(cuda)) != len(cuda):
        raise ValueError(f"pushdown: a CUDA device appears twice in "
                         f"{devs}; a mesh holds each device once")
    return devs


def _row_shards(table: torch.Tensor, devs: Sequence[torch.device]
                ) -> List[torch.Tensor]:
    n, S = table.shape[0], len(devs)
    if n % S:
        raise ValueError(f"pushdown: {n} rows do not split over {S} shards")
    per = n // S
    return [table[s * per:(s + 1) * per].to(d) for s, d in enumerate(devs)]


def _gather(packs: Sequence[torch.Tensor], counts: Sequence[torch.Tensor],
            dev: torch.device) -> PushdownResult:
    """``all_gather`` onto the first device, and the moved-row total."""
    counts = torch.stack([c.to(dev) for c in counts])
    rows = packs[0].unsqueeze(0) if len(packs) == 1 else \
        torch.stack([p.to(dev) for p in packs])
    return PushdownResult(rows, counts, counts.sum(dtype=torch.int32))


def stitch(packed: torch.Tensor, counts: torch.Tensor, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [capacity, w], count [] int32) from per-block compacted rows
    ``packed`` [blocks, block_rows, w] and their ``counts``: the blocks'
    matches in block order, zeros past the count.  An exclusive cumsum of
    the counts places each block; a gather of the matches kept (their
    number is one host sync) fills the output."""
    nb, br, w = packed.shape
    ends = torch.cumsum(counts.to(torch.int64), 0)
    live = min(int(ends[-1]), capacity)
    slot = torch.arange(live, device=packed.device)
    blk = torch.searchsorted(ends, slot, right=True)
    src = blk * br + slot - (ends[blk] - counts[blk])
    rows = packed.new_zeros((capacity, w))
    rows[:live] = packed.reshape(nb * br, w)[src]
    return rows, ends[-1].to(torch.int32)


def select_shard(tbl: torch.Tensor, capacity: int, x, y
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One home shard's SELECT: (its matches stitched into ``capacity``
    rows, their count [] int32) — ``ops.select`` over its rows, one
    ``select_scan`` launch on the card; ``capacity`` 0 is every row of
    the shard."""
    n = tbl.shape[0]
    cap = capacity or n
    if not 0 < cap <= n:
        raise ValueError(f"pushdown_select: capacity {cap} must be in "
                         f"[1, {n}], the rows of a shard")
    packed, cnt = ops.select(tbl, x, y)
    pad = packed.shape[0] * packed.shape[1] - n
    fill = scalar(ops.pad_fill(tbl.dtype), tbl.dtype)
    if pad and bool((fill > scalar(x, tbl.dtype))
                    & (fill < scalar(y, tbl.dtype))):
        # the padding rows matched (x below the fill, as x = -inf is):
        # they sit last in the last block, after its real matches.
        cnt = cnt.clone()
        cnt[-1] -= pad
    return stitch(packed, cnt, cap)


def pushdown_select(devices: Optional[Sequence], capacity: int,
                    table: torch.Tensor, x, y) -> PushdownResult:
    """Distributed SELECT: each home shard filters its rows
    (``select_shard``), stitches its blocks' matches into ``capacity``
    rows, and the matches are gathered.  Rows split over ``devices`` in
    contiguous blocks; ``capacity`` 0 is every row of a shard."""
    devs = shard_devices(devices)
    packs, counts = [], []
    for tbl in _row_shards(table, devs):
        rows, count = select_shard(tbl, capacity, x, y)
        packs.append(rows)
        counts.append(count)
    return _gather(packs, counts, devs[0])


def pushdown_regex(devices: Optional[Sequence], capacity: int, dfa: DFA,
                   table: torch.Tensor, str_lo: int,
                   str_hi: int) -> PushdownResult:
    """Distributed REGEXP_LIKE filter (paper §5.6): each home shard runs
    ``ops.regex_match`` over its rows' string columns ``[str_lo, str_hi)``
    and compacts its matching rows stably; ``capacity`` 0 is every row of
    a shard.  A uint8 table's field is read where it lies, with no copy;
    another dtype is cast to uint8 by ``nmp.dfa.field_bytes``, which
    saturates a float."""
    devs = shard_devices(devices)
    packs, counts = [], []
    for tbl in _row_shards(table, devs):
        trans, accept = dfa_tables(dfa, tbl.device)
        strings = field_bytes(tbl[:, str_lo:str_hi])   # uint8: in place
        packed, count = compact(tbl, ops.regex_match(trans, accept, strings),
                                capacity)
        packs.append(packed)
        counts.append(count)
    return _gather(packs, counts, devs[0])


class ShardedKVS(NamedTuple):
    """KVS sharded by bucket: leading dim = shard (paper Fig. 4's parallel
    operators, each with its own DRAM controller)."""

    heads: torch.Tensor    # [S, buckets_per_shard] int32 (local entry idx)
    keys: torch.Tensor     # [S, cap] int32 (uint32 bits)
    values: torch.Tensor   # [S, cap, v_width]
    nxt: torch.Tensor      # [S, cap] int32
    n_buckets: int         # global bucket count
    # build_sharded_kvs gives keys and nxt as the columns of one [S, cap, 2]
    # tensor (nmp.kvstore.as_records).


def build_sharded_kvs(keys, values, n_buckets: int, n_shards: int,
                      device=None) -> ShardedKVS:
    """The reference's host-side build, vectorised: bucket ``b`` lives on
    shard ``b % n_shards`` as local bucket ``b // n_shards``; each shard
    holds its entries in global order, chained head = newest; zero keys
    and values and nil pointers pad every shard to the largest one's
    count.  Identical arrays to the reference's, ``keys`` and ``nxt`` as
    records."""
    dev = resolve_device(device)
    k = key_bits(keys, dev)
    vals = torch.as_tensor(values).to(dev)
    b = fib_hash(k, n_buckets).to(torch.int64)
    shard = b % n_shards
    order = torch.sort(shard, stable=True)[1]          # shard, then entry
    per = torch.bincount(shard, minlength=n_shards)
    cap = max(int(per.max()) if k.numel() else 0, 1)
    start = torch.cumsum(per, 0) - per
    local = torch.empty_like(order)                    # j of each entry
    local[order] = torch.arange(k.numel(), device=dev) - start[shard[order]]
    flat = shard * cap + local                         # [S * cap] slot
    bps = n_buckets // n_shards
    if k.numel() and int(b.max()) >= bps * n_shards:
        raise IndexError(f"build_sharded_kvs: an entry's bucket lies past "
                         f"the {bps} buckets of each of {n_shards} shards")
    heads_g, nxt_g = chain_links(b, n_buckets)
    heads = torch.full((n_shards, bps), -1, dtype=torch.int32, device=dev)
    gb = torch.arange(n_buckets, device=dev)
    own = heads_g >= 0
    heads[gb[own] % n_shards, gb[own] // n_shards] = \
        local[heads_g[own].to(torch.int64)].to(torch.int32)
    nxt = torch.full((n_shards * cap,), -1, dtype=torch.int32, device=dev)
    linked = nxt_g >= 0
    nxt[flat[linked]] = local[nxt_g[linked].to(torch.int64)].to(torch.int32)
    kk = torch.zeros(n_shards * cap, dtype=torch.int32, device=dev)
    kk[flat] = k
    vv = torch.zeros((n_shards * cap,) + tuple(vals.shape[1:]),
                     dtype=vals.dtype, device=dev)
    vv[flat] = vals
    kk, nxt = as_records(kk.reshape(n_shards, cap),
                         nxt.reshape(n_shards, cap))
    return ShardedKVS(heads, kk,
                      vv.reshape((n_shards, cap) + tuple(vals.shape[1:])),
                      nxt, n_buckets)


def pushdown_lookup(devices: Optional[Sequence], kvs: ShardedKVS,
                    queries: torch.Tensor, max_chain: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed pointer chase: queries are broadcast, each home shard
    walks the chains of the buckets it owns (``ops.probe``), and the
    answers combine by a sum, since one shard answers each query.

    ``queries`` are uint32 keys (numpy) or their int32 bits.  Returns
    (values [q, v_width], found [q] bool, steps [q] int32 — per-query
    pointer hops, the DRAM accesses of the paper's Fig. 6).
    """
    devs = shard_devices(devices)
    S = len(devs)
    if kvs.heads.shape[0] != S:
        raise ValueError(f"pushdown_lookup: {kvs.heads.shape[0]} shards "
                         f"over {S} devices")
    bps = kvs.heads.shape[1]
    parts = []
    for s, dev in enumerate(devs):
        heads = kvs.heads[s].to(dev)
        if S > 1:
            # shard s answers bucket b iff b % S == s, from its local head
            # b // S (clamped into range, as the reference's gather is):
            # one head per global bucket, nil elsewhere, so the probe's own
            # fib_hash % n_buckets finds it.
            gb = torch.arange(kvs.n_buckets, device=dev)
            heads = torch.where(gb % S == s,
                                heads[(gb // S).clamp(max=bps - 1)], -1)
        keys, nxt = chains_to(kvs.keys[s], kvs.nxt[s], dev)
        found_idx, steps = ops.probe(heads, keys, nxt,
                                     key_bits(queries, dev),
                                     max_chain=max_chain)
        found = found_idx >= 0
        vals = torch.where(
            found[:, None],
            kvs.values[s].to(dev)[found_idx.clamp(min=0).to(torch.int64)], 0)
        parts.append((vals, found.to(torch.int32), steps))
    home = devs[0]
    vals, found, steps = (p.to(home) for p in parts[0])
    for v, f, st in parts[1:]:
        vals, found, steps = vals + v.to(home), found + f.to(home), \
            steps + st.to(home)
    return vals, found > 0, steps


def bulk_transfer_bytes(table: torch.Tensor) -> int:
    """Bytes the classical bulk-offload model would move (the baseline of
    the paper's Fig. 5)."""
    return int(np.prod(table.shape)) * table.element_size()


def pushdown_bytes(result: PushdownResult, row_width: int,
                   itemsize: int) -> int:
    """Bytes the pushdown moved (the matches only)."""
    return int(result.moved_rows) * row_width * itemsize
