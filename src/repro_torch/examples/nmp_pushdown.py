"""Near-memory-processing pushdown: the paper's three operators end to
end (SELECT, the pointer-chasing KVS, regex), with the interconnect
economics of Fig. 5.

    PYTHONPATH=src python -m repro_torch.examples.nmp_pushdown \
        [--device cpu]

The port of ``examples/nmp_pushdown.py``: one home shard on the card
(each operator's CUDA kernel) unless ``--device`` names another device
(the plain versions on the CPU); tables and queries drawn from seeds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.pushdown import (build_sharded_kvs,
                                       bulk_transfer_bytes, pushdown_bytes,
                                       pushdown_lookup, pushdown_regex,
                                       pushdown_select)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.nmp import compile_regex, make_table
from repro_torch.nmp.dfa import dfa_tables


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)
    shards = [dev]

    # --- SELECT (paper §5.4) -----------------------------------------------
    print("=== SELECT pushdown ===")
    for sel in (0.01, 0.1, 1.0):
        table = make_table(0, 8192, 16, sel, device=dev)
        res = pushdown_select(shards, 8192, table, 0., 1.)
        moved = pushdown_bytes(res, 16, 4)
        bulk = bulk_transfer_bytes(table)
        print(f"  selectivity {sel:5.0%}: moved {moved:>9,} B "
              f"vs bulk {bulk:>9,} B  ({bulk / max(moved, 1):5.1f}x "
              f"reduction)")
    packed, counts = kops.select(make_table(1, 2048, 16, 0.1, device=dev),
                                 0.0, 1.0, block_rows=256)
    print(f"  select_scan: {int(counts.sum())} matches in "
          f"{counts.shape[0]} blocks of 256 rows")

    # --- pointer chase (paper §5.5, the negative result) -------------------
    print("=== KVS pointer chase ===")
    keys = np.arange(1, 8001, dtype=np.uint32)
    vals = np.stack([keys.astype(np.float32)] * 4, 1)
    for chain in (1, 16, 64):
        kvs = build_sharded_kvs(keys, vals, max(8000 // chain, 1), 1,
                                device=dev)
        q = np.random.RandomState(0).randint(1, 8000, 512).astype(np.uint32)
        t0 = time.perf_counter()
        v, found, steps = pushdown_lookup(shards, kvs, q,
                                          max_chain=chain + 4)
        n_found = int(found.sum())                       # waits for it
        dt = time.perf_counter() - t0
        print(f"  chain~{chain:3d}: found {n_found}/512, mean hops "
              f"{float(steps.float().mean()):5.1f}, {512 / dt:8.0f} keys/s "
              f"(throughput ~ 1/chain — Fig. 6)")

    # --- regex (paper §5.6) ------------------------------------------------
    print("=== regex pushdown ===")
    rng = np.random.RandomState(2)
    rows = rng.randint(97, 123, (4096, 32)).astype(np.uint8)
    rows[:409, :6] = np.frombuffer(b"error!", np.uint8)
    table8 = torch.as_tensor(rows).to(dev)
    dfa = compile_regex("error!")
    res = pushdown_regex(shards, 1024, dfa, table8.float(), 0, 32)
    print(f"  'error!' matches: {int(res.moved_rows)} / 4096 "
          f"(DFA states: {dfa.n_states})")
    trans, accept = dfa_tables(dfa, dev)
    m = kops.regex_match(trans, accept, table8)
    print(f"  regex_dfa agrees: {int(m.sum())} matches")
    print("done.")


if __name__ == "__main__":
    main()
