"""Quickstart: the ECI stack end to end in the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``, on the card unless ``--device``
names another device:

1. a ``CoherentStore`` (the paper's FPGA as a smart memory controller):
   transitions and the coherent consumer cache;
2. protocol subsetting (full MOESI -> read-only -> stateless): the state
   space collapses (the paper's §3.4);
3. a pushdown SELECT (Fig. 5): bytes moved against a bulk transfer;
4. three training steps of an assigned architecture (its smoke config)
   on one device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import FULL_MOESI, SUBSETS, CoherentStore, \
    subset_metrics
from repro_torch.device import resolve_device


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. coherent store -----------------------------------------------------
    section("1. CoherentStore: coherent reads, writes, home access")
    backing = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    store = CoherentStore(backing, FULL_MOESI, device=dev)
    print("read blocks [0,1,2]:", store.read([0, 1, 2])[:, 0].tolist())
    print("  -> misses:", store.misses, "hits:", store.hits)
    print("re-read (cache hits):", store.read([0, 1, 2])[:, 0].tolist())
    print("  -> misses:", store.misses, "hits:", store.hits)
    store.write([1], torch.full((1, 4), 42.0))
    print("after consumer write, home_read(1):",
          store.home_read([1])[0].tolist())
    print("protocol messages:", store.interconnect_messages)

    # 2. specialization -----------------------------------------------------
    section("2. Protocol subsetting (paper §3.4)")
    for name, s in SUBSETS.items():
        m = subset_metrics(s)
        print(f"  {name:14s} joint_states={m['joint_states']:2d} "
              f"home_tracks_state={bool(m['home_tracks_state'])}")
    print("  -> the read-only consumer path runs with a home that keeps NO")
    print("     per-line state, yet interoperates with the full protocol.")

    # 3. pushdown SELECT ----------------------------------------------------
    section("3. SELECT pushdown (paper Fig. 5)")
    from repro_torch.core.pushdown import (bulk_transfer_bytes,
                                           pushdown_bytes, pushdown_select)
    from repro_torch.nmp import make_table
    table = make_table(0, 4096, 16, selectivity=0.05, device=dev)
    res = pushdown_select([dev], 1024, table, 0.0, 1.0)
    print(f"  matches: {int(res.moved_rows)} / {table.shape[0]} rows")
    print(f"  bytes moved:  pushdown {pushdown_bytes(res, 16, 4):,} "
          f"vs bulk {bulk_transfer_bytes(table):,}")

    # 4. train steps --------------------------------------------------------
    section("4. Train step on an assigned arch (reduced config)")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, train_step

    cfg = get_config("gemma2-9b", smoke=True)
    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    state = init_state(params)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab, 32, 4), device=dev)
    for i in range(3):
        state, m = train_step(cfg, OptimConfig(total_steps=10), 1, state,
                              pipe.batch(i))
        print(f"  step {i}: loss {float(m['loss']):.3f} "
              f"gnorm {float(m['grad_norm']):.3f}")
    print("\nquickstart done.")


if __name__ == "__main__":
    main()
