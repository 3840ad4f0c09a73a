"""The comparison's readings at a cell's own size, on the card: the
control (the reference with one guarantee of the configuration broken,
put in the program's place) and, with ``--program``, the program itself,
each compared with the reference on the members of the first fleet that
a run of the seed would compare.

    python3 eci_bench/control.py --workload dense-ycsb-a-fleet40 \\
        --seeds 11 12 13 --program

One JSON line per seed: the compared numbers of the control (which has
to fail one of them) and of the program (which has to fail none).  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

#: the guarantee the control breaks: a store is granted without
#: invalidating the line's other copies (single writer).
CONTROL = "no_invalidate"


def readings(workload: str, seed: int, program: bool, device="cuda"):
    import torch
    from eci_bench import check, harness
    cell = harness.Cell(harness.load_benchmark(), workload)
    dev = torch.device(device)
    n = min(int(cell.mix["check_members"]), cell.M)
    seeds = harness.member_seeds(seed, 0, cell.M)[:n]
    t0 = time.perf_counter()
    want = harness.reference_records(cell, seeds, dev)
    out = {"workload": workload, "seed": seed, "members": n,
           "reference_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["control"] = check.compare(
        harness.reference_records(cell, seeds, dev, control=CONTROL), want)
    out["control_s"] = time.perf_counter() - t0
    if program:
        from repro_torch.traffic import run_fleet
        runs = run_fleet(cell.fleet(seeds), device=dev)
        out["program"] = check.compare(harness.program_records(runs, cell.R),
                                       want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.program)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
