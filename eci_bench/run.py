"""Run one cell of the benchmark once and print its result line.

    python3 eci_bench/run.py --workload dense-ycsb-a-fleet40 --seed 7 \\
        --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (remote operations), the cell's end-to-end
metrics (``--trace 0``) or per-layer metrics (``--trace 1``), the device,
and last the compared numbers with their limits (also the last lines of
standard error).  Without as many CUDA devices as the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
exits 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``eci_bench``) and the program's sources, in
# place of this script's own directory.
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        from eci_bench import harness
        cell = harness.Cell(harness.load_benchmark(), args.workload)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"eci_bench: the cell needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 1
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    except (Exception, SystemExit):
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"eci_bench: modules of JAX or of the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 1
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
