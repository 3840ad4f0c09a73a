"""The program's own spans (``repro_torch.spans``) in a traced run: the
device time of each phase of a fleet step, the step loop's memory
scratch and the set-up's warm-up fleet.

``read(ctx)`` measures once per traced run on the card (``ctx`` holds a
``profile``) and keeps in ``ctx["spans"]``:

* ``fleet``: ``spans.summary()`` of one unprofiled fleet of the cell's
  members, ``trace.PROFILE_STEPS[1]`` steps, with device-mode spans (CUDA
  events, so the step kernels the profiler drops are counted);
* ``warmup``: the set-up's warm-up fleet with host-mode spans, run as the
  set-up runs it but in a fresh process, since this process's set-up ran
  with tracing off: its ``spans`` summary, ``up_s`` (process start to
  imports and device up) and ``setup_s`` (to the end of the warm-up);
* ``idle_gaps``: a profiled fleet of as many steps with host-mode spans,
  its idle gaps labelled by the innermost host range (``trace.breakdown``),
  so a gap outside every operation carries the program's span; and
  ``mirrored``, the device records named like a span that the profiler
  mirrors from the ranges, which are dropped before the breakdown.

A program without ``repro_torch.spans`` gives None and runs nothing.  The
figures are also printed to standard error.
"""
from __future__ import annotations

import importlib.util
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import trace

ROOT = Path(__file__).resolve().parent.parent
#: the longest the warm-up's process may take (imports, card, fleet).
WARMUP_TIMEOUT_S = 600


def read(ctx) -> Optional[dict]:
    """The run's span figures (see the module's docstring), measured at
    the first call, or None off the card or without the program's
    spans."""
    if "spans" not in ctx:
        ctx["spans"] = None
        if ctx.get("profile") is not None and \
                importlib.util.find_spec("repro_torch.spans") is not None:
            ctx["spans"] = measure(ctx["cell"], torch.device("cuda"))
            print(report(ctx["spans"]), file=sys.stderr, flush=True)
    return ctx["spans"]


def program_device_records(on_dev: List, names) -> List:
    """The device records of ``on_dev`` less those named like one of the
    program's spans (the profiler's device-side mirrors of its ranges)."""
    return [r for r in on_dev if r[0] not in names]


def measure(cell, dev) -> dict:
    from repro_torch import spans
    from repro_torch.traffic import run_fleet
    steps = trace.PROFILE_STEPS[1]

    def fleet():
        run_fleet(cell.fleet(list(range(cell.M)), steps=steps), device=dev)

    out = {"steps": steps}
    spans.reset()
    spans.enable(device=True)
    try:
        fleet()
    finally:
        spans.disable()
    out["fleet"] = spans.summary()
    spans.reset()
    spans.enable()
    try:
        on_dev, on_host, _, _ = trace._profiled(fleet, dev)
    finally:
        spans.disable()
    names = set(spans.summary())
    spans.reset()
    kept = program_device_records(on_dev, names)
    out["mirrored"] = len(on_dev) - len(kept)
    out["idle_gaps"] = trace.breakdown(kept, on_host)["idle_gaps"]
    if dev.type == "cuda":
        # the warm-up's process needs the card's memory this one caches.
        torch.cuda.empty_cache()
    out["warmup"] = warmup(cell, dev)
    return out


def warmup(cell, dev) -> dict:
    """The set-up's warm-up fleet on ``dev`` in a fresh process, with
    host-mode spans."""
    from eci_bench import harness
    warm = cell.fleet(list(range(cell.M)), steps=harness.WARM_STEPS)
    code = ("import time; t = time.perf_counter(); import sys; "
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            "from eci_bench import program_spans; "
            "program_spans.warmup_child(t)")
    proc = subprocess.run([sys.executable, "-c", code],
                          input=pickle.dumps((warm, cell.R, str(dev))),
                          capture_output=True, timeout=WARMUP_TIMEOUT_S,
                          cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the warm-up fleet's process exited "
                           f"{proc.returncode}:\n"
                           f"{proc.stderr.decode()[-4000:]}")
    return json.loads(proc.stdout.decode().strip().splitlines()[-1])


def warmup_child(t_start: float) -> None:
    """The process ``warmup`` starts: the harness's set-up (imports, the
    card, a warm-up fleet read back to the host) with host-mode spans on
    the fleet; prints one JSON line."""
    from eci_bench import harness
    from repro_torch import spans
    from repro_torch.traffic import run_fleet
    warm, R, dev = pickle.load(sys.stdin.buffer)
    dev = torch.device(dev)
    torch.empty(0, device=dev)
    up_s = time.perf_counter() - t_start
    spans.enable()
    harness.program_records(run_fleet(warm, device=dev), R)
    harness._sync(dev)
    setup_s = time.perf_counter() - t_start
    spans.disable()
    print(json.dumps({"up_s": up_s, "setup_s": setup_s,
                      "spans": spans.summary()}))


def per_step(summary: Dict[str, dict], name: str, key: str
             ) -> Optional[float]:
    """``summary[name][key]`` over the span's calls, or None."""
    s = summary.get(name)
    if s is None or s[key] is None or not s["calls"]:
        return None
    return s[key] / s["calls"]


def table(summary: Dict[str, dict]) -> List[str]:
    """One row a span: calls, and host, self, device and device-self ms a
    call; GiB allocated at entry and the peak above it (``fleet.*``)."""
    rows = [f"  {'span':18} {'parent':14} {'calls':>6} {'host':>9} "
            f"{'self':>9} {'device':>9} {'self':>9} {'entry':>8} "
            f"{'scratch':>8}"]

    def ms(v, n):
        return f"{v / n:9.3f}" if v is not None else f"{'-':>9}"

    for name, s in summary.items():
        n = s["calls"]
        mem = "" if s["mem_peak_bytes"] is None else \
            f"{s['mem_entry_bytes'] / 2 ** 30:8.3f} " \
            f"{(s['mem_peak_bytes'] - s['mem_entry_bytes']) / 2 ** 30:8.3f}"
        rows.append(f"  {name:18} {str(s['parent']):14} {n:6d} "
                    f"{ms(s['host_s'] * 1e3, n)} {ms(s['self_s'] * 1e3, n)} "
                    f"{ms(s['device_ms'], n)} {ms(s['self_ms'], n)} {mem}")
    return rows


def report(figs: dict) -> str:
    """The span figures as tables for standard error."""
    w = figs["warmup"]
    return "\n".join(
        [f"spans: a {figs['steps']}-step fleet with device-mode spans "
         f"(ms a call, GiB)"] + table(figs["fleet"])
        + [f"spans: set-up {w['setup_s']:.3f} s, imports and device up "
           f"{w['up_s']:.3f} s; the warm-up fleet with host-mode spans"]
        + table(w["spans"])
        + [f"spans: idle gaps of a profiled {figs['steps']}-step fleet "
           f"({figs['mirrored']} mirrored range records dropped): "
           + ", ".join(f"{k} {v * 1e3:.3f} ms"
                       for k, v in figs["idle_gaps"])])
