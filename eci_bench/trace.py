"""The traced figures of a fleet step, from ``torch.profiler``'s device
trace and the host's clock.

A step's figures are the difference between two profiled fleets of the
cell's members that run ``lo`` and ``hi`` steps, over ``hi - lo``, so
the fleet's preparation and read-out cancel; the wall times are of the
same profiled runs, so the idle share compares like with like.  The
profiler keeps only part of the records of kernels launched through
``ctypes`` (0.67-0.95 of them seen on an H100), so a step kernel's
device operations are its launches as the program counts them
(``kernels.coherency_step.launches``), each at the mean duration of its
kept records, and its roofline share is taken over the kept records
alone.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

from . import roofline

#: the two step budgets whose difference gives one step.
PROFILE_STEPS = (16, 48)
#: breakdown entries kept (the driver takes at most 10 of each list).
TOP = 10
#: characters kept of a device operation's name (kernel names run to
#: thousands).
NAME_CHARS = 160
#: the longest idle gaps that are labelled by the host's operation.
GAPS_LABELLED = 200


def tensors(tree):
    """Every tensor leaf of a tree of named tuples."""
    if isinstance(tree, tuple):
        for x in tree:
            yield from tensors(x)
    else:
        yield tree


def _kernel_of(name: str):
    for k in roofline.KERNELS:
        if f"{k}_kernel" in name:
            return k
    return None


def _profiled(fn: Callable[[], object], dev) -> Tuple[List, List, float,
                                                      Dict[str, int]]:
    """(device events as (name, start_us, end_us), host events likewise,
    wall s, program launch counts) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import coherency_step as K
    torch.cuda.synchronize(dev)
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    launches = dict(K.launches)
    on_dev, on_host = [], []
    # the raw records: building the profiler's event tree takes minutes
    # at a fleet step's hundreds of thousands of operations.
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e3
        row = (ev.name(), s, s + ev.duration_ns() / 1e3)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            on_dev.append(row)
        else:
            on_host.append(row)
    return on_dev, on_host, wall, launches


def _tally(on_dev, launches) -> Dict[str, object]:
    """Device operations and device us of a profiled call (other
    operations as recorded, step kernels at their launch counts), and
    each step kernel's kept records and their device us."""
    ops, us = 0.0, 0.0
    kern: Dict[str, List[float]] = {}
    for name, s, e in on_dev:
        k = _kernel_of(name)
        if k is None:
            ops += 1
            us += e - s
        else:
            kern.setdefault(k, []).append(e - s)
    for k, durs in kern.items():
        n = launches.get(k, len(durs))
        ops += n
        us += n * sum(durs) / len(durs)
    return {"ops": ops, "us": us,
            "kernels": {k: (len(d), sum(d)) for k, d in kern.items()}}


def _busy(on_dev) -> float:
    """Seconds in which some device operation ran (union of records)."""
    spans = sorted((s, e) for _, s, e in on_dev)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def breakdown(on_dev, on_host) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device operations by the innermost host operation
    running at each gap's middle, in seconds."""
    per: Dict[str, float] = {}
    for name, s, e in on_dev:
        name = name[:NAME_CHARS]
        per[name] = per.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    spans = sorted((s, e) for _, s, e in on_dev)
    gaps = []
    reach = None
    for s, e in spans:
        if reach is not None and s > reach:
            gaps.append((s - reach, reach, s))
        reach = e if reach is None else max(reach, e)
    gaps.sort(reverse=True)
    host = sorted((s, e, name) for name, s, e in on_host)
    starts = [h[0] for h in host]
    labels: Dict[str, float] = {}
    for dur, a, b in gaps[:GAPS_LABELLED]:
        mid = (a + b) / 2
        label = "host idle"
        # host operations nest, so the latest-starting one that still
        # runs at ``mid`` is the innermost.
        for s, e, name in reversed(host[:bisect.bisect_right(starts, mid)]):
            if e >= mid:
                label = name
                break
        labels[label] = labels.get(label, 0.0) + dur / 1e6
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def step_profile(run_n: Callable[[int], object], dev) -> dict:
    """The figures of one fleet step; ``run_n(n)`` runs the cell's fleet
    for ``n`` steps."""
    lo, hi = PROFILE_STEPS
    _profiled(lambda: run_n(lo), dev)   # the profiler's own first start
    shots = {n: _profiled(lambda n=n: run_n(n), dev) for n in (lo, hi)}
    tallies = {n: _tally(shots[n][0], shots[n][3]) for n in (lo, hi)}
    steps = hi - lo
    on_dev, on_host, wall_hi, _ = shots[hi]
    return {
        "ops_per_step": (tallies[hi]["ops"] - tallies[lo]["ops"]) / steps,
        "device_ms_per_step": (tallies[hi]["us"] - tallies[lo]["us"])
        / steps / 1e3,
        "wall_ms_per_step": (shots[hi][2] - shots[lo][2]) / steps * 1e3,
        "busy_ms_per_step": (_busy(on_dev) - _busy(shots[lo][0])) / steps
        * 1e3,
        # kernel -> (kept records, their device us)
        "kernel_records": tallies[hi]["kernels"],
        "busy_s": _busy(on_dev), "window_s": wall_hi,
        "breakdown": breakdown(on_dev, on_host),
    }
