"""One run of one cell: set-up, the measured window, the traced figures
and the comparison with the plain reference.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (a JSON
file of the engine's deployment: remotes, lines, line words, directory
layout, protocol) and a traffic mix (``traffic/<name>.json``: the
generator and its keywords, the ops per remote, the issue width, the
members of a fleet, the members the check compares).  The window runs
fleets of the mix through ``repro_torch.traffic.run_fleet`` back to back,
each with fresh member seeds drawn from ``--seed``, while less than
``--seconds`` of fleet time has passed.  A per-layer metric is the module
``metrics/<name>.py``, whose ``read(ctx)`` returns its value or None.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import check, roofline, trace
from .reference import engine as ref_engine
from .reference import workloads as ref_workloads

HERE = Path(__file__).resolve().parent
#: top-level module names the process may not hold once the window has
#: closed: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: steps of the fleet that warms every shape up during set-up.
WARM_STEPS = 2


#: configuration keys the harness runs, and those it only carries as
#: prose (where the numbers come from, what the run holds the program
#: to); any other key is refused.
CONFIG_KEYS = {"remotes", "lines", "block", "word_bytes", "homes",
               "protocol", "packed", "credits_per_vc"}
CONFIG_NOTES = {"name", "source", "deployment", "lines_from", "guarantees",
                "caches_start", "assumed", "reduced"}
#: traffic-mix keys the harness runs, and its prose keys.
MIX_KEYS = {"loop", "members", "generator", "params", "ops", "width",
            "check_members"}
MIX_NOTES = {"name", "source", "mapping", "members_why", "assumed",
             "reduced", "why"}


def _keys(what: str, d: dict, run: set, notes: set) -> None:
    if set(d) - run - notes or run - set(d):
        raise SystemExit(f"{what}: keys {sorted(set(d) - run - notes)} are "
                         f"not read, {sorted(run - set(d))} are missing")


class Cell:
    """A workload entry of ``BENCHMARK.json`` with its configuration and
    traffic mix read from their files: one home under full MOESI, a
    closed loop of seeded streams."""

    def __init__(self, bench: dict, name: str, root: Path = HERE.parent):
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; have "
                             f"{sorted(work)}")
        entry = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        self.cfg = json.loads((root / conf["file"]).read_text())
        self.mix = json.loads((root / HERE.name / "traffic" /
                               f"{entry['traffic']}.json").read_text())
        _keys(conf["file"], self.cfg, CONFIG_KEYS, CONFIG_NOTES)
        _keys(entry["traffic"], self.mix, MIX_KEYS, MIX_NOTES)
        if (self.cfg["protocol"], self.cfg["homes"], self.cfg["word_bytes"],
                self.mix["loop"]) != ("full_moesi", 1, 4, "closed"):
            raise SystemExit("the fleet cells run one home under full MOESI "
                             "on 4-byte words, in a closed loop")
        self.chips = int(entry["chips"])
        self.R, self.L = int(self.cfg["remotes"]), int(self.cfg["lines"])
        self.B = int(self.cfg["block"])
        self.packed = bool(self.cfg["packed"])
        self.M = int(self.mix["members"])
        self.ops = int(self.mix["ops"])
        self.width = int(self.mix["width"])
        self.params = dict(self.mix["params"])
        self.steps = ref_engine.default_steps(self.ops, self.R)

    def fleet(self, seeds: List[int], steps: int = 0):
        """The program's ``FleetConfig`` of one member per seed."""
        from repro_torch.traffic import (EngineConfig, FleetConfig,
                                         StreamConfig, WorkloadSpec)
        eng = EngineConfig(remotes=self.R, lines=self.L, block=self.B,
                           subset=self.cfg["protocol"],
                           credits=int(self.cfg["credits_per_vc"]),
                           packed=self.packed)
        return FleetConfig(members=tuple(
            (eng, StreamConfig(workload=WorkloadSpec(
                self.mix["generator"], ops=self.ops, seed=s,
                params=self.params), width=self.width, collect_trace=True))
            for s in seeds), steps=steps or self.steps)


def load_benchmark(root: Path = HERE.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def member_seeds(seed: int, run: int, n: int) -> List[int]:
    """The member seeds of the window's ``run``-th fleet."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, run])
    return [int(s) for s in ss.generate_state(n)]


def program_records(runs, R: int) -> List[Dict[str, np.ndarray]]:
    return [check.record(r.state, r.counters, r.msg_count, r.payload_msgs,
                         r.trace.retire_step, r.completed, R)
            for r in runs]


def reference_records(cell: Cell, seeds: List[int], device,
                      control: str = "") -> List[Dict[str, np.ndarray]]:
    """The reference's records for members of the given seeds, in blocks
    of at most a fleet's members."""
    out = []
    for i in range(0, len(seeds), cell.M):
        block = seeds[i:i + cell.M]
        streams = [ref_workloads.stream(cell.mix["generator"], s, cell.ops,
                                        cell.R, cell.L, cell.params)
                   for s in block]
        op, line, value = (np.stack(x) for x in zip(*streams))
        res = ref_engine.run_fleet(op, line, value, [cell.width] * len(block),
                                   cell.L, cell.B, cell.steps,
                                   device=device,
                                   credits=int(cell.cfg["credits_per_vc"]),
                                   control=control)
        for j in range(len(block)):
            out.append(check.record(
                check.member(res.state, j), check.member(res.counters, j),
                res.state.msg_count[j].cpu(), res.state.payload_msgs[j],
                res.retire[j].cpu().numpy(), res.completed[j], cell.R))
        del res
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or of the JAX package, compared by whole
    top-level name."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def _metric(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"eci_bench_metric_{name}", root / HERE.name / "metrics" /
        f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def note(t_start: float, what: str) -> None:
    """A progress line on standard error, stamped with the seconds since
    the process started."""
    print(f"eci_bench {time.perf_counter() - t_start:9.3f} s: {what}",
          file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, root: Path = HERE.parent) -> dict:
    """One run of ``workload``; returns the result line's object (the
    compared numbers under ``check``, last)."""
    from repro_torch.traffic import run_fleet
    bench = load_benchmark(root)
    cell = Cell(bench, workload, root)
    dev = torch.device(device)
    torch.empty(0, device=dev)
    note(t_start, f"imports and device up ({device})")

    # ---- set-up: build, load and warm every shape up -------------------
    warm = cell.fleet(list(range(cell.M)), steps=WARM_STEPS)
    program_records(run_fleet(warm, device=dev), cell.R)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    note(t_start, f"set-up done: a {WARM_STEPS}-step fleet of {cell.M}")

    # ---- the window ----------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records: List[List[Dict[str, np.ndarray]]] = []
    seeds: List[List[int]] = []
    fleet_s = 0.0
    state_bytes = None
    while not records or fleet_s < seconds:
        k = len(records)
        seeds.append(member_seeds(seed, k, cell.M))
        t0 = time.perf_counter()
        runs = run_fleet(cell.fleet(seeds[-1]), device=dev)
        _sync(dev)
        fleet_s += time.perf_counter() - t0
        if state_bytes is None:
            state_bytes = sum(x.numel() * x.element_size()
                              for x in trace.tensors(runs[0].state)
                              if x.dim() > 0)
        records.append(program_records(runs, cell.R))
        del runs
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) \
            if dev.type == "cuda" else 0
        note(t_start, f"fleet {k} done: {fleet_s:.3f} s of fleets, "
                      f"{retries} allocator retries")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    attempted = len(records) * cell.M * cell.R * cell.ops
    retired = sum(int(r["counters.retired"].sum())
                  for rs in records for r in rs)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": attempted,
           "failed": attempted - retired}

    # ---- the per-layer figures (--trace 1) -----------------------------
    if traced:
        last = [max(int(r["retire"].max()) for r in rs) + 1 for rs in records]
        ctx = {"cell": cell, "budget": cell.steps, "last_retire": last,
               "state_bytes_per_member": state_bytes,
               "launches": roofline.step_launches(cell.M, cell.R, cell.L,
                                                  cell.packed)}
        if dev.type == "cuda":
            prof = trace.step_profile(
                lambda n: run_fleet(cell.fleet(list(range(cell.M)), steps=n),
                                    device=dev), dev)
            ctx["profile"] = prof
            device_out.update(busy_s=prof["busy_s"],
                              window_s=prof["window_s"])
            out["breakdown"] = prof["breakdown"]
        metrics = {}
        for m in bench["per_layer"]:
            value = _metric(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"ops_per_s": retired / fleet_s,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]}
    out["metrics"] = metrics
    out["device"] = device_out

    # ---- the comparison --------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pairs = [(k, i) for k in range(len(records)) for i in range(cell.M)]
    n_check = min(int(cell.mix["check_members"]), len(pairs))
    # the sample always holds the member that retired last (the longest).
    longest = max(pairs, key=lambda p: int(records[p[0]][p[1]]["retire"]
                                           .max()))
    rng = np.random.default_rng([int(seed) % 2 ** 64, 1])
    rest = [p for p in pairs if p != longest]
    pick = [longest] + [rest[j] for j in sorted(
        rng.choice(len(rest), n_check - 1, replace=False))]
    got = [records[k][i] for k, i in pick]
    note(t_start, f"reference: {len(pick)} members")
    want = reference_records(cell, [seeds[k][i] for k, i in pick], dev)
    numbers = check.compare(got, want)
    note(t_start, "compared")
    out["correct"] = check.verdict(numbers)
    out["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                    for k, v in numbers.items()}
    return out
