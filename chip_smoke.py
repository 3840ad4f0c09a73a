#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports ``repro_torch`` from
``src/``), needs one CUDA device and ``nvcc``, and imports nothing of JAX
or of the ``repro`` package.  Phases, each of which fails the script:

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` and time the build;
2. each kernel against its plain PyTorch version on the card, bit-exact
   (``torch.equal``), at the main path's shapes and at edge cases, with
   the kernel's, the plain version's and a one-call PyTorch yardstick's
   time (CUDA events);
3. the main path: ``run_stream`` on zipfian traffic at R=64 remotes,
   L=4096 lines of B=32 fp32 words (128-byte lines), MOESI, issue width
   W=1 and W=4, the ``WorkloadSpec`` default of 128 ops per remote with
   the default step budget, each run validated by the port's own
   ``validate_run`` against its own ``MultiNodeRef``, with the launch
   count of every kernel in that run;
4. a small stream (R=8, L=16, B=4, 32 ops, MESI and MOESI) on the card
   through the kernels and on the CPU through the plain versions:
   counters, message counts and retirement trace bit-identical.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout, it exits non-zero and prints neither.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (NVIDIA data sheet), used as the
#: rate of the kernels' 32-bit integer operations.
CUDA_CORE_OPS_PER_S = 67e12

R, L, B, P = 64, 4096, 32, 65

#: the Pallas kernel each CUDA kernel replaces (file:line of pallas_call).
REPLACES = {
    "credit_rank": "src/repro/kernels/coherency_step.py:99",
    "arb_winner": "src/repro/kernels/coherency_step.py:144",
    "count_fold": "src/repro/kernels/coherency_step.py:193",
    "lat_hist": "src/repro/kernels/coherency_step.py:234",
}
#: launches per engine step on the main path (dense, one home).
PER_STEP = {"credit_rank": 2, "arb_winner": 1, "count_fold": 5,
            "lat_hist": 1}
SOURCE = "src/repro_torch/csrc/coherency_step.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def wall_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the device's time including any gaps in which
    it waits for the host to launch the next call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100):
    """(mean device time per call of ``fn`` in ms, device operations per
    call): the summed durations of the kernels and memsets it runs, from
    the profiler's CUDA trace.  Only the trace's device entries are
    summed: the entry of an aten op also carries the time of the kernels
    it launched, which have entries of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(ev.self_device_time_total for ev in on_card)
    if total_us <= 0:
        fail("the profiler recorded no device time")
    return total_us / iters / 1e3, sum(ev.count for ev in on_card) / iters


def max_abs_err(got, want) -> int:
    import torch
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase_kernels(dev):
    """Phase 2: every kernel against its plain version; timings."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.kernels import ref

    g = torch.Generator(device="cpu").manual_seed(12)

    def rand_bool(shape, p):
        return (torch.rand(shape, generator=g) < p).to(dev)

    rows = []

    def record(name, check_cases, kernel, plain, library, nbytes, nops):
        err = 0
        for what, got, want in check_cases:
            if isinstance(got, tuple):
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                e = max(max_abs_err(a.reshape(-1), b.reshape(-1))
                        for a, b in zip(got, want))
            else:
                same = torch.equal(got, want)
                e = max_abs_err(got, want)
            if not same:
                fail(f"{name} differs from its plain version ({what}), "
                     f"max abs err {e}")
            err = max(err, e)
        ms, n_ops = device_ms(kernel)
        plain_ms, plain_ops = device_ms(plain)
        lib_ms, lib_ops = (device_ms(library) if library is not None
                           else (None, 0))
        call_ms = wall_ms(kernel)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = nops / CUDA_CORE_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": lib_ms})
        print(f"kernel {name}: bit-exact on {len(check_cases)} cases; "
              f"device {ms * 1e3:.3f} us in {n_ops:g} ops (plain "
              f"{plain_ms * 1e3:.3f} us in {plain_ops:g}, library "
              f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.3f}'} us in "
              f"{lib_ops:g}, bound {max(bound_b, bound_o) * 1e3:.3f} us); "
              f"{call_ms * 1e3:.2f} us per call back to back")

    # -- credit_rank: [R, L] bool planes (the two credited submits) -------
    act = rand_bool((R, L), 0.4)
    cnd = rand_bool((R, L), 0.3) & ~act
    cases = [("R=64 L=4096", K.credit_rank(act, cnd),
              ref.credit_rank_ref(act, cnd))]
    for shape, pa, pc in (((5, 4097), 0.4, 0.3), ((3, 33), 0.5, 0.5),
                          ((R, L), 0.0, 0.0), ((1, 1), 1.0, 0.0)):
        a, c = rand_bool(shape, pa), rand_bool(shape, pc)
        cases.append((f"{shape}", K.credit_rank(a, c),
                      ref.credit_rank_ref(a, c)))
    cnd32 = cnd.to(torch.int32)
    record("credit_rank", cases, lambda: K.credit_rank(act, cnd),
           lambda: ref.credit_rank_ref(act, cnd),
           lambda: torch.cumsum(cnd32, dim=-1),
           nbytes=2 * R * L + 4 * R * L, nops=8 * R * L)

    # -- arb_winner: [P, L] ready plane, [L] pointer ------------------------
    rdy = rand_bool((P, L), 0.05)
    rdy[:, :64] = False                    # nobody ready: fill-value ties
    rr = torch.randint(0, P, (L,), generator=g, dtype=torch.int32).to(dev)
    cases = [("P=65 L=4096", K.arb_winner(rdy, rr),
              ref.arb_winner_ref(rdy, rr))]
    for shape in ((3, 17), (P, 1), (P, 4097)):
        r_ = rand_bool(shape, 0.3)
        p_ = torch.randint(0, shape[0], (shape[1],), generator=g,
                           dtype=torch.int32).to(dev)
        cases.append((f"{shape}", K.arb_winner(r_, p_),
                      ref.arb_winner_ref(r_, p_)))
    allready = torch.ones((P, L), dtype=torch.bool, device=dev)
    cases.append(("all ready", K.arb_winner(allready, rr),
                  ref.arb_winner_ref(allready, rr)))
    prio = (torch.arange(P, device=dev, dtype=torch.int32)[:, None]
            - rr[None, :]) % P
    score = torch.where(rdy, prio, torch.full_like(prio, P))
    record("arb_winner", cases, lambda: K.arb_winner(rdy, rr),
           lambda: ref.arb_winner_ref(rdy, rr),
           lambda: torch.argmin(score, dim=0),
           nbytes=P * L + 4 * L + 4 * L, nops=6 * P * L)

    # -- count_fold: [R, L] delivery planes, int8 codes --------------------
    msk = rand_bool((R, L), 0.05)
    msg = torch.randint(0, 16, (R, L), generator=g,
                        dtype=torch.int8).to(dev)
    pay = rand_bool((R, L), 0.5)
    cases = [("R=64 L=4096", K.count_fold(msk, msg, pay),
              ref.count_fold_ref(msk, msg, pay))]
    for shape, pm in (((L,), 0.5), ((7, 5), 1.0), ((R, L), 0.0)):
        m_, p_ = rand_bool(shape, pm), rand_bool(shape, 0.5)
        g_ = torch.randint(0, 16, shape, generator=g,
                           dtype=torch.int8).to(dev)
        cases.append((f"{shape}", K.count_fold(m_, g_, p_),
                      ref.count_fold_ref(m_, g_, p_)))
    home = torch.full((L,), 100, dtype=torch.int8, device=dev)
    ones = torch.ones(L, dtype=torch.bool, device=dev)
    cases.append(("HOME_TXN codes", K.count_fold(ones, home, ones),
                  ref.count_fold_ref(ones, home, ones)))
    msg64 = msg.reshape(-1).to(torch.int64)
    wts = msk.reshape(-1).to(torch.float32)
    record("count_fold", cases, lambda: K.count_fold(msk, msg, pay),
           lambda: ref.count_fold_ref(msk, msg, pay),
           lambda: torch.bincount(msg64, weights=wts, minlength=16),
           nbytes=3 * R * L + 4 * 17, nops=4 * R * L)

    # -- lat_hist: [R, L] latencies, retired lanes --------------------------
    lat = torch.randint(-4, 600, (R, L), generator=g,
                        dtype=torch.int32).to(dev)
    ret = rand_bool((R, L), 0.05)
    edges = K.LAT_EDGES
    cases = [("R=64 L=4096", K.lat_hist(lat, ret),
              ref.lat_hist_ref(lat, ret, edges))]
    neg = torch.full((3, 7), -5, dtype=torch.int32, device=dev)
    all3 = torch.ones((3, 7), dtype=torch.bool, device=dev)
    cases.append(("negative", K.lat_hist(neg, all3),
                  ref.lat_hist_ref(neg, all3, edges)))
    none = torch.zeros((R, L), dtype=torch.bool, device=dev)
    cases.append(("none retired", K.lat_hist(lat, none),
                  ref.lat_hist_ref(lat, none, edges)))
    edges_t = torch.as_tensor(edges, dtype=torch.int32, device=dev)
    record("lat_hist", cases, lambda: K.lat_hist(lat, ret),
           lambda: ref.lat_hist_ref(lat, ret, edges),
           lambda: torch.bucketize(lat, edges_t, right=True),
           nbytes=5 * R * L + 4 * R * 10, nops=20 * R * L)
    return {r["name"]: r for r in rows}


def phase_main_path(dev, rows):
    """Phase 3: the closed-loop stream at R=64, L=4096, B=32."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, default_steps,
                                     run_stream, summarize, validate_run)

    ops = WorkloadSpec().ops
    steps = default_steps(ops, R)
    print(f"main path: zipfian R={R} L={L} B={B} (fp32, "
          f"{4 * B}-byte lines) MOESI, {ops} ops per remote, "
          f"{steps} steps (default budget); nothing cut")
    # the step loop makes no host synchronisation: the synchronising calls
    # counted by CUDA's sync debug mode do not grow with the step count.
    eng = EngineConfig(remotes=R, lines=L, block=B).build(dev)
    syncs = []
    for n in (2, 8, 24):        # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=ops, seed=0),
                    width=4, steps=n, collect_trace=True))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    if syncs[2] == 0:
        fail("CUDA's sync debug mode reported no synchronisation at all")
    if syncs[1] != syncs[2]:
        fail(f"the step loop synchronises with the host: {syncs[1]} "
             f"syncs in 8 steps, {syncs[2]} in 24")
    print(f"main path: {syncs[2]} host syncs per run outside the step "
          f"loop, none inside (runs of 8 and 24 steps)")
    for width in (1, 4):
        eng = EngineConfig(remotes=R, lines=L, block=B).build(dev)
        cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=ops,
                                                 seed=0),
                           width=width, collect_trace=True)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        run = run_stream(eng, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
        s = summarize(run.counters, run.msg_count, run.payload_msgs)
        t1 = time.perf_counter()
        validate_run(run)
        t_val = time.perf_counter() - t1
        print(f"main path W={width}: completed={run.completed} "
              f"ops_retired={s['ops_retired']} "
              f"ops_per_step={float(s['ops_per_step']):.6f} "
              f"steps={s['steps']} active_steps={s['active_steps']} "
              f"wall_s={wall:.3f} steps_per_s={steps / wall:.1f} "
              f"msgs={int(run.msg_count.sum())} "
              f"oracle_validate_s={t_val:.1f}")
        print(f"main path W={width}: launches {json.dumps(counts)}")
        for name, n in counts.items():
            if n == 0:
                fail(f"kernel {name} was not launched on the main path")
            if n != PER_STEP[name] * steps:
                fail(f"kernel {name}: {n} launches, expected "
                     f"{PER_STEP[name]} x {steps}")
            rows[name]["launches"] += n
        if s["ops_retired"] != R * ops:
            fail(f"W={width}: retired {s['ops_retired']} of {R * ops}")


def phase_small_stream(dev):
    """Phase 4: the card's kernel run equals the CPU's plain run."""
    import numpy as np
    import torch
    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, run_stream,
                                     validate_run)

    for moesi in (False, True):
        cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=32, seed=3),
                           width=2, collect_trace=True)
        runs = []
        for d in (dev, "cpu"):
            eng = EngineConfig(remotes=8, lines=16, block=4,
                               moesi=moesi).build(d)
            runs.append(run_stream(eng, cfg))
        gpu, cpu = runs
        same = (np.array_equal(gpu.msg_count, cpu.msg_count)
                and gpu.payload_msgs == cpu.payload_msgs
                and np.array_equal(gpu.trace.retire_step,
                                   cpu.trace.retire_step)
                and all(torch.equal(a, b) for a, b in
                        zip(gpu.counters, cpu.counters)))
        if not same:
            fail(f"small stream (moesi={moesi}): card and CPU differ")
        validate_run(gpu, moesi=moesi)
        print(f"small stream moesi={moesi}: card == CPU (counters, "
              f"msg_count {int(gpu.msg_count.sum())}, payload "
              f"{gpu.payload_msgs}, trace), oracle-validated")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = build.build("coherency_step")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    rows = phase_kernels(dev)
    phase_main_path(dev, rows)
    phase_small_stream(dev)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
