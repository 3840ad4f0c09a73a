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
   W=1 at the ``WorkloadSpec`` default of 128 ops per remote and W=4 at
   32 (``W4_OPS``), each with the default step budget for its ops and
   validated by the port's own ``validate_run`` against its own
   ``MultiNodeRef``, with the launch count of every kernel in that run;
4. small streams (L=16, B=4) on the card through the kernels and on the
   CPU through the plain versions — dense R=8 MESI and MOESI, packed
   two-home R=33 MESI and R=64 MOESI, two homes with ``home_bw=1``,
   shared credits: counters, message counts and retirement trace
   bit-identical, and each packed run equal to the dense run of the same
   configuration;
5. the packed two-home path at the main path's width: ``EngineConfig(
   remotes=64, lines=4096, block=32, homes=2, packed=True)``, MOESI,
   zipfian, W=1, 128 ops per remote, validated against the two-home
   oracle, with its own launch table (``packed_any`` and
   ``packed_fanout`` run only here) and the directory-state bytes of
   both layouts.

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
#: ops per remote of the dense W=4 run, cut from the ``WorkloadSpec``
#: default of 128 so that the script keeps a margin under its 1200 s
#: limit on a slow host (see PERF.md, section 4); the dense W=1 run and
#: the packed two-home run are not cut.
W4_OPS = 32

#: the packed two-home path: homes, words per line at R=64.
HOMES, NW = 2, 2

#: the Pallas kernel each CUDA kernel replaces (file:line of pallas_call).
REPLACES = {
    "credit_rank": "src/repro/kernels/coherency_step.py:99",
    "arb_winner": "src/repro/kernels/coherency_step.py:144",
    "count_fold": "src/repro/kernels/coherency_step.py:193",
    "lat_hist": "src/repro/kernels/coherency_step.py:234",
    "packed_any": "src/repro/kernels/coherency_step.py:269",
    "packed_fanout": "src/repro/kernels/coherency_step.py:320",
}
#: launches per engine step on the main path (dense, one home).
PER_STEP = {"credit_rank": 2, "arb_winner": 1, "count_fold": 5,
            "lat_hist": 1, "packed_any": 0, "packed_fanout": 0}
#: launches per engine step on the packed two-home path: absorb's
#: no-sharers test in phases 2 and 3, the pending test in phase 4 and
#: the two grant-precondition tests in phase 6 are ``packed_any``; the
#: fan-out words of phase 5 are ``packed_fanout``.
PACKED_PER_STEP = {"credit_rank": 2, "arb_winner": 1, "count_fold": 5,
                   "lat_hist": 1, "packed_any": 5, "packed_fanout": 1}
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

    # -- packed_any / packed_fanout: the packed two-home path's word
    #    planes, [H, L/H, W] int32 words with [H, L/H] per-line inputs ----
    from repro_torch.core import directory_mn as dmn
    Lh = L // HOMES
    pres = dmn.pack_mask(rand_bool((HOMES, R, Lh), 0.3))
    excl = pres & dmn.pack_mask(rand_bool((HOMES, R, Lh), 0.5))
    if tuple(pres.shape) != (HOMES, Lh, NW):
        fail(f"packed words of shape {tuple(pres.shape)}")
    sparse = pres & dmn.pack_mask(rand_bool((HOMES, R, Lh), 0.01))
    edge_words = {
        "W=1 (R=8)": dmn.pack_mask(rand_bool((8, L), 0.1)),
        "ragged W=2 (R=33)": dmn.pack_mask(rand_bool((33, L), 0.05)),
        "bit 31": torch.full((Lh, NW), -2 ** 31, dtype=torch.int32,
                             device=dev),
        "all zero": torch.zeros((HOMES, Lh, NW), dtype=torch.int32,
                                device=dev),
        "all ones": torch.full((HOMES, Lh, NW), -1, dtype=torch.int32,
                               device=dev),
    }
    cases = [("[2, 2048, 2]", K.packed_any(sparse),
              ref.packed_any_ref(sparse))]
    for what, w_ in edge_words.items():
        cases.append((what, K.packed_any(w_), ref.packed_any_ref(w_)))
    n_lines = HOMES * Lh
    record("packed_any", cases, lambda: K.packed_any(sparse),
           lambda: ref.packed_any_ref(sparse),
           lambda: torch.any(sparse, dim=-1),
           nbytes=4 * n_lines * NW + n_lines, nops=2 * n_lines * NW)

    node = torch.randint(0, R, (HOMES, Lh), generator=g,
                         dtype=torch.int32).to(dev)
    node[:, :4] = torch.tensor([0, 31, 32, 63], dtype=torch.int32,
                               device=dev)
    sh = rand_bool((HOMES, Lh), 0.3)
    ex = rand_bool((HOMES, Lh), 0.3) & ~sh
    cases = [("[2, 2048, 2]", K.packed_fanout(pres, excl, node, sh, ex),
              ref.packed_fanout_ref(pres, excl, node, sh, ex))]
    for what, w_ in edge_words.items():
        wl = w_.shape[-2]
        lead = tuple(w_.shape[:-2])
        n_ = torch.randint(0, 32 * w_.shape[-1], lead + (wl,), generator=g,
                           dtype=torch.int32).to(dev)
        s_ = rand_bool(lead + (wl,), 0.5)
        x_ = ~s_
        e_ = w_ & torch.roll(w_, 1, dims=-2)
        cases.append((what, K.packed_fanout(w_, e_, n_, s_, x_),
                      ref.packed_fanout_ref(w_, e_, n_, s_, x_)))
    ones = torch.ones((HOMES, Lh), dtype=torch.bool, device=dev)
    cases.append(("all lines requesting", K.packed_fanout(
        pres, excl, node, ones, ones), ref.packed_fanout_ref(
        pres, excl, node, ones, ones)))
    hot = ref.node_hot(node, NW)
    record("packed_fanout", cases,
           lambda: K.packed_fanout(pres, excl, node, sh, ex),
           lambda: ref.packed_fanout_ref(pres, excl, node, sh, ex),
           lambda: torch.where(sh[..., None], excl & ~hot, 0),
           nbytes=16 * n_lines * NW + 6 * n_lines,
           nops=8 * n_lines * NW)
    return {r["name"]: r for r in rows}


def check_no_host_sync(eng, ops: int, width: int, label: str) -> None:
    """The step loop makes no host synchronisation: the synchronising
    calls counted by CUDA's sync debug mode do not grow with the step
    count."""
    import torch
    from repro_torch.traffic import StreamConfig, WorkloadSpec, run_stream
    syncs = []
    for n in (2, 8, 24):        # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=ops, seed=0),
                    width=width, steps=n, collect_trace=True))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    if syncs[2] == 0:
        fail("CUDA's sync debug mode reported no synchronisation at all")
    if syncs[1] != syncs[2]:
        fail(f"{label}: the step loop synchronises with the host: "
             f"{syncs[1]} syncs in 8 steps, {syncs[2]} in 24")
    print(f"{label}: {syncs[2]} host syncs per run outside the step loop, "
          f"none inside (runs of 8 and 24 steps)")


def drive(dev, cfg_engine, width: int, ops: int, per_step, rows,
          label: str) -> None:
    """One run of ``ops`` per remote and the default step budget through
    ``run_stream``, with every launch count set to 0 just before it and
    read just after; oracle-validated, all ops retired, launches exactly
    ``per_step`` times the step count."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.traffic import (StreamConfig, WorkloadSpec,
                                     default_steps, run_stream, summarize,
                                     validate_run)
    steps = default_steps(ops, cfg_engine.remotes)
    eng = cfg_engine.build(dev)
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=ops, seed=0),
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
    validate_run(run, moesi=cfg_engine.moesi, n_homes=cfg_engine.homes)
    t_val = time.perf_counter() - t1
    print(f"{label}: completed={run.completed} "
          f"ops_retired={s['ops_retired']} "
          f"ops_per_step={float(s['ops_per_step']):.6f} "
          f"steps={s['steps']} active_steps={s['active_steps']} "
          f"wall_s={wall:.3f} steps_per_s={steps / wall:.1f} "
          f"msgs={int(run.msg_count.sum())} "
          f"oracle_validate_s={t_val:.1f}")
    print(f"{label}: launches {json.dumps(counts)}")
    for name, n in counts.items():
        if n != per_step[name] * steps:
            fail(f"{label}: kernel {name}: {n} launches, expected "
                 f"{per_step[name]} x {steps}")
        rows[name]["launches"] += n
    if s["ops_retired"] != cfg_engine.remotes * ops:
        fail(f"{label}: retired {s['ops_retired']} of "
             f"{cfg_engine.remotes * ops}")


def phase_main_path(dev, rows):
    """Phase 3: the closed-loop stream at R=64, L=4096, B=32."""
    from repro_torch.traffic import EngineConfig, WorkloadSpec, \
        default_steps
    ops = WorkloadSpec().ops
    print(f"main path: zipfian R={R} L={L} B={B} (fp32, "
          f"{4 * B}-byte lines) MOESI, W=1 at {ops} ops per remote "
          f"({default_steps(ops, R)} steps, the default budget), W=4 cut "
          f"to {W4_OPS} ({default_steps(W4_OPS, R)} steps)")
    cfg = EngineConfig(remotes=R, lines=L, block=B)
    check_no_host_sync(cfg.build(dev), ops, 4, "main path")
    for width, n_ops in ((1, ops), (4, W4_OPS)):
        drive(dev, cfg, width, n_ops, PER_STEP, rows,
              f"main path W={width}")
    for name in ("credit_rank", "arb_winner", "count_fold", "lat_hist"):
        if rows[name]["launches"] == 0:
            fail(f"kernel {name} was not launched on the main path")


def phase_packed_path(dev, rows):
    """Phase 5: the packed two-home path at R=64, L=4096, B=32."""
    from repro_torch.traffic import EngineConfig, WorkloadSpec, \
        default_steps
    ops = WorkloadSpec().ops
    print(f"packed path: zipfian R={R} L={L} B={B} H={HOMES} packed "
          f"MOESI W=1, {ops} ops per remote, {default_steps(ops, R)} "
          f"steps (default budget); nothing cut")
    cfg = EngineConfig(remotes=R, lines=L, block=B, homes=HOMES,
                       packed=True)
    dense, packed = (EngineConfig(remotes=R, lines=L, block=B,
                                  packed=p).build(dev).init()
                     for p in (False, True))
    nbytes = [x.hreq_pending.nbytes + x.dir.view.nbytes
              for x in (dense, packed)]
    print(f"packed path: directory state (view + pending mask) "
          f"{nbytes[0]} bytes dense (2*R*L) against {nbytes[1]} packed "
          f"(16*L*W), {nbytes[0] / nbytes[1]:g}x")
    if nbytes != [2 * R * L, 16 * L * NW]:
        fail(f"directory state bytes {nbytes}")
    check_no_host_sync(cfg.build(dev), ops, 1, "packed path")
    drive(dev, cfg, 1, ops, PACKED_PER_STEP, rows, "packed path W=1")
    for name in ("packed_any", "packed_fanout"):
        if rows[name]["launches"] == 0:
            fail(f"kernel {name} was not launched on the packed path")


def _same_run(a, b) -> bool:
    import numpy as np
    import torch
    return (np.array_equal(a.msg_count, b.msg_count)
            and a.payload_msgs == b.payload_msgs
            and np.array_equal(a.trace.retire_step, b.trace.retire_step)
            and all(torch.equal(x.cpu(), y.cpu())
                    for x, y in zip(a.counters, b.counters)))


def phase_small_stream(dev):
    """Phase 4: the card's kernel runs equal the CPU's plain runs, and
    each packed run equals the dense run of its configuration."""
    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, run_stream,
                                     validate_run)

    # (ops per remote, engine options); the wide packed streams take 8
    # ops, since their step budget grows with R * ops and each runs three
    # times (card, CPU, and dense on the card).
    cases = [
        (32, dict(remotes=8, moesi=False)),
        (32, dict(remotes=8, moesi=True)),
        (8, dict(remotes=33, homes=2, packed=True, moesi=False)),
        (8, dict(remotes=64, homes=2, packed=True, moesi=True)),
        (32, dict(remotes=8, homes=2, home_bw=1)),
        (32, dict(remotes=8, shared_credits=True, credits=4)),
    ]
    for ops, kw in cases:
        cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=ops, seed=3),
                           width=2, collect_trace=True)
        gpu, cpu = (run_stream(EngineConfig(lines=16, block=4, **kw)
                               .build(d), cfg) for d in (dev, "cpu"))
        if not _same_run(gpu, cpu):
            fail(f"small stream {kw}: card and CPU differ")
        if kw.get("packed"):
            dense_kw = dict(kw, packed=False)
            dense = run_stream(EngineConfig(lines=16, block=4, **dense_kw)
                               .build(dev), cfg)
            if not _same_run(gpu, dense):
                fail(f"small stream {kw}: packed and dense runs differ")
        validate_run(gpu, moesi=kw.get("moesi", True),
                     n_homes=kw.get("homes", 1))
        print(f"small stream {json.dumps(kw)} ops={ops}: card == CPU "
              f"(counters, msg_count {int(gpu.msg_count.sum())}, payload "
              f"{gpu.payload_msgs}, trace)"
              f"{', == dense' if kw.get('packed') else ''}, "
              f"oracle-validated")


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
    phase_packed_path(dev, rows)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
