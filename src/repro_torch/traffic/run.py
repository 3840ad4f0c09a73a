"""Command line for the port's streaming traffic subsystem.

    PYTHONPATH=src python -m repro_torch.traffic.run --workload zipfian \
        --remotes 4 --lines 64 --ops 128 [--validate] [--device cpu]
    PYTHONPATH=src python -m repro_torch.traffic.run --smoke --device cpu

The port of ``repro.traffic.run``, with every flag and check of the
reference but ``--kernel-backend``: ``--device`` picks where the run
goes (default ``cuda``; the CUDA kernels run there, their plain versions
on ``cpu``), and without a GPU the default exits nonzero naming
``--device cpu`` — it never falls back.

``--smoke`` runs EVERY workload generator at a small size with full
oracle validation, plus one wide case (zipfian at 8 remotes), one W=2
case, one READ_ONLY R=8 case, one H=2 case and one JSON-driven open-loop
case; each case is validated against the oracle and reports OK or FAIL
on its own line, and the exit status is nonzero on any failure.
Without it, one workload is driven at the requested size and its counter
summary printed as JSON.

``--config cfg.json`` replaces the loose flags with one ``{engine,
stream}`` JSON document (``traffic.config``); with ``--artifacts DIR`` the
resolved config is written back to ``DIR/config.json``, so any run
replays verbatim.  ``--trace``/``--check-specs``/``--trace-out``/
``--perfetto`` switch on the observability plane; ``--smoke --trace
--check-specs --artifacts DIR`` observes and checks every smoke case and
drops each case's trace JSON and Perfetto timeline, and
``smoke_metrics.json``, in DIR.  ``--mesh-devices N`` runs the stream as
a one-member fleet split across N CUDA devices (``traffic.fleet``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

#: generators that can be driven store-free (they take ``store_frac``).
STORE_FREE_CAPABLE = ("sequential", "strided", "zipfian")


def observe_specs(subset_name: str):
    """Online spec set for a run: the two full-protocol invariants, plus
    ``readonly`` when the subset guarantees it (a full-protocol stream
    violates SPEC_READONLY by design — it has writes)."""
    specs = ("req_resp", "single_writer")
    if subset_name == "read_only":
        specs = specs + ("readonly",)
    return specs


def build_configs(workload: str, n_remotes: int, n_lines: int, ops: int,
                  steps: int, seed: int, moesi: bool, width: int = 1,
                  subset_name: str = "", credits=None,
                  shared_credits: bool = False, n_homes: int = 1,
                  home_bw: int = 0, arrivals: str = "", rate: float = 0.1,
                  arrival_seed: int = 0, admit_cap: int = 0,
                  admit_reserve: int = 0, packed: bool = False):
    """THE one place loose flags map onto the config dataclasses: CLI
    flags and smoke cases funnel through here (or through
    ``config_from_json`` for ``--config`` files)."""
    from ..core.protocol import SUBSETS, LocalOp
    from .config import (AdmissionConfig, ArrivalSpec, EngineConfig,
                         StreamConfig, WorkloadSpec)
    ecfg = EngineConfig(remotes=n_remotes, lines=n_lines,
                        subset=subset_name, moesi=moesi,
                        credits=int(credits or 0),
                        shared_credits=shared_credits, homes=n_homes,
                        home_bw=home_bw, packed=packed)
    params = ()
    if subset_name and \
            int(LocalOp.STORE) not in SUBSETS[subset_name].local_ops:
        if workload not in STORE_FREE_CAPABLE:
            raise ValueError(
                f"subset '{subset_name}' admits no stores; use a "
                f"store-free generator ({', '.join(STORE_FREE_CAPABLE)})")
        params = (("store_frac", 0.0),)
    scfg = StreamConfig(
        workload=WorkloadSpec(workload, ops=ops, seed=seed, params=params),
        arrivals=(ArrivalSpec(arrivals, rate=rate, seed=arrival_seed)
                  if arrivals else None),
        admission=(AdmissionConfig(admit_cap, admit_reserve)
                   if admit_cap else None),
        width=width, steps=steps)
    return ecfg, scfg


def drive_configs(ecfg, scfg, validate: bool = False,
                  observe: bool = False, check_specs: bool = False,
                  trace_out: str = "", perfetto_out: str = "",
                  device=None):
    """Run one (EngineConfig, StreamConfig) pair end to end on ``device``
    (default ``"cuda"``): build the engine, stream, optionally
    oracle-validate, and digest the result (the resolved config rides
    along under ``"config"``)."""
    from .counters import sojourn_summary, summarize, validate_run
    from .driver import run_stream
    from .observe import ObserveConfig, write_perfetto
    if observe or check_specs or trace_out or perfetto_out:
        scfg = dataclasses.replace(scfg, observe=ObserveConfig(
            capture=bool(observe or trace_out or perfetto_out),
            specs=observe_specs(ecfg.subset) if check_specs else (),
            attribution=True))
    if validate and not scfg.collect_trace:
        scfg = dataclasses.replace(scfg, collect_trace=True)
    eng = ecfg.build(device)
    t0 = time.perf_counter()
    run = run_stream(eng, scfg)
    wall = time.perf_counter() - t0
    if validate:
        validate_run(run, eng.moesi,
                     subset=eng.subset if ecfg.subset else None,
                     n_homes=ecfg.homes)
    out = summarize(run.counters, run.msg_count, run.payload_msgs)
    out.update(workload=scfg.workload.name, n_remotes=ecfg.remotes,
               n_lines=ecfg.lines, completed=run.completed,
               wall_s=round(wall, 3), validated=bool(validate),
               width=scfg.width, subset=eng.subset.name,
               shared_credits=bool(ecfg.shared_credits),
               homes=ecfg.homes)
    try:
        out["config"] = {"engine": ecfg.to_json_dict(),
                         "stream": scfg.to_json_dict()}
    except ValueError:
        pass    # programmatic arrays / filters: config not serializable
    if run.sojourn_hist is not None:
        out["serving"] = sojourn_summary(run)
    if run.obs is not None:
        out["observability"] = run.obs.metrics()
        if trace_out:
            with open(trace_out, "w") as f:
                f.write(run.obs.trace_buffer().to_json())
        if perfetto_out:
            write_perfetto(run.obs.trace_buffer(), perfetto_out,
                           n_homes=ecfg.homes)
        if check_specs and run.obs.violations:
            raise AssertionError(
                "online protocol-spec violation(s): " + "; ".join(
                    str(v) for v in run.obs.violations))
    return out


def drive(workload: str, n_remotes: int = 4, n_lines: int = 64,
          ops: int = 128, steps: int = 0, seed: int = 0,
          moesi: bool = True, validate: bool = False,
          width: int = 1, subset_name: str = "", credits=None,
          shared_credits: bool = False, n_homes: int = 1,
          home_bw: int = 0, observe: bool = False,
          check_specs: bool = False, trace_out: str = "",
          perfetto_out: str = "", arrivals: str = "", rate: float = 0.1,
          arrival_seed: int = 0, admit_cap: int = 0,
          admit_reserve: int = 0, config_text: str = "",
          packed: bool = False, device=None):
    """Flag-style front door: map the loose knobs (or a ``--config`` JSON
    document via ``config_text``, which overrides them) onto the config
    dataclasses and run on ``device``."""
    if config_text:
        from .config import config_from_json
        ecfg, scfg = config_from_json(config_text)
    else:
        ecfg, scfg = build_configs(
            workload, n_remotes, n_lines, ops, steps, seed, moesi,
            width=width, subset_name=subset_name, credits=credits,
            shared_credits=shared_credits, n_homes=n_homes,
            home_bw=home_bw, arrivals=arrivals, rate=rate,
            arrival_seed=arrival_seed, admit_cap=admit_cap,
            admit_reserve=admit_reserve, packed=packed)
    return drive_configs(ecfg, scfg, validate=validate, observe=observe,
                         check_specs=check_specs, trace_out=trace_out,
                         perfetto_out=perfetto_out, device=device)


def smoke(observe: bool = False, check_specs: bool = False,
          artifacts: str = "", device=None) -> int:
    """Small-size full-taxonomy run with oracle validation on ``device``;
    returns the exit status.

    Besides every workload generator: one wide case (zipfian, 8 remotes),
    one W=2 case, one READ_ONLY R=8 case validated against the
    subset-aware oracle, one H=2 multi-home case, and one JSON-driven
    open-loop case (Poisson arrivals, FIFO + reserve admission, H=2).
    ``observe``/``check_specs`` switch on the observability plane for
    every case (an online spec violation fails that case); ``artifacts``
    names a directory for per-case trace JSON, Perfetto timelines and a
    combined ``smoke_metrics.json``.  Each case catches ANY exception and
    reports it as that case's FAIL line; the remaining cases still run."""
    from .workloads import WORKLOADS
    if artifacts:
        os.makedirs(artifacts, exist_ok=True)
    cases = [(name, 2, 220, 1, "", 1, "") for name in WORKLOADS]
    cases.append(("zipfian", 8, 900, 1, "", 1, ""))
    cases.append(("zipfian", 4, 500, 2, "", 1, ""))
    cases.append(("zipfian", 8, 900, 1, "read_only", 1, ""))
    cases.append(("zipfian", 8, 900, 1, "", 2, ""))
    # the --config surface: one JSON-driven OPEN-LOOP case (seeded Poisson
    # arrivals + FIFO/reserve admission, H=2) validated against the oracle.
    cases.append(("zipfian", 4, 0, 1, "", 2, json.dumps({
        "engine": {"remotes": 4, "lines": 12, "homes": 2},
        "stream": {"workload": {"name": "zipfian", "ops": 20, "seed": 7},
                   "arrivals": {"kind": "poisson", "rate": 0.1, "seed": 3},
                   "admission": {"max_inflight": 8, "reserve": 2}}})))
    failures = 0
    metrics = {}
    for name, n_remotes, steps, width, subset, homes, cfg_text in cases:
        tag = (f" {subset}" if subset else "") + \
            (f" h{homes}" if homes > 1 else "") + \
            (" config open-loop" if cfg_text else "")
        slug = f"{name}_r{n_remotes}_w{width}" + \
            (f"_{subset}" if subset else "") + \
            (f"_h{homes}" if homes > 1 else "") + \
            ("_cfg" if cfg_text else "")
        art = dict(
            trace_out=os.path.join(artifacts, f"{slug}.trace.json"),
            perfetto_out=os.path.join(artifacts, f"{slug}.perfetto.json"),
        ) if artifacts and (observe or check_specs) else {}
        try:
            out = drive(name, n_remotes=n_remotes, n_lines=12, ops=20,
                        steps=steps, seed=7, moesi=True, validate=True,
                        width=width, subset_name=subset, n_homes=homes,
                        observe=observe, check_specs=check_specs,
                        config_text=cfg_text, device=device, **art)
            metrics[slug] = out
            obs = out.get("observability", {})
            obs_tag = (f" trace={obs['captured_total']}w "
                       f"specs={len(obs['specs'])}" if obs else "")
            print(f"smoke {name} r{n_remotes} w{width}{tag}: OK "
                  f"ops={out['ops_retired']} "
                  f"max_wait={max(out['max_wait'])} "
                  f"msgs={sum(out['messages'].values())}{obs_tag}")
        except Exception as e:
            failures += 1
            print(f"smoke {name} r{n_remotes} w{width}{tag}: "
                  f"FAIL {type(e).__name__}: {e}")
    if artifacts:
        with open(os.path.join(artifacts, "smoke_metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1, default=str)
    print("smoke:", "PASS" if not failures else f"{failures} FAILURES")
    return 1 if failures else 0


def _parser() -> argparse.ArgumentParser:
    from .workloads import WORKLOADS
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.traffic.run",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", default="zipfian",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--remotes", type=int, default=4,
                    help="number of caching remotes, 1..64 (EWF v2)")
    ap.add_argument("--lines", type=int, default=64)
    ap.add_argument("--ops", type=int, default=128,
                    help="stream length per remote")
    ap.add_argument("--steps", type=int, default=0,
                    help="engine-step budget (default: scales with "
                         "remotes*ops, see traffic.default_steps)")
    ap.add_argument("--width", type=int, default=1,
                    help="per-remote issue width (default 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesi", action="store_true",
                    help="run the ENHANCED_MESI subset instead of MOESI")
    ap.add_argument("--subset", default="",
                    help="protocol subset to run (full_moesi, "
                         "enhanced_mesi, read_only, stateless); overrides "
                         "--mesi")
    ap.add_argument("--credits", type=int, default=0,
                    help="uniform per-VC credit override (0 = default 64)")
    ap.add_argument("--shared-credits", action="store_true",
                    help="home-request VC uses ONE credit pool shared "
                         "across remotes")
    ap.add_argument("--homes", type=int, default=1,
                    help="number of address-interleaved home directories "
                         "(home_of(line) = line %% homes; must divide "
                         "--lines; default 1)")
    ap.add_argument("--home-bw", type=int, default=0,
                    help="per-home per-step cap on NEW transaction "
                         "acceptances (0 = unbounded)")
    ap.add_argument("--device", default="cuda",
                    help="where the run goes: 'cuda' (default; the CUDA "
                         "kernels) or 'cpu' (their plain versions); no "
                         "fallback")
    ap.add_argument("--packed", action="store_true",
                    help="bit-packed directory planes ([2, L, ceil(R/32)] "
                         "int32 words; bit-identical results)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="run the stream as a one-member fleet split "
                         "across this many CUDA devices (0 = a plain "
                         "run)")
    ap.add_argument("--config", default="",
                    help="JSON file holding {engine: EngineConfig, "
                         "stream: StreamConfig} (overrides the loose "
                         "flags above; the resolved config is written "
                         "back into --artifacts)")
    ap.add_argument("--arrivals", default="",
                    help="OPEN-LOOP mode: arrival process (at_step0, "
                         "poisson, bursty; default closed loop)")
    ap.add_argument("--rate", type=float, default=0.1,
                    help="offered load for --arrivals, in ops per remote "
                         "per engine step (default 0.1)")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="seed for the arrival process")
    ap.add_argument("--admit-cap", type=int, default=0,
                    help="admission: max transactions in flight across "
                         "all remotes (0 = unbounded; requires "
                         "--arrivals)")
    ap.add_argument("--admit-reserve", type=int, default=0,
                    help="reserve watermark held back from new "
                         "admissions under --admit-cap")
    ap.add_argument("--validate", action="store_true",
                    help="collect the retirement trace and replay it "
                         "against the MultiNodeRef oracle")
    ap.add_argument("--smoke", action="store_true",
                    help="validated mini-run of every workload generator")
    ap.add_argument("--trace", action="store_true",
                    help="capture the in-loop EWF ring")
    ap.add_argument("--check-specs", action="store_true",
                    help="fold the online NFA protocol checkers through "
                         "the loop; any violation fails the run")
    ap.add_argument("--trace-out", default="",
                    help="write the captured EWF trace as TraceBuffer "
                         "JSON to this path (implies --trace)")
    ap.add_argument("--perfetto", default="",
                    help="write a Perfetto trace-event timeline of the "
                         "captured trace to this path (implies --trace)")
    ap.add_argument("--artifacts", default="",
                    help="directory for config.json (a single run) or, "
                         "with --smoke, per-case traces and "
                         "smoke_metrics.json")
    return ap


def main(argv=None) -> None:
    """The command line; ``argv`` defaults to ``sys.argv[1:]``."""
    import torch
    from ..core.engine_mn import MAX_REMOTES
    from ..core.protocol import SUBSETS
    from .arrivals import ARRIVALS
    ap = _parser()
    args = ap.parse_args(argv)
    if not 1 <= args.remotes <= MAX_REMOTES:
        ap.error(f"--remotes must be in 1..{MAX_REMOTES} "
                 f"(EWF v2 node-id field)")
    if args.width < 1:
        ap.error("--width must be >= 1")
    if args.subset and args.subset not in SUBSETS:
        ap.error(f"--subset must be one of {sorted(SUBSETS)}")
    if args.credits < 0:
        ap.error("--credits must be >= 0")
    if args.homes < 1:
        ap.error("--homes must be >= 1")
    if args.lines % args.homes:
        ap.error(f"--homes ({args.homes}) must divide --lines "
                 f"({args.lines}) — address interleaving shards the line "
                 f"space evenly")
    if args.home_bw < 0:
        ap.error("--home-bw must be >= 0")
    if args.mesh_devices < 0:
        ap.error("--mesh-devices must be >= 0")
    if args.mesh_devices and (
            args.arrivals or args.trace or args.check_specs or
            args.validate or args.config or args.smoke or
            args.shared_credits):
        ap.error("--mesh-devices runs the stream as a fleet member: "
                 "arrivals/observability/validate/config/smoke/"
                 "shared-credits are out of fleet scope (run them on one "
                 "device)")
    if args.arrivals and args.arrivals not in ARRIVALS:
        ap.error(f"--arrivals must be one of {sorted(ARRIVALS)}")
    if args.admit_cap and not args.arrivals:
        ap.error("--admit-cap requires --arrivals (admission gates "
                 "arrived ops)")
    if args.admit_cap < 0 or args.admit_reserve < 0 or (
            args.admit_cap and args.admit_reserve >= args.admit_cap):
        ap.error("--admit-reserve must leave room under --admit-cap")
    if args.device not in ("cuda", "cpu") and \
            not args.device.startswith("cuda:"):
        ap.error(f"--device must be 'cuda' or 'cpu', got '{args.device}'")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available; pass "
                 "--device cpu to run the plain PyTorch path on the CPU")
    if args.mesh_devices and args.device == "cpu":
        ap.error("--mesh-devices splits the run across CUDA devices; "
                 "--device cpu has none")
    if args.smoke:
        raise SystemExit(smoke(observe=args.trace,
                               check_specs=args.check_specs,
                               artifacts=args.artifacts,
                               device=args.device))
    if args.mesh_devices:
        from .config import FleetConfig
        from .counters import summarize
        from .fleet import run_fleet
        ecfg, scfg = build_configs(
            args.workload, args.remotes, args.lines, args.ops, 0,
            args.seed, not args.mesi, width=args.width,
            subset_name=args.subset, credits=args.credits or None,
            n_homes=args.homes, home_bw=args.home_bw, packed=args.packed)
        fleet = FleetConfig(members=((ecfg, scfg),), steps=args.steps,
                            mesh_devices=args.mesh_devices)
        run = run_fleet(fleet, device=args.device)[0]
        out = summarize(run.counters, run.msg_count, run.payload_msgs)
        out["config"] = {"engine": ecfg.to_json_dict(),
                         "stream": scfg.to_json_dict(),
                         "mesh_devices": args.mesh_devices}
        out["completed"] = run.completed
        print(json.dumps(out, indent=1, default=str))
        if not run.completed:
            raise SystemExit("stream did not drain within --steps")
        return
    config_text = ""
    if args.config:
        with open(args.config) as f:
            config_text = f.read()
    out = drive(args.workload, args.remotes, args.lines, args.ops,
                args.steps, args.seed, not args.mesi, args.validate,
                width=args.width, subset_name=args.subset,
                credits=args.credits or None,
                shared_credits=args.shared_credits, n_homes=args.homes,
                home_bw=args.home_bw,
                observe=args.trace, check_specs=args.check_specs,
                trace_out=args.trace_out, perfetto_out=args.perfetto,
                arrivals=args.arrivals, rate=args.rate,
                arrival_seed=args.arrival_seed, admit_cap=args.admit_cap,
                admit_reserve=args.admit_reserve, config_text=config_text,
                packed=args.packed, device=args.device)
    if args.artifacts and "config" in out:
        # the resolved EngineConfig+StreamConfig, written back so the
        # artifacts record exactly what ran (and replay with --config).
        os.makedirs(args.artifacts, exist_ok=True)
        with open(os.path.join(args.artifacts, "config.json"), "w") as f:
            json.dump(out["config"], f, indent=1, sort_keys=True)
    print(json.dumps(out, indent=1, default=str))
    if not out["completed"]:
        # an OPEN-LOOP run that ends with arrived-but-unserved ops is a
        # legitimate overload measurement, not a budget failure.
        if out.get("serving", {}).get("backlog", 0) > 0:
            print("note: overload — unserved backlog "
                  f"{out['serving']['backlog']} at budget end")
        else:
            raise SystemExit("stream did not drain within --steps")


if __name__ == "__main__":
    main()
