"""Streaming traffic on the port: workloads, the closed-loop driver and
its counters.

    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, run_stream, summarize,
                                     validate_run)
    eng = EngineConfig(remotes=8, lines=64).build()          # on "cuda"
    run = run_stream(eng, StreamConfig(
        workload=WorkloadSpec("zipfian", ops=256), width=2,
        collect_trace=True))
    validate_run(run)
    print(summarize(run.counters, run.msg_count))
"""
from .config import EngineConfig, StreamConfig, WorkloadSpec
from .counters import (LAT_EDGES, Counters, RetirementTrace, acc_total,
                       assert_counts_match, hist_percentiles,
                       replay_reference, summarize, validate_run)
from .driver import StreamRun, default_steps, run_stream
from .workloads import WORKLOADS, Workload

__all__ = [
    "Counters", "EngineConfig", "LAT_EDGES", "RetirementTrace",
    "StreamConfig", "StreamRun", "WORKLOADS", "Workload", "WorkloadSpec",
    "acc_total", "assert_counts_match", "default_steps",
    "hist_percentiles", "replay_reference", "run_stream", "summarize",
    "validate_run",
]
