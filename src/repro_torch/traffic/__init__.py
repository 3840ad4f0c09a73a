"""Streaming traffic on the port: workloads, arrivals, the driver, its
counters and the observability plane.

    from repro_torch.traffic import (AdmissionConfig, ArrivalSpec,
                                     EngineConfig, ObserveConfig,
                                     StreamConfig, WorkloadSpec, run_stream,
                                     sojourn_summary, summarize,
                                     validate_run)
    eng = EngineConfig(remotes=8, lines=64).build()          # on "cuda"
    run = run_stream(eng, StreamConfig(
        workload=WorkloadSpec("zipfian", ops=256), width=2,
        arrivals=ArrivalSpec("poisson", rate=0.05, seed=1),
        admission=AdmissionConfig(max_inflight=16, reserve=2),
        observe=ObserveConfig(), collect_trace=True))
    validate_run(run)
    print(summarize(run.counters, run.msg_count), sojourn_summary(run),
          run.obs.violations)
"""
from .arrivals import ARRIVALS, ArrivalSchedule, check_schedule
from .config import (AdmissionConfig, ArrivalSpec, EngineConfig,
                     StreamConfig, WorkloadSpec)
from .counters import (LAT_EDGES, SOJOURN_EDGES, Counters,
                       RetirementTrace, acc_total, assert_counts_match,
                       hist_percentiles, replay_reference, sojourn_summary,
                       summarize, validate_run)
from .driver import StreamRun, default_steps, run_stream
from .observe import (ObserveConfig, ObsResult, OnlineViolation,
                      perfetto_events, write_perfetto)
from .workloads import WORKLOADS, Workload

__all__ = [
    "ARRIVALS", "AdmissionConfig", "ArrivalSchedule", "ArrivalSpec",
    "Counters", "EngineConfig", "LAT_EDGES", "ObsResult", "ObserveConfig",
    "OnlineViolation", "RetirementTrace", "SOJOURN_EDGES", "StreamConfig",
    "StreamRun", "WORKLOADS", "Workload", "WorkloadSpec", "acc_total",
    "assert_counts_match", "check_schedule", "default_steps",
    "hist_percentiles", "perfetto_events", "replay_reference",
    "run_stream", "sojourn_summary", "summarize", "validate_run",
    "write_perfetto",
]
