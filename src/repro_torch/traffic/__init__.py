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

    # a sweep as one member-batched loop; each member == its solo run
    fleet = FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=64),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=32), width=w))
        for r in (4, 8) for w in (1, 2)))
    runs = run_fleet(fleet)                                  # on "cuda"

The command line: ``python -m repro_torch.traffic.run --smoke``.
"""
from .arrivals import ARRIVALS, ArrivalSchedule, check_schedule
from .config import (AdmissionConfig, ArrivalSpec, EngineConfig,
                     FleetConfig, StreamConfig, WorkloadSpec,
                     config_from_json, config_to_json,
                     engine_config_from_dict, stream_config_from_dict)
from .counters import (LAT_EDGES, SOJOURN_EDGES, Counters,
                       RetirementTrace, acc_total, assert_counts_match,
                       hist_percentiles, replay_reference, sojourn_summary,
                       summarize, validate_run)
from .driver import StreamRun, default_steps, run_stream
from .fleet import fleet_steps, run_fleet
from .observe import (ObserveConfig, ObsResult, OnlineViolation,
                      perfetto_events, write_perfetto)
from .workloads import WORKLOADS, Workload

__all__ = [
    "ARRIVALS", "AdmissionConfig", "ArrivalSchedule", "ArrivalSpec",
    "Counters", "EngineConfig", "FleetConfig", "LAT_EDGES", "ObsResult",
    "ObserveConfig", "OnlineViolation", "RetirementTrace", "SOJOURN_EDGES",
    "StreamConfig", "StreamRun", "WORKLOADS", "Workload", "WorkloadSpec",
    "acc_total", "assert_counts_match", "check_schedule",
    "config_from_json", "config_to_json", "default_steps",
    "engine_config_from_dict", "fleet_steps", "hist_percentiles",
    "perfetto_events", "replay_reference", "run_fleet", "run_stream",
    "sojourn_summary", "stream_config_from_dict", "summarize",
    "validate_run", "write_perfetto",
]
