"""The construction surface for streaming runs.

The port of ``repro.traffic.config``:

* ``WorkloadSpec`` — generator name + stream length + seed + knobs;
* ``ArrivalSpec``  — arrival process + offered load + seed + knobs;
* ``AdmissionConfig`` — the FIFO + reserve admission cap;
* ``EngineConfig``  — everything that determines the engine;
  ``.build(device="cuda")`` constructs the ``EngineMN``;
* ``StreamConfig``  — everything that determines the run (workload,
  arrivals, admission, issue width, step budget, observability and its
  capture filters, trace collection); ``run_stream(engine,
  StreamConfig)`` is the entry point.

There is no kernel-backend field: the device is an argument, and on a
CUDA device the step kernels always run.  Fleets and the JSON round-trip
are not ported yet (ROADMAP Queue 1 items 12 and 13).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np

from .arrivals import ARRIVALS, ArrivalSchedule
from .observe import ObserveConfig
from .workloads import WORKLOADS, Workload

Params = Tuple[Tuple[str, float], ...]


def _params(p) -> Params:
    if isinstance(p, dict):
        return tuple(sorted(p.items()))
    return tuple((k, v) for k, v in p)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Seeded recipe for a ``Workload``: generator name + stream length
    + seed + generator knobs (e.g. ``store_frac``, ``alpha``)."""

    name: str = "zipfian"
    ops: int = 128
    seed: int = 0
    params: Params = ()

    def __post_init__(self):
        if self.name not in WORKLOADS:
            raise ValueError(f"unknown workload '{self.name}'; have "
                             f"{sorted(WORKLOADS)}")
        if self.ops < 1:
            raise ValueError(f"ops must be >= 1, got {self.ops}")
        object.__setattr__(self, "params", _params(self.params))

    def materialize(self, n_remotes: int, n_lines: int) -> Workload:
        return WORKLOADS[self.name](np.random.default_rng(self.seed),
                                    self.ops, n_remotes, n_lines,
                                    **dict(self.params))


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Seeded recipe for an ``ArrivalSchedule``: process name + offered
    load (``rate`` ops/step/remote) + seed + process knobs."""

    kind: str = "poisson"
    rate: float = 0.1
    seed: int = 0
    params: Params = ()

    def __post_init__(self):
        if self.kind not in ARRIVALS:
            raise ValueError(f"unknown arrival process '{self.kind}'; "
                             f"have {sorted(ARRIVALS)}")
        object.__setattr__(self, "params", _params(self.params))

    def materialize(self, ops: int, n_remotes: int) -> ArrivalSchedule:
        return ARRIVALS[self.kind](np.random.default_rng(self.seed), ops,
                                   n_remotes, self.rate,
                                   **dict(self.params))


class AdmissionConfig(NamedTuple):
    """Continuous-batching admission control (FIFO + reserve watermark).

    ``max_inflight`` caps transactions in flight across ALL remotes (0 =
    unbounded).  Arrivals are admitted FIFO (globally, by arrival stamp)
    only while ``inflight < max_inflight - reserve``, so admitted work
    keeps ``reserve`` slots of headroom; admission gates WHEN an op
    enters flight, never what it does."""

    max_inflight: int = 0
    reserve: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class EngineConfig:
    """Everything that determines the engine; ``.build()`` constructs it."""

    remotes: int = 4
    lines: int = 64
    block: int = 2
    subset: str = ""            # "" -> moesi flag picks the full protocol
    moesi: bool = True
    credits: int = 0            # uniform per-VC credit override (0 = default)
    shared_credits: bool = False
    homes: int = 1
    home_bw: int = 0
    packed: bool = False

    def __post_init__(self):
        from ..core.engine_mn import MAX_REMOTES
        from ..core.protocol import SUBSETS
        if not 1 <= self.remotes <= MAX_REMOTES:
            raise ValueError(f"remotes must be in 1..{MAX_REMOTES} "
                             f"(EWF v2 node-id field), got {self.remotes}")
        if self.subset and self.subset not in SUBSETS:
            raise ValueError(f"unknown subset '{self.subset}'; have "
                             f"{sorted(SUBSETS)}")
        if self.homes < 1 or self.lines % self.homes:
            raise ValueError(f"homes ({self.homes}) must be >= 1 and "
                             f"divide lines ({self.lines})")
        if self.credits < 0 or self.home_bw < 0:
            raise ValueError("credits and home_bw must be >= 0")

    def build(self, device=None):
        """The ``EngineMN`` on ``device`` (default ``"cuda"``)."""
        from ..core.engine_mn import EngineMN
        return EngineMN.from_config(self, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class StreamConfig:
    """Everything that determines one streaming run.

    ``workload`` (and ``arrivals``) are arrays (``Workload`` /
    ``ArrivalSchedule``) or seeded specs (``WorkloadSpec`` /
    ``ArrivalSpec``); ``steps=0`` auto-derives the budget via
    ``driver.default_steps``, arrival-aware (the budget covers the last
    arrival plus the closed-loop drain tail).  ``observe`` turns on the
    in-loop observability plane (``traffic.observe``), whose EWF capture
    ``line_filter`` ([n_lines] bool) and ``type_filter`` ([16] bool,
    MsgType-indexed) restrict."""

    workload: Union[Workload, WorkloadSpec] = \
        dataclasses.field(default_factory=WorkloadSpec)
    arrivals: Optional[Union[ArrivalSchedule, ArrivalSpec]] = None
    admission: Optional[AdmissionConfig] = None
    width: int = 1
    steps: int = 0
    observe: Optional[ObserveConfig] = None
    line_filter: Optional[np.ndarray] = None
    type_filter: Optional[np.ndarray] = None
    collect_trace: bool = False

    def __post_init__(self):
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0 (0 = auto), "
                             f"got {self.steps}")
        if self.admission is not None:
            adm = AdmissionConfig(*self.admission)
            if adm.max_inflight < 0 or adm.reserve < 0 or (
                    adm.max_inflight and
                    adm.reserve >= adm.max_inflight):
                raise ValueError(
                    f"admission reserve ({adm.reserve}) must leave room "
                    f"under max_inflight ({adm.max_inflight})")
            object.__setattr__(self, "admission", adm)
