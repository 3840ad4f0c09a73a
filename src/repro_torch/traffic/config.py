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

* ``FleetConfig``   — a sweep's members, run as one member-batched loop
  by ``traffic.fleet.run_fleet``.

There is no kernel-backend field: the device is an argument, and on a
CUDA device the step kernels always run.

Both configs serialize to and from plain JSON: ``config_to_json`` /
``config_from_json`` round-trip the ``{"engine": ..., "stream": ...}``
document the CLI's ``--config`` reads and ``--artifacts`` writes, the
reference's document format.  The port writes no ``kernel_backend`` key;
it reads the reference's (``""``, ``"xla"`` or ``"pallas"``) and drops
it, since the device decides.  Serialization needs the SPEC forms
(``WorkloadSpec``/``ArrivalSpec``): a config describes how to regenerate
a run, not its arrays.
"""
from __future__ import annotations

import dataclasses
import json
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

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


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

    # -- JSON round-trip ---------------------------------------------------

    def to_json_dict(self) -> dict:
        if not isinstance(self.workload, WorkloadSpec):
            raise ValueError(
                "StreamConfig JSON serialization requires a WorkloadSpec "
                "(generator name + seed), not raw Workload arrays")
        if self.arrivals is not None and \
                not isinstance(self.arrivals, ArrivalSpec):
            raise ValueError(
                "StreamConfig JSON serialization requires an ArrivalSpec "
                "(process name + rate + seed), not a raw schedule")
        if self.line_filter is not None or self.type_filter is not None:
            raise ValueError("capture filters are arrays and do not "
                             "serialize; set them programmatically")
        d = {
            "workload": dataclasses.asdict(self.workload),
            "arrivals": (None if self.arrivals is None
                         else dataclasses.asdict(self.arrivals)),
            "admission": (None if self.admission is None
                          else dict(self.admission._asdict())),
            "width": self.width,
            "steps": self.steps,
            "collect_trace": self.collect_trace,
        }
        if self.observe is not None:
            obs = dict(self.observe._asdict())
            obs["specs"] = list(obs["specs"])
            d["observe"] = obs
        return d


@dataclasses.dataclass(frozen=True, eq=False)
class FleetConfig:
    """A sweep run as ONE member-batched loop (``traffic.fleet``).

    ``members`` are ``(EngineConfig, StreamConfig)`` pairs, one per sweep
    point.  ``run_fleet`` steps all of them together, on one leading
    member axis: members may differ in remotes (narrower members pad with
    idle remotes fed NOP columns), width (a per-member window cap),
    workload, homes and home_bw (the engine's flat-layout home
    emulation).  Each member's result is BIT-identical to its solo
    ``run_stream`` at the fleet's shared ``steps`` budget.

    What must stay uniform is what the batched loop shares: shapes
    (``lines``/``block``) and the step's structure (``subset``/``moesi``/
    ``credits``/``packed``, ``collect_trace``).  Open-loop members,
    observation and capture filters are out of scope, as in the
    reference.

    ``homes > 1`` members ride the flat-layout emulation, which is exact
    only while VC credits never bind: effective credits (``credits`` or
    the transport default 64) must cover ``lines``.

    ``steps = 0`` takes the shared budget as the max of the members'
    ``driver.default_steps``.  ``mesh_devices > 0`` splits the members
    across that many CUDA devices (data parallel; results gathered in
    member order)."""

    members: Tuple[Tuple[EngineConfig, StreamConfig], ...] = ()
    steps: int = 0
    mesh_devices: int = 0

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(
            (e, s) for e, s in self.members))
        if not self.members:
            raise ValueError("FleetConfig needs at least one member")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0 (0 = auto), "
                             f"got {self.steps}")
        if self.mesh_devices < 0:
            raise ValueError(f"mesh_devices must be >= 0 (0 = single "
                             f"device), got {self.mesh_devices}")
        e0, s0 = self.members[0]
        for i, (e, s) in enumerate(self.members):
            for f in ("lines", "block", "subset", "moesi", "credits",
                      "packed"):
                if getattr(e, f) != getattr(e0, f):
                    raise ValueError(
                        f"fleet member {i}: '{f}' must be uniform across "
                        f"the fleet ({getattr(e, f)!r} != "
                        f"{getattr(e0, f)!r}) — it shapes the one "
                        f"batched loop")
            if e.shared_credits:
                raise ValueError(
                    f"fleet member {i}: shared_credits is not supported "
                    f"in fleets (its credit ranking is order-sensitive "
                    f"across the whole [R, L] slab)")
            if e.homes > 1 and (e.credits or 64) < e.lines:
                raise ValueError(
                    f"fleet member {i}: homes={e.homes} requires "
                    f"effective credits >= lines ({e.lines}) — the flat "
                    f"H-emulation is exact only while credits never bind")
            if not isinstance(s.workload, WorkloadSpec):
                raise ValueError(
                    f"fleet member {i}: fleet members need a seeded "
                    f"WorkloadSpec (regenerated at the member's own "
                    f"[R, L]), not raw Workload arrays")
            if s.workload.ops != s0.workload.ops:
                raise ValueError(
                    f"fleet member {i}: workload ops must be uniform "
                    f"({s.workload.ops} != {s0.workload.ops}) — the "
                    f"fleet shares one [T, R] stream plane (a shorter "
                    f"member would pad with NOPs that dilute its "
                    f"active-step accounting)")
            if s.arrivals is not None or (
                    s.admission is not None and s.admission.max_inflight):
                raise ValueError(
                    f"fleet member {i}: open-loop members (arrivals/"
                    f"admission) are not fleet-batchable")
            if s.observe is not None or s.line_filter is not None or \
                    s.type_filter is not None:
                raise ValueError(
                    f"fleet member {i}: observability/capture filters "
                    f"key the program per member and cannot ride a "
                    f"fleet")
            if s.steps:
                raise ValueError(
                    f"fleet member {i}: per-member steps must be 0 — the "
                    f"fleet runs ONE shared budget (FleetConfig.steps)")
            if s.collect_trace != s0.collect_trace:
                raise ValueError(
                    f"fleet member {i}: collect_trace must be uniform")


#: the reference's ``kernel_backend`` values, which a document may carry
#: and the port drops.
REFERENCE_KERNEL_BACKENDS = ("", "xla", "pallas")


def _check_keys(d: dict, allowed, what: str) -> None:
    unknown = sorted(set(d) - set(allowed))
    if unknown:
        raise ValueError(f"unknown {what} config keys {unknown}; "
                         f"allowed: {sorted(allowed)}")


def engine_config_from_dict(d: dict) -> EngineConfig:
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    _check_keys(d, fields | {"kernel_backend"}, "engine")
    d = dict(d)
    backend = d.pop("kernel_backend", "")
    if backend not in REFERENCE_KERNEL_BACKENDS:
        raise ValueError(
            f"kernel_backend must be one of {REFERENCE_KERNEL_BACKENDS} "
            f"(dropped: the device picks the kernels), got '{backend}'")
    return EngineConfig(**d)


def stream_config_from_dict(d: dict) -> StreamConfig:
    allowed = {"workload", "arrivals", "admission", "width", "steps",
               "observe", "collect_trace"}
    _check_keys(d, allowed, "stream")
    d = dict(d)
    wl = d.get("workload", {})
    d["workload"] = WorkloadSpec(**{**wl, "params": _params(
        wl.get("params", ()))})
    arr = d.get("arrivals")
    if arr is not None:
        d["arrivals"] = ArrivalSpec(**{**arr, "params": _params(
            arr.get("params", ()))})
    adm = d.get("admission")
    if adm is not None:
        d["admission"] = AdmissionConfig(**adm)
    obs = d.get("observe")
    if obs is not None:
        obs = dict(obs)
        for key in ("specs", "inject"):
            if obs.get(key) is not None:
                obs[key] = tuple(obs[key])
        d["observe"] = ObserveConfig(**obs)
    return StreamConfig(**d)


def config_to_json(engine: EngineConfig, stream: StreamConfig) -> str:
    """The ``--config`` document: one JSON object holding both configs."""
    return json.dumps({"engine": engine.to_json_dict(),
                       "stream": stream.to_json_dict()},
                      indent=1, sort_keys=True)


def config_from_json(text: str) -> Tuple[EngineConfig, StreamConfig]:
    doc = json.loads(text)
    _check_keys(doc, ("engine", "stream"), "top-level")
    return (engine_config_from_dict(doc.get("engine", {})),
            stream_config_from_dict(doc.get("stream", {})))
