"""The construction surface for closed-loop streaming runs.

The port of the closed-loop part of ``repro.traffic.config``:

* ``WorkloadSpec`` — generator name + stream length + seed + knobs;
* ``EngineConfig``  — everything that determines the engine;
  ``.build(device="cuda")`` constructs the ``EngineMN``;
* ``StreamConfig``  — everything that determines the run (workload,
  issue width, step budget, trace collection); ``run_stream(engine,
  StreamConfig)`` is the entry point.

There is no kernel-backend field: the device is an argument, and on a
CUDA device the step kernels always run.  Open-loop arrivals and
admission, observability and fleets are not ported yet (ROADMAP Queue 1
items 10-12).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

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
    """Everything that determines one closed-loop streaming run.

    ``workload`` is a ``Workload`` of arrays or a seeded
    ``WorkloadSpec``; ``steps=0`` auto-derives the budget via
    ``driver.default_steps``."""

    workload: Union[Workload, WorkloadSpec] = \
        dataclasses.field(default_factory=WorkloadSpec)
    width: int = 1
    steps: int = 0
    collect_trace: bool = False

    def __post_init__(self):
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0 (0 = auto), "
                             f"got {self.steps}")
