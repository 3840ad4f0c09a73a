"""Open-loop arrival processes for the streaming traffic subsystem.

The port of ``repro.traffic.arrivals``.  Every workload generator is
CLOSED-LOOP: the driver keeps each remote's issue window full, so the
offered load always equals the engine's capacity.  An **arrival
schedule** stamps each workload slot with the engine step at which it
becomes issuable; the driver's admission loop (``traffic.driver``) then
gates WHEN ops enter flight, never WHAT they do, so the retirement-order
replay against ``MultiNodeRef`` stays exact while sojourn (arrival ->
retirement) becomes the measured latency.

An ``ArrivalSchedule`` is a ``[T, R]`` int32 array, nondecreasing down
each column: ``step[t, r]`` is the arrival step of remote ``r``'s
``t``-th stream op; the offered load is ``rate`` ops per remote per
engine step.  The generators draw from an explicit
``numpy.random.Generator`` (``numpy.random.default_rng(seed)``), as the
workload generators do, so their streams differ from the reference's
``jax.random`` streams by construction; ``at_step0`` is identical.
Tests that compare the two packages feed both the reference's arrays.

Processes:

* ``at_step0`` — every op arrives at step 0: the closed-loop control;
* ``poisson``  — i.i.d. exponential interarrivals of mean ``1/rate``
  steps (floored to integer steps);
* ``bursty``   — a two-phase Markov-modulated process: gaps draw from a
  fast phase (``rate * hi_lo_ratio``) or a slow one (``rate /
  hi_lo_ratio``), the phase flipping with probability ``p_flip`` at each
  arrival; the phase rates are normalised so the mean gap stays exactly
  ``1/rate``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np


class ArrivalSchedule(NamedTuple):
    """Arrival step per workload slot (host data, like a ``Workload``)."""

    step: np.ndarray  # [T, R] int32, nondecreasing along axis 0


def check_schedule(sched: ArrivalSchedule, ops: int, n_remotes: int
                   ) -> None:
    """Entry validation: shape, dtype and per-column monotonicity (the
    driver's FIFO window assumes stream order IS arrival order)."""
    st = np.asarray(sched.step)
    if st.shape != (ops, n_remotes):
        raise ValueError(
            f"arrival schedule shape {st.shape} != workload [T, R] = "
            f"{(ops, n_remotes)}")
    if not np.issubdtype(st.dtype, np.integer):
        raise ValueError(
            f"arrival schedule must be integer steps, got {st.dtype}")
    if st.size and ((st < 0).any() or (np.diff(st, axis=0) < 0).any()):
        raise ValueError(
            "arrival schedule must be >= 0 and nondecreasing per remote "
            "(stream order is FIFO arrival order)")


def at_step0(rng, ops: int, n_remotes: int, rate: float = 0.0
             ) -> ArrivalSchedule:
    """Everything arrives at step 0 (``rate`` is accepted and ignored)."""
    del rng, rate
    return ArrivalSchedule(np.zeros((ops, n_remotes), np.int32))


def _cum_gaps(gaps: np.ndarray) -> ArrivalSchedule:
    """Integer-floored interarrival gaps -> cumulative arrival steps."""
    return ArrivalSchedule(np.cumsum(np.floor(gaps).astype(np.int32),
                                     axis=0, dtype=np.int32))


def poisson(rng, ops: int, n_remotes: int, rate: float = 0.1
            ) -> ArrivalSchedule:
    """Memoryless arrivals: exponential interarrivals of mean ``1/rate``."""
    if not rate > 0:
        raise ValueError(f"poisson arrival rate must be > 0, got {rate}")
    return _cum_gaps(rng.exponential(size=(ops, n_remotes)) / rate)


def bursty(rng, ops: int, n_remotes: int, rate: float = 0.1,
           hi_lo_ratio: float = 4.0, p_flip: float = 0.1
           ) -> ArrivalSchedule:
    """Two-phase Markov-modulated arrivals (MMPP-style burstiness): the
    phase flips with probability ``p_flip`` at every arrival, so bursts
    are geometric; ``norm`` keeps the long-run mean gap at ``1/rate``
    while the variance grows with ``hi_lo_ratio``."""
    if not (rate > 0 and hi_lo_ratio >= 1.0):
        raise ValueError(f"bursty needs rate > 0 and hi_lo_ratio >= 1, "
                         f"got {rate}, {hi_lo_ratio}")
    flips = rng.random((ops, n_remotes)) < p_flip
    phase0 = rng.random((1, n_remotes)) < 0.5
    phase = (np.cumsum(flips, axis=0) + phase0) % 2
    norm = (hi_lo_ratio + 1.0 / hi_lo_ratio) / 2.0
    r = np.where(phase == 0, rate * hi_lo_ratio, rate / hi_lo_ratio)
    return _cum_gaps(rng.exponential(size=(ops, n_remotes)) / (r * norm))


#: name -> generator, all with the (rng, ops, n_remotes, rate) prefix.
ARRIVALS: Dict[str, Callable[..., ArrivalSchedule]] = {
    "at_step0": at_step0,
    "poisson": poisson,
    "bursty": bursty,
}
