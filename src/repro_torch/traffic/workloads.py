"""Streaming workload generators: seeded ``[T, R]`` op streams.

The port of ``repro.traffic.workloads``: the same six access patterns
(``sequential``, ``strided``, ``zipfian``, ``producer_consumer``,
``migratory``, ``false_sharing``), drawn from an explicit
``numpy.random.Generator`` (``numpy.random.default_rng(seed)``).  Their
random streams differ from the reference's ``jax.random`` streams by
construction; the deterministic patterns (``sequential``, ``strided``'s
lines, ``producer_consumer``, ``migratory``) are identical.  Tests that
compare the two packages feed both the reference's arrays.

A workload is host data (numpy); ``run_stream`` moves it to the device once
per run.  Generators emit only LOAD/STORE, which keeps the counter
validation against the atomic oracle exact (see ``traffic.counters``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np

from ..core.protocol import LocalOp


class Workload(NamedTuple):
    """One op per (step, remote), consumed cursor-wise by ``run_stream``."""

    op: np.ndarray      # [T, R] int8 LocalOp (NOP = bubble, skipped free)
    line: np.ndarray    # [T, R] int32 target line
    value: np.ndarray   # [T, R] float32 store value (broadcast over block)


def _values(steps: int, n_remotes: int) -> np.ndarray:
    """Distinct per-(t, r) store values so replay mismatches are visible."""
    t = np.arange(steps, dtype=np.float32)[:, None]
    r = np.arange(n_remotes, dtype=np.float32)[None, :]
    return (t * n_remotes + r + 1.0).astype(np.float32)


def _mix(rng: np.random.Generator, steps: int, n_remotes: int,
         store_frac: float) -> np.ndarray:
    """LOAD/STORE mix with the given store fraction."""
    u = rng.random((steps, n_remotes))
    return np.where(u < store_frac, int(LocalOp.STORE),
                    int(LocalOp.LOAD)).astype(np.int8)


def sequential(rng, steps: int, n_remotes: int, n_lines: int,
               store_frac: float = 0.25) -> Workload:
    """Staggered full-array scans: overlap without systematic collision."""
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    line = (t + r * max(n_lines // n_remotes, 1)) % n_lines
    return Workload(_mix(rng, steps, n_remotes, store_frac),
                    line.astype(np.int32), _values(steps, n_remotes))


def strided(rng, steps: int, n_remotes: int, n_lines: int,
            stride: int = 7, store_frac: float = 0.25) -> Workload:
    """Constant-stride scans, one lane per remote."""
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    line = (t * stride + r) % n_lines
    return Workload(_mix(rng, steps, n_remotes, store_frac),
                    line.astype(np.int32), _values(steps, n_remotes))


def zipfian(rng, steps: int, n_remotes: int, n_lines: int,
            alpha: float = 1.2, store_frac: float = 0.3) -> Workload:
    """Zipf(alpha)-popular lines shared by ALL remotes — the hot-line
    contention pattern."""
    op = _mix(rng, steps, n_remotes, store_frac)
    ranks = np.arange(1, n_lines + 1, dtype=np.float64)
    w = ranks ** -alpha
    cdf = np.cumsum(w) / np.sum(w)
    u = rng.random((steps, n_remotes))
    idx = np.searchsorted(cdf, u)
    # decouple popularity rank from line id so "hot" isn't always line 0.
    perm = rng.permutation(n_lines)
    line = perm[np.clip(idx, 0, n_lines - 1)]
    return Workload(op, line.astype(np.int32), _values(steps, n_remotes))


def producer_consumer(rng, steps: int, n_remotes: int, n_lines: int,
                      ring: int = 0) -> Workload:
    """Remote 0 stores a ring of lines; remotes 1.. read one slot behind."""
    del rng
    ring = ring or min(n_lines, 8)
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    line = (t - r) % ring
    op = np.where(r == 0, int(LocalOp.STORE), int(LocalOp.LOAD))
    op = np.broadcast_to(op, (steps, n_remotes))
    return Workload(op.astype(np.int8), line.astype(np.int32),
                    _values(steps, n_remotes))


def migratory(rng, steps: int, n_remotes: int, n_lines: int,
              working: int = 4) -> Workload:
    """Ownership of a small working set migrates remote-to-remote (a
    read-modify-write per epoch, then a handoff)."""
    del rng
    working = min(working, n_lines)
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    epoch = t // 2
    owner = epoch % n_remotes
    line = np.broadcast_to((epoch // n_remotes) % working,
                           (steps, n_remotes))
    phase_op = np.where(t % 2 == 0, int(LocalOp.LOAD), int(LocalOp.STORE))
    op = np.where(r == owner, phase_op, int(LocalOp.NOP))
    return Workload(op.astype(np.int8), line.astype(np.int32),
                    _values(steps, n_remotes))


def false_sharing(rng, steps: int, n_remotes: int, n_lines: int,
                  hot: int = 2, store_frac: float = 0.75) -> Workload:
    """Every remote hammers the SAME few lines, mostly stores."""
    hot = min(hot, n_lines)
    t = np.arange(steps)[:, None]
    line = np.broadcast_to((t // 4) % hot, (steps, n_remotes))
    return Workload(_mix(rng, steps, n_remotes, store_frac),
                    line.astype(np.int32), _values(steps, n_remotes))


#: name -> generator, all with the uniform (rng, steps, n_remotes,
#: n_lines) prefix signature (pattern-specific knobs are keywords).
WORKLOADS: Dict[str, Callable[..., Workload]] = {
    "sequential": sequential,
    "strided": strided,
    "zipfian": zipfian,
    "producer_consumer": producer_consumer,
    "migratory": migratory,
    "false_sharing": false_sharing,
}
