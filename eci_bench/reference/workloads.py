"""The traffic generators, frozen: seeded ``[T, R]`` op streams (int8
ops, int32 line ids, float32 store values), one per remote, drawn from
``numpy.random.default_rng(seed)``.  A mix file under ``traffic/`` names
one of ``GENERATORS`` and its keywords; the benchmark hands every program
run the same seed and regenerates the stream here for the reference."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

NOP, LOAD, STORE = 0, 1, 2

Stream = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _values(steps: int, n_remotes: int) -> np.ndarray:
    """A distinct store value per (op, remote)."""
    t = np.arange(steps, dtype=np.float32)[:, None]
    r = np.arange(n_remotes, dtype=np.float32)[None, :]
    return (t * n_remotes + r + 1.0).astype(np.float32)


def _mix(rng, steps: int, n_remotes: int, store_frac: float) -> np.ndarray:
    u = rng.random((steps, n_remotes))
    return np.where(u < store_frac, STORE, LOAD).astype(np.int8)


def sequential(rng, steps, n_remotes, n_lines, store_frac=0.25) -> Stream:
    """Each remote scans the lines from its own offset."""
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    line = (t + r * max(n_lines // n_remotes, 1)) % n_lines
    return (_mix(rng, steps, n_remotes, store_frac), line.astype(np.int32),
            _values(steps, n_remotes))


def strided(rng, steps, n_remotes, n_lines, stride=7,
            store_frac=0.25) -> Stream:
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    line = (t * stride + r) % n_lines
    return (_mix(rng, steps, n_remotes, store_frac), line.astype(np.int32),
            _values(steps, n_remotes))


def zipfian(rng, steps, n_remotes, n_lines, alpha=1.2,
            store_frac=0.3) -> Stream:
    """Zipf(alpha)-popular lines shared by every remote; the popularity
    order is a random permutation of the lines."""
    op = _mix(rng, steps, n_remotes, store_frac)
    ranks = np.arange(1, n_lines + 1, dtype=np.float64)
    w = ranks ** -alpha
    cdf = np.cumsum(w) / np.sum(w)
    idx = np.searchsorted(cdf, rng.random((steps, n_remotes)))
    line = rng.permutation(n_lines)[np.clip(idx, 0, n_lines - 1)]
    return op, line.astype(np.int32), _values(steps, n_remotes)


def producer_consumer(rng, steps, n_remotes, n_lines, ring=0) -> Stream:
    ring = ring or min(n_lines, 8)
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    op = np.broadcast_to(np.where(r == 0, STORE, LOAD), (steps, n_remotes))
    return (op.astype(np.int8), ((t - r) % ring).astype(np.int32),
            _values(steps, n_remotes))


def migratory(rng, steps, n_remotes, n_lines, working=4) -> Stream:
    working = min(working, n_lines)
    t = np.arange(steps)[:, None]
    r = np.arange(n_remotes)[None, :]
    epoch = t // 2
    line = np.broadcast_to((epoch // n_remotes) % working,
                           (steps, n_remotes))
    op = np.where(r == epoch % n_remotes,
                  np.where(t % 2 == 0, LOAD, STORE), NOP)
    return (op.astype(np.int8), line.astype(np.int32),
            _values(steps, n_remotes))


def false_sharing(rng, steps, n_remotes, n_lines, hot=2,
                  store_frac=0.75) -> Stream:
    hot = min(hot, n_lines)
    t = np.arange(steps)[:, None]
    line = np.broadcast_to((t // 4) % hot, (steps, n_remotes))
    return (_mix(rng, steps, n_remotes, store_frac), line.astype(np.int32),
            _values(steps, n_remotes))


GENERATORS: Dict[str, Callable[..., Stream]] = {
    "sequential": sequential, "strided": strided, "zipfian": zipfian,
    "producer_consumer": producer_consumer, "migratory": migratory,
    "false_sharing": false_sharing,
}


def stream(name: str, seed: int, ops: int, n_remotes: int, n_lines: int,
           params: dict) -> Stream:
    return GENERATORS[name](np.random.default_rng(seed), ops, n_remotes,
                            n_lines, **params)
