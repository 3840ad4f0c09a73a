"""The least time each step kernel could take, from the shapes it runs
at: bytes at the HBM rate or 32-bit operations at the CUDA cores' rate,
whichever is longer (one NVIDIA H100 SXM, data-sheet peaks).  Each input
byte is counted read once and each output byte written once.

``step_launches`` lists the launches of one fleet step of the engine
(M members of R remotes over L lines; dense or packed directory planes),
each with its bytes and operations.
"""
from __future__ import annotations

from typing import List, Tuple

#: HBM bytes/s of an H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: float32 operations/s outside the tensor cores (NVIDIA data sheet), the
#: rate taken for the kernels' 32-bit integer operations.
CUDA_CORE_OPS_PER_S = 67e12
#: the step kernels, as their CUDA entry points are named
#: (``<name>_kernel`` in the profiler's records).
KERNELS = ("credit_rank", "arb_winner", "count_fold", "lat_hist",
           "packed_any", "packed_fanout")

Launch = Tuple[str, int, int]        # kernel, bytes, operations


def credit_rank(n: int) -> Launch:
    """Two bool planes of ``n`` lanes in, an int32 rank out."""
    return "credit_rank", 6 * n, 8 * n


def arb_winner(parts: int, lines: int, lead: int = 1) -> Launch:
    """A ``[parts, lines]`` bool ready plane and an int32 pointer in, an
    int32 winner out, per leading row."""
    return ("arb_winner", lead * (parts * lines + 8 * lines),
            lead * 6 * parts * lines)


def count_fold(n: int, groups: int = 1) -> Launch:
    """Mask, int8 code and payload flag per lane; 17 int32 totals read
    and written per group."""
    return ("count_fold", 3 * groups * n + 2 * 4 * 17 * groups,
            4 * groups * n)


def lat_hist(rows: int, lines: int) -> Launch:
    """An int32 latency and a bool per lane in, 10 int32 bins per row
    out."""
    return "lat_hist", 5 * rows * lines + 4 * rows * 10, 20 * rows * lines


def packed_any(lines: int, words: int, planes: int = 1) -> Launch:
    """``planes`` int32 word planes of ``[lines, words]`` in, a bool per
    line out."""
    return ("packed_any", 4 * planes * lines * words + lines,
            2 * planes * lines * words)


def packed_fanout(lines: int, words: int, home_flags: bool = True
                  ) -> Launch:
    """Two word planes and per-line node and request flags (and the home
    flags) in, two word planes out."""
    return ("packed_fanout",
            16 * lines * words + (8 if home_flags else 6) * lines,
            (10 if home_flags else 8) * lines * words)


def bound_s(launch: Launch) -> float:
    _, nbytes, nops = launch
    return max(nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S)


def step_launches(M: int, R: int, L: int, packed: bool) -> List[Launch]:
    """The kernel launches of one fleet step, in no particular order:
    two credit ranks (the fan-out and the requests), the arbitration over
    R remotes and the home, five grouped counter folds (downgrade
    replies, voluntary downgrades, parked requests, grants, downgrades
    delivered), the latency histogram; on packed planes also the four
    any-bit tests (absorb twice, the pending test, the grant test over
    four planes) and the fan-out words."""
    out = [credit_rank(M * R * L), credit_rank(M * R * L),
           arb_winner(R + 1, L, M)]
    out += [count_fold(n, M) for n in (R * L, R * L, L, L, R * L)]
    out.append(lat_hist(M * R, L))
    if packed:
        W = (R + 31) // 32
        out += [packed_any(M * L, W, k) for k in (1, 1, 1, 4)]
        out.append(packed_fanout(M * L, W))
    return out
