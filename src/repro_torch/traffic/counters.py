"""Hardware-style perf counters for the streaming driver, and the oracle
replay that validates a run.

The port of ``repro.traffic.counters``.  ``Counters`` is a NamedTuple of
tensors that ``run_stream`` folds every step, on the device, and reads
out once at the end.  The per-step-summed accumulators (``occ_sum``,
``mshr_sum``) are int64 tensors where the reference keeps hi/lo int32
pairs (JAX with x64 off cannot carry an int64); ``acc_total`` is their
exact readout.

Validation (``replay_reference`` + ``assert_counts_match``): a run's
retirement trace is a per-line linearization of it, so replaying the
trace op by op into the atomic ``MultiNodeRef`` must reproduce the
message counts EXACTLY, modulo one identity: an upgrade that lost a race
costs one extra ``REQ_UPGRADE`` + ``RESP_NACK`` before it retires as the
``REQ_READ_EXCL`` the oracle sees.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.messages import MsgType
from ..core.multinode import MultiNodeRef
from ..core.protocol import LocalOp
from ..kernels import coherency_step as K

#: retirement-latency histogram bucket edges (engine steps); bucket i
#: holds lat in [edge[i-1], edge[i]), the last bucket is the overflow.
LAT_EDGES = np.asarray(K.LAT_EDGES, np.int32)
N_LAT_BUCKETS = len(LAT_EDGES) + 1

#: the four coherence channel classes, in Counters.occ_* order.
CHANNELS = ("req", "resp", "hreq", "hresp")


class Counters(NamedTuple):
    """Telemetry folded through ``run_stream``'s step loop (on the device)."""

    lat_hist: torch.Tensor   # [R, N_LAT_BUCKETS] int32 retirement latency
    max_wait: torch.Tensor   # [R] int32 worst request wait (starvation)
    retired: torch.Tensor    # [R] int32 ops retired
    occ_sum: torch.Tensor    # [4] int64 per-class channel occupancy, summed
    occ_peak: torch.Tensor   # [4] int32 per-class peak occupancy
    mshr_sum: torch.Tensor   # [] int64 in-flight transactions, summed
    mshr_peak: torch.Tensor  # [] int32 peak in-flight transactions
    steps: torch.Tensor      # [] int32 steps folded (the full budget)
    active_steps: torch.Tensor  # [] int32 steps with traffic in flight


def make_counters(n_remotes: int, device="cpu") -> Counters:
    def z(shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)

    return Counters(
        lat_hist=z((n_remotes, N_LAT_BUCKETS)), max_wait=z(n_remotes),
        retired=z(n_remotes), occ_sum=z(4, torch.int64), occ_peak=z(4),
        mshr_sum=z((), torch.int64), mshr_peak=z(()), steps=z(()),
        active_steps=z(()))


def acc_total(acc) -> np.ndarray:
    """Host-side readout of an accumulator (``occ_sum``/``mshr_sum``) as
    exact int64 — the counterpart of the reference's hi/lo ``acc_total``."""
    if isinstance(acc, torch.Tensor):
        acc = acc.cpu().numpy()
    return np.asarray(acc, np.int64)


def update_counters(ctr: Counters, st, *, retired: torch.Tensor,
                    lat: torch.Tensor, outstanding: torch.Tensor,
                    head_wait: torch.Tensor,
                    step_active: torch.Tensor) -> Counters:
    """Fold one engine step's events into the counters (on the device).

    ``st`` is the post-step ``EngineMNState``; ``retired``/``lat``/
    ``outstanding`` are ``[R, L]``, ``head_wait`` ``[R]`` and
    ``step_active`` a [] bool tensor.  The latency histogram is the
    ``lat_hist`` kernel (its plain version on the CPU)."""
    hist = ctr.lat_hist + K.lat_hist(lat, retired)
    # the starvation bound: worst of (retired latency, in-flight wait,
    # head-of-stream wait).
    live = lat.masked_fill(~(retired | outstanding), 0).amax(dim=1)
    max_wait = torch.maximum(ctr.max_wait, torch.maximum(live, head_wait))
    msgs = torch.stack([st.ch_req.msg, st.ch_resp.msg, st.ch_hreq.msg,
                        st.ch_hresp.msg])
    occ = (msgs != int(MsgType.NOP)).sum((1, 2), dtype=torch.int32)
    mshr = outstanding.sum(dtype=torch.int32)
    return Counters(
        lat_hist=hist,
        max_wait=max_wait,
        retired=ctr.retired + retired.sum(1, dtype=torch.int32),
        occ_sum=ctr.occ_sum + occ,
        occ_peak=torch.maximum(ctr.occ_peak, occ),
        mshr_sum=ctr.mshr_sum + mshr,
        mshr_peak=torch.maximum(ctr.mshr_peak, mshr),
        steps=ctr.steps + 1,
        active_steps=ctr.active_steps + step_active.to(torch.int32),
    )


def hist_percentiles(hist: np.ndarray, edges: np.ndarray = LAT_EDGES,
                     qs: Tuple[float, ...] = (0.5, 0.99, 0.999)
                     ) -> Dict[str, float]:
    """Percentiles from a bucketed latency histogram (host-side): the
    UPPER edge of the bucket holding each quantile, ``inf`` in the
    overflow bucket, 0 for an empty histogram."""
    counts = np.asarray(hist, np.float64)
    uppers = np.concatenate([np.asarray(edges, np.float64), [np.inf]])
    assert counts.shape == uppers.shape, (counts.shape, len(edges))
    total = counts.sum()
    out = {}
    cdf = np.cumsum(counts)
    for q in qs:
        key = "p" + format(q * 100, "g").replace(".", "")
        if total == 0:
            out[key] = 0.0
            continue
        idx = int(np.searchsorted(cdf, q * total, side="left"))
        out[key] = float(uppers[min(idx, len(uppers) - 1)])
    return out


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(ctr: Counters, msg_count: np.ndarray,
              payload_msgs: int = 0) -> Dict[str, object]:
    """Host-side digest of a run: the numbers a benchmark row reports.
    Sustained rates divide by ``active_steps``, not the step budget."""
    steps = max(int(ctr.steps), 1)
    active = max(int(ctr.active_steps), 1)
    retired = _np(ctr.retired)
    mc = np.asarray(msg_count, np.int64)
    nacks = int(mc[int(MsgType.RESP_NACK)])
    excl = int(mc[int(MsgType.REQ_READ_EXCL)]
               + mc[int(MsgType.REQ_UPGRADE)]) - nacks
    inval = int(mc[int(MsgType.HOME_DOWNGRADE_I)])
    lat_hist = _np(ctr.lat_hist)
    occ_sum = acc_total(ctr.occ_sum)
    occ_peak = _np(ctr.occ_peak)
    return {
        "steps": steps,
        "active_steps": active,
        "ops_retired": int(retired.sum()),
        "ops_per_step": retired.sum() / active,
        "msgs_per_op": float(mc.sum()) / max(int(retired.sum()), 1),
        "retired_per_remote": retired.tolist(),
        "max_wait": _np(ctr.max_wait).tolist(),
        "lat_hist": lat_hist.tolist(),
        "latency_percentiles": hist_percentiles(lat_hist.sum(axis=0)),
        "latency_percentiles_per_remote": [
            hist_percentiles(row) for row in lat_hist],
        "invalidations": inval,
        "inval_per_excl_grant": inval / max(excl, 1),
        "nacks": nacks,
        "mean_occupancy": {ch: float(occ_sum[i]) / active
                           for i, ch in enumerate(CHANNELS)},
        "peak_occupancy": {ch: int(occ_peak[i])
                           for i, ch in enumerate(CHANNELS)},
        "mean_mshr_occupancy": float(acc_total(ctr.mshr_sum)) / active,
        "peak_mshr_occupancy": int(ctr.mshr_peak),
        "payload_msgs": int(payload_msgs),
        "messages": {MsgType(i).name: int(mc[i]) for i in range(16)
                     if mc[i]},
    }


# ---------------------------------------------------------------------------
# Oracle replay: the counter-validation path.
# ---------------------------------------------------------------------------


class RetirementTrace(NamedTuple):
    """Compact retirement linearization of a streamed run:
    ``retire_step[t, r]`` is the step at which remote ``r``'s ``t``-th
    stream op retired (-1 = never); op/line/value come from the workload."""

    retire_step: np.ndarray  # [T, R] int32, -1 = never retired
    op: np.ndarray           # [T, R] int8  LocalOp
    line: np.ndarray         # [T, R] int32
    value: np.ndarray        # [T, R] float32
    n_lines: int


def replay_reference(trace: RetirementTrace, moesi: bool = True,
                     subset=None, n_homes: int = 1
                     ) -> Tuple[MultiNodeRef, np.ndarray]:
    """Replay a run's retirement linearization atomically, in (retire
    step, remote, program order) order.  Returns the oracle and its
    per-message-type counts [16]."""
    rs = np.asarray(trace.retire_step)
    ops = np.asarray(trace.op)
    lines = np.asarray(trace.line)
    vals = np.asarray(trace.value)
    ref = MultiNodeRef(trace.n_lines, n_remotes=rs.shape[1], moesi=moesi,
                       subset=subset, n_homes=n_homes)
    tt, rr = np.nonzero(rs >= 0)
    order = np.lexsort((tt, rr, rs[tt, rr]))
    for t, r in zip(tt[order], rr[order]):
        op = int(ops[t, r])
        if op == int(LocalOp.LOAD):
            ref.load(int(r), int(lines[t, r]))
        elif op == int(LocalOp.STORE):
            ref.store(int(r), int(lines[t, r]), float(vals[t, r]))
        elif op == int(LocalOp.EVICT):
            ref.evict(int(r), int(lines[t, r]))
    counts = np.zeros(16, np.int64)
    for name, _, _ in ref.trace:
        counts[int(MsgType[name])] += 1
    return ref, counts


def assert_counts_match(msg_count: np.ndarray, ref_counts: np.ndarray
                        ) -> None:
    """Engine counts must equal the oracle's EXACTLY, after the one legal
    divergence (each upgrade race adds a REQ_UPGRADE + RESP_NACK)."""
    eng = np.asarray(msg_count, np.int64)
    nacks = int(eng[int(MsgType.RESP_NACK)])
    expect = np.asarray(ref_counts, np.int64).copy()
    expect[int(MsgType.REQ_UPGRADE)] += nacks
    expect[int(MsgType.RESP_NACK)] += nacks
    mism = np.nonzero(eng != expect)[0]
    assert mism.size == 0, (
        "engine/oracle message-count mismatch: " + ", ".join(
            f"{MsgType(i).name}: engine={eng[i]} oracle={expect[i]}"
            for i in mism))


def validate_run(run, moesi: bool = True, subset=None,
                 n_homes: int = 1) -> MultiNodeRef:
    """Full validation of a traced ``StreamRun``: it completed, and its
    message counts match the atomic oracle's.  Returns the oracle."""
    assert run.completed, "stream did not drain within the step budget"
    assert run.trace is not None, "StreamConfig(collect_trace=True) required"
    ref, counts = replay_reference(run.trace, moesi, subset=subset,
                                   n_homes=n_homes)
    ref.check_all()
    assert_counts_match(run.msg_count, counts)
    return ref
