"""Quiescence-free streaming driver for the N-remote engine.

The port of ``repro.traffic.driver.run_stream``: every remote issues new
ops from its stream EVERY step while earlier transactions are still in
flight.

* backpressure comes from the engine: an op it cannot take this step is
  not in the ``accepted`` mask and its slot retries next step;
* each remote keeps a WINDOW of up to ``width`` head-of-stream ops (its
  ``[R, W]`` issue queue); window slots on the line of an earlier
  un-issued slot, or of a transaction in flight, wait in the queue, so
  per-line program order holds while independent lines issue out of
  order;
* the reference's fused ``lax.scan`` is a Python loop over the same step
  budget here.  The loop makes no host synchronisation: issue,
  bookkeeping, the retirement trace and the counters are all tensor
  operations queued on the device, and the host reads the results once,
  after the last step;
* the loop stops once the run is QUIET: no slot left in any stream,
  nothing outstanding and the engine idle (``busy_flag_mn``).  A quiet
  state stays quiet, and a step on it changes only ``step_no`` and
  ``counters.steps``, so the loop adds the steps it skipped to those two
  and the result is the full budget's, bit for bit.  Each step's quiet
  flag is copied to pinned host memory behind a CUDA event, and the host
  reads the flags whose events have completed before it queues a step:
  it never waits, and stops a few steps past quiescence, as far as it
  runs ahead of the card.  An observed run with an injection
  (``ObserveConfig.inject``) steps the whole budget;
* with several homes the engine state stays in the home-major
  ``[H, R, L/H]`` fold for the whole loop (``engine_mn.step_folded``):
  each step folds only its op planes and unfolds only the planes the
  driver reads (``accepted`` and the MSHR-clear mask), and the final
  state is unfolded once — the same result as ``step_mn`` folding and
  unfolding the whole state every step.

An accepted op retires once the agent's MSHR for its line is clear again
(hits the same step, misses when the grant lands).  The retirement TRACE
is what ``traffic.counters.validate_run`` replays into the atomic
``MultiNodeRef``.

**Open loop** (``StreamConfig.arrivals``): each workload slot carries an
arrival step (``traffic.arrivals``).  A slot becomes an issue candidate
only once it has ARRIVED and, when ``StreamConfig.admission`` caps the
batch, only while the transactions in flight stay below ``max_inflight -
reserve``, the candidates admitted FIFO by arrival stamp (a stable
argsort).  Admission gates WHEN an op enters flight, never what it does,
so the oracle replay stays exact; sojourn (arrival -> retirement) and
admission wait fold into ``SOJOURN_EDGES`` histograms carried apart from
``Counters``, and the backlog (arrived, never issued) is counted on the
host after the loop.  With ``arrivals=None`` the loop runs the
closed-loop code alone.

**Observation** (``StreamConfig.observe``): every step also returns its
wire events (``engine_mn.StepEvents``, unfolded to flat lines under
several homes) and folds them into the observability carry
(``traffic.observe.fold_obs``); the run's ``ObsResult`` is read once,
after the loop.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine_mn import (EngineMN, EngineMNState, _f_l, _f_rl,
                              _fold_state_mn, _u_rl, _unfold_state_mn,
                              busy_flag_mn, step_folded, unfold_events)
from ..core.messages import MsgType
from ..core.protocol import LocalOp
from ..spans import span
from .arrivals import check_schedule
from .config import (AdmissionConfig, ArrivalSpec, StreamConfig,
                     WorkloadSpec)
from .counters import (N_SOJ_BUCKETS, SOJOURN_EDGES, Counters,
                       RetirementTrace, make_counters, update_counters)
from .observe import (ObserveConfig, ObsResult, compiled_specs,
                      finalize_obs, fold_obs, make_obs_carry, obs_tables)

# the issue window scatters ops into dense planes where a zero is "no op".
assert int(LocalOp.NOP) == 0 and int(MsgType.NOP) == 0


def default_steps(ops: int, n_remotes: int, last_arrival: int = 0) -> int:
    """Step budget covering an ``ops``-per-remote stream plus drain tail
    (the reference's rule: it scales with TOTAL ops, ``R * ops``), shifted
    out by the last arrival stamp of an open-loop run."""
    return 2 * ops * n_remotes + 12 * ops + 64 + int(last_arrival)


class StreamRun(NamedTuple):
    """Result of one streaming run."""

    state: EngineMNState      # final engine state (on the engine's device)
    counters: Counters        # on the CPU
    msg_count: np.ndarray     # [16] int64: delivered messages, this run
    payload_msgs: int         # messages that carried line data, this run
    trace: Optional[RetirementTrace]
    completed: bool           # stream fully consumed AND engine quiescent
    obs: Optional[ObsResult] = None   # observability digest (observe=...)
    # ---- open-loop serving results (cfg.arrivals set; else None/0) ------
    sojourn_hist: Optional[np.ndarray] = None     # [N_SOJ_BUCKETS] int64
    admit_wait_hist: Optional[np.ndarray] = None  # [N_SOJ_BUCKETS] int64
    backlog: int = 0          # arrived-but-never-issued ops at budget end


def _check_filters(engine: EngineMN, observe: Optional[ObserveConfig],
                   line_filter, type_filter) -> None:
    """Entry validation of the capture filters."""
    if (line_filter is not None or type_filter is not None) \
            and observe is None:
        raise ValueError(
            "line_filter/type_filter restrict the observability capture "
            "ring — they require observe=ObserveConfig(...)")
    for name, filt, shape, what in (
            ("line_filter", line_filter, (engine.n_lines,),
             "[n_lines]"),
            ("type_filter", type_filter, (16,), "[16] (MsgType-indexed)")):
        if filt is None:
            continue
        arr = np.asarray(filt)
        if arr.shape != shape:
            raise ValueError(
                f"{name} must be a {what} bool mask, shape {shape}; "
                f"got shape {arr.shape}")
        if arr.dtype != np.bool_:
            raise ValueError(
                f"{name} must have bool dtype; got {arr.dtype} "
                f"(pass np.asarray(..., bool))")


def _hist_count(hist: torch.Tensor, bucket: torch.Tensor,
                mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``hist`` plus the count of ``mask``ed lanes in each bucket."""
    return hist + ((bucket[..., None] == ids) & mask[..., None]).sum((0, 1))


def run_stream(engine: EngineMN, cfg: StreamConfig,
               st: Optional[EngineMNState] = None) -> StreamRun:
    """Drive one streaming run of ``engine`` under ``cfg``.

    ``st`` optionally continues from an earlier run's state.  The whole
    ``[T, R]`` op stream is checked against the engine's protocol subset,
    and the arrival schedule and capture filters against their shapes,
    before anything is submitted."""
    if not isinstance(cfg, StreamConfig):
        raise TypeError("run_stream(engine, StreamConfig(...))")
    wl = cfg.workload
    if isinstance(wl, WorkloadSpec):
        wl = wl.materialize(engine.n_remotes, engine.n_lines)
    op_np = np.asarray(wl.op)
    if not engine.subset.check_workload(op_np, n_remotes=engine.n_remotes):
        raise ValueError(
            f"workload op stream outside subset '{engine.subset.name}' "
            f"guarantee (allowed ops: "
            f"{sorted(engine.subset.allowed_ops(engine.n_remotes))})")
    T = op_np.shape[0]
    if op_np.shape[1] != engine.n_remotes:
        raise ValueError(f"workload has {op_np.shape[1]} remotes, engine "
                         f"{engine.n_remotes}")
    dev = engine.device
    obs = cfg.observe
    _check_filters(engine, obs, cfg.line_filter, cfg.type_filter)

    # ---- open-loop pieces: arrival schedule + admission ----------------
    open_loop = cfg.arrivals is not None
    adm = cfg.admission if cfg.admission is not None else AdmissionConfig()
    if adm.max_inflight and not open_loop:
        raise ValueError(
            "admission control needs an arrival schedule — set "
            "StreamConfig.arrivals (use arrivals.at_step0 for a "
            "closed-loop-equivalent run)")
    last_arrival = 0
    arr_np = None
    if open_loop:
        arr = cfg.arrivals
        if isinstance(arr, ArrivalSpec):
            arr = arr.materialize(T, engine.n_remotes)
        check_schedule(arr, T, engine.n_remotes)
        arr_np = np.asarray(arr.step)
        last_arrival = int(arr_np.max()) if T else 0

    st0 = engine.init() if st is None else st
    R = st0.agents.remote_state.shape[0]
    steps = cfg.steps or default_steps(T, R, last_arrival)
    base_msgs = st0.msg_count.cpu().numpy().astype(np.int64)
    base_payload = int(st0.payload_msgs)
    dt = st0.dir.backing.dtype
    lp = _stream_loop(
        engine, st0,
        torch.as_tensor(op_np, dtype=torch.int8).to(dev),
        torch.as_tensor(np.asarray(wl.line), dtype=torch.int64).to(dev),
        torch.as_tensor(np.asarray(wl.value), dtype=dt).to(dev),
        steps, int(cfg.width), collect_trace=cfg.collect_trace,
        n_homes=engine.n_homes, home_bw=engine.home_bw,
        shared_credits=engine.shared_credits, arrivals=arr_np,
        admission=adm, observe=obs, line_filter=cfg.line_filter,
        type_filter=cfg.type_filter)

    W = int(cfg.width)
    trace = None
    if cfg.collect_trace:
        trace = RetirementTrace(
            retire_step=lp.retire[:, :-1].T.cpu().numpy(),
            op=op_np, line=np.asarray(wl.line), value=np.asarray(wl.value),
            n_lines=engine.n_lines)
    soj = {}
    if open_loop:
        # backlog = arrived-but-never-issued ops when the budget ran out:
        # the cursor counts each remote's consumed prefix; issued slots
        # past it still sit in the window flags.
        cur = lp.cursor.cpu().numpy()
        idx = cur[:, None] + np.arange(W)[None, :]
        issued_total = int(cur.sum()) + int(
            (lp.issued.cpu().numpy() & (idx < T)).sum())
        soj = dict(sojourn_hist=lp.soj_hist.cpu().numpy(),
                   admit_wait_hist=lp.admit_hist.cpu().numpy(),
                   backlog=int((arr_np < steps).sum()) - issued_total)
    stt = lp.state
    return StreamRun(
        state=stt,
        counters=Counters(*(x.cpu() for x in lp.counters)),
        msg_count=stt.msg_count.cpu().numpy().astype(np.int64) - base_msgs,
        payload_msgs=int(stt.payload_msgs) - base_payload,
        trace=trace,
        completed=bool(lp.completed),
        obs=lp.obs,
        **soj,
    )


class _LoopOut(NamedTuple):
    """What ``_stream_loop`` hands back, all on the device; every field
    leads with the member axis when the loop ran one."""

    state: EngineMNState          # flat (unfolded) final state
    counters: Counters
    completed: torch.Tensor       # [] (or [M]) bool
    cursor: torch.Tensor          # [R] int64: each remote's consumed prefix
    issued: torch.Tensor          # [R, W] bool: issued slots of the window
    retire: Optional[torch.Tensor]  # [R, T + 1] int32; column T scratch
    soj_hist: Optional[torch.Tensor] = None
    admit_hist: Optional[torch.Tensor] = None
    obs: Optional[ObsResult] = None


class _QuietPoll:
    """Whether an earlier step left the loop quiet, read without waiting
    for the device.

    ``push`` takes a step's [] bool ACTIVE flag, false once the run is
    quiet.  On a CUDA device it is copied into a pinned host bool
    (non-blocking) with an event recorded behind it, and ``quiet`` reads
    the oldest flags whose events have completed.  A quiet run stays
    quiet, so a flag that finds every slot of the ring in flight is
    dropped: a later one says the same.  On the CPU a flag is read as it
    is pushed."""

    DEPTH = 8

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.seen = False
        self.inflight = collections.deque()
        if self.cuda:
            self.free = [(torch.empty((), dtype=torch.bool, pin_memory=True),
                          torch.cuda.Event()) for _ in range(self.DEPTH)]
            self.stream = torch.cuda.current_stream(dev)

    def push(self, active: torch.Tensor) -> None:
        if not self.cuda:
            self.seen = not bool(active)
        elif self.free:
            host, ev = slot = self.free.pop()
            host.copy_(active, non_blocking=True)
            ev.record(self.stream)
            self.inflight.append(slot)

    def quiet(self) -> bool:
        while not self.seen and self.inflight \
                and self.inflight[0][1].query():
            slot = self.inflight.popleft()
            self.seen = not bool(slot[0])
            self.free.append(slot)
        return self.seen


def _stream_loop(engine: EngineMN, st0: EngineMNState, wl_op: torch.Tensor,
                 wl_line: torch.Tensor, wl_value: torch.Tensor, steps: int,
                 W: int, *, collect_trace: bool, n_homes: int = 1,
                 home_bw: int = 0, shared_credits: bool = False,
                 width_cap=None, home_group=None, home_bw_t=None,
                 arrivals: Optional[np.ndarray] = None,
                 admission: AdmissionConfig = AdmissionConfig(),
                 observe: Optional[ObserveConfig] = None, line_filter=None,
                 type_filter=None) -> _LoopOut:
    """The step loop of ``run_stream`` and of a fleet (``traffic.fleet``).

    Every per-run tensor carries an optional leading MEMBER axis: a solo
    run has none, a fleet has ``[M]``, and the same loop body steps both
    (``st0`` a member-stacked state, the workload ``[M, T, R]``).  Under
    a fleet the members' issue widths are ``width_cap`` (M ints; ``W`` is
    their maximum, slots past a member's cap never activate and a slot
    sliding in from past it is fresh), and ``home_group``/``home_bw_t``
    (M ints each) ride the engine's home emulation.  ``engine`` supplies
    the protocol tables, delays and credits; the multi-home fold
    (``n_homes``), ``home_bw``, shared credits, the open loop
    (``arrivals``, ``admission``) and observation are solo-only.

    The loop stops at the first QUIET step (every member's streams
    consumed, nothing outstanding, the engine idle), or a few steps later
    on a CUDA device (``_QuietPoll``), and adds the steps it skipped to
    the final ``step_no`` and ``counters.steps``; the steps after a quiet
    one change nothing else, so the result is the whole budget's.  An
    injection into an observed run (``ObserveConfig.inject``) may land
    after quiescence, so such a run steps the whole budget.
    """
    dev = wl_op.device
    members = st0.msg_count.dim() == 2
    lead = tuple(wl_op.shape[:-2])
    T = wl_op.shape[-2]
    H = n_homes
    obs = observe
    open_loop = arrivals is not None
    adm = admission
    assert not members or (H == 1 and not home_bw and not shared_credits
                           and not open_loop and obs is None), \
        "fleets run the flat layout, closed loop, unobserved"
    # the agent plane is dense under both directory layouts (a packed
    # state carries [2, L, W] int32 words instead of [R, L] int8).
    R, L = st0.agents.remote_state.shape[-2:]
    B = st0.dir.backing.shape[-1]
    dt = st0.dir.backing.dtype

    # the workload with the remote axis before the stream axis, so a
    # remote's window is one gather along the last axis.
    wl_op_t, wl_line_t, wl_value_t = (x.transpose(-1, -2).contiguous()
                                      for x in (wl_op, wl_line, wl_value))
    ar = torch.arange(R, device=dev)[:, None]              # [R, 1]
    wr = torch.arange(W, device=dev)
    earlier = wr[None, :] < wr[:, None]                     # [Wk, Wj] j<k
    zb = torch.zeros(lead + (L,), dtype=torch.bool, device=dev)
    zwv = torch.zeros(lead + (L, B), dtype=dt, device=dev)
    w_lim = W
    if width_cap is not None:
        # [M, 1, 1]: each member's window is its own width.
        w_lim = torch.as_tensor(list(width_cap), dtype=torch.int64
                                ).to(dev).reshape(lead + (1, 1))

    def fold(x):
        return _f_rl(x, H) if H > 1 else x

    def unfold(x):
        return _u_rl(x) if H > 1 else x

    if H > 1:
        zb, zwv = _f_l(zb, H), _f_l(zwv, H)
    stt = _fold_state_mn(st0, H) if H > 1 else st0
    cursor = torch.zeros(lead + (R,), dtype=torch.int64, device=dev)
    issued = torch.zeros(lead + (R, W), dtype=torch.bool, device=dev)
    slot_born = torch.zeros(lead + (R, W), dtype=torch.int32, device=dev)
    outstanding = torch.zeros(lead + (R, L), dtype=torch.bool, device=dev)
    born = torch.zeros(lead + (R, L), dtype=torch.int32, device=dev)
    ctr = make_counters(R, dev, lead)
    retire = None
    if collect_trace:
        out_idx = torch.zeros(lead + (R, L), dtype=torch.int64, device=dev)
        # column T is a scratch column the non-retiring lanes write into.
        retire = torch.full(lead + (R, T + 1), -1, dtype=torch.int32,
                            device=dev)

    if open_loop:
        wl_arr = torch.as_tensor(arrivals, dtype=torch.int32).to(dev)
        soj_edges = torch.as_tensor(SOJOURN_EDGES).to(dev)
        soj_ids = torch.arange(N_SOJ_BUCKETS, device=dev)
        soj_born = torch.zeros((R, L), dtype=torch.int32, device=dev)
        soj_hist = torch.zeros(N_SOJ_BUCKETS, dtype=torch.int64, device=dev)
        admit_hist = torch.zeros_like(soj_hist)
        if adm.max_inflight:
            int_max = torch.iinfo(torch.int32).max
            lanes = torch.arange(R * W, device=dev)
    if obs is not None:
        comp = compiled_specs(obs.specs)
        tables = obs_tables(comp, dev)
        oc = make_obs_carry(obs, R, L, comp, dev)
        lf, tf = (None if f is None else
                  torch.as_tensor(np.asarray(f, bool)).to(dev)
                  for f in (line_filter, type_filter))

    def plane(tgt, src, dtype):
        """Scatter ``[R, W]`` slot values into a dense ``[R, L]`` plane at
        columns ``tgt``; column L is a scratch column, sliced off."""
        p = torch.zeros(lead + (R, L + 1), dtype=dtype, device=dev)
        return p.scatter_(-1, tgt, src.to(dtype))[..., :L]

    poll = _QuietPoll(dev) if obs is None or obs.inject is None else None
    ran = steps
    for t in range(steps):
        if poll is not None and poll.quiet():
            ran = t
            break
        with span("driver.window"):
            # ---- fetch each remote's issue window -----------------------
            idx = cursor[..., None] + wr                    # [R, W]
            active = idx < T
            if width_cap is not None:
                # slots past the member's own width never activate.
                active = active & (wr < w_lim)
            idxc = torch.clamp(idx, max=T - 1)
            s_op = wl_op_t.gather(-1, idxc)                 # [R, W]
            s_line = wl_line_t.gather(-1, idxc)
            s_val = wl_value_t.gather(-1, idxc)
            is_nop = s_op == int(LocalOp.NOP)
            pending = active & ~issued
            real = pending & ~is_nop
            # one MSHR per (remote, line): a slot waits behind an EARLIER
            # un-issued slot on its line, and while its line is in flight.
            can = real & ~outstanding.gather(-1, s_line)
            if W > 1:
                same = s_line[..., :, None] == s_line[..., None, :]
                can = can & ~(real[..., None, :] & same & earlier).any(-1)
            if open_loop:
                # ---- continuous-batching admission ----------------------
                # a slot is a candidate only once its stamp has ARRIVED
                # (the conflict mask above keeps every queued real slot,
                # arrived or not, so per-line program order survives any
                # schedule); with a cap, the FIFO-by-stamp earliest
                # candidates fill what the reserve watermark leaves open.
                s_arr = wl_arr[idxc, ar]                    # [R, W]
                arrived = s_arr <= t
                can = can & arrived
                if adm.max_inflight:
                    budget = torch.clamp(adm.max_inflight - adm.reserve
                                         - outstanding.sum(), min=0)
                    # stable argsort: FIFO by stamp, program order on
                    # ties; non-candidates sort to the back.
                    order = torch.argsort(
                        torch.where(can, s_arr, int_max).reshape(-1),
                        stable=True)
                    rank = torch.empty_like(order).scatter_(0, order, lanes)
                    can = can & (rank.view(R, W) < budget)
            # scatter the issuable slots into dense [R, L] planes: at most
            # one issuable slot per (remote, line); the rest go to scratch
            # column L.
            tgt = torch.where(can, s_line, L)
            opd = plane(tgt, s_op, torch.int8)
            vald = plane(tgt, s_val, dt)[..., None]
            born_d = plane(tgt, slot_born, torch.int32)

        # ---- one engine step under sustained traffic --------------------
        with span("engine.step"):
            res = step_folded(engine.tables, stt, fold(opd), fold(vald), zb,
                              zb, zwv, engine.delays, engine.credits,
                              hreq_shared=shared_credits, home_bw=home_bw,
                              emit_events=obs is not None,
                              home_group=home_group, home_bw_t=home_bw_t)
        st2, out = res[:2]

        with span("driver.retire"):
            # ---- adopt newly accepted ops, detect retirements -----------
            newly = unfold(out.accepted)
            outstanding = outstanding | newly
            born = torch.where(newly, born_d, born)
            mshr_free = unfold((st2.agents.pending_op == int(LocalOp.NOP))
                               & (st2.agents.pending_req
                                  == int(MsgType.NOP)))
            retired = outstanding & mshr_free
            outstanding = outstanding & ~retired

            if collect_trace:
                idx_d = plane(tgt, idxc, torch.int64)
                out_idx = torch.where(newly, idx_d, out_idx)
                col = torch.where(retired, out_idx, T)
                retire.scatter_(-1, col, t)

            # ---- sojourn + admission-wait histograms (open loop) --------
            slot_acc = can & newly.gather(-1, s_line)
            nop_skip = pending & is_nop
            if open_loop:
                soj_born = torch.where(
                    newly, plane(tgt, s_arr, torch.int32), soj_born)
                soj_hist = _hist_count(
                    soj_hist, torch.bucketize(t - soj_born, soj_edges,
                                              right=True), retired, soj_ids)
                admit_hist = _hist_count(
                    admit_hist, torch.bucketize(t - s_arr, soj_edges,
                                                right=True), slot_acc,
                    soj_ids)
                # a NOP slot is consumed at its arrival, not before.
                nop_skip = nop_skip & arrived

            # ---- observability plane ------------------------------------
            if obs is not None:
                ev = unfold_events(res[2]) if H > 1 else res[2]
                oc = fold_obs(obs, tables, oc, ev, t, lf, tf, newly=newly,
                              born_d=born_d, retired=retired)

        with span("driver.slide"):
            # ---- slide each window past its issued prefix ---------------
            issued = issued | slot_acc | nop_skip
            shift = torch.cumprod(issued.to(torch.int32), dim=-1).sum(-1)
            k2 = wr + shift[..., None]
            # a slot sliding in from past the member's window is fresh
            # (born now): the boundary is the member's own width.
            in_w = k2 < w_lim
            k2c = torch.clamp(k2, max=W - 1)
            issued2 = torch.gather(issued, -1, k2c) & in_w
            slot_born2 = torch.where(in_w, torch.gather(slot_born, -1, k2c),
                                     t + 1)

        with span("driver.counters"):
            # ---- hardware-style counters --------------------------------
            lat = t - born
            waiting = active & ~issued
            head_wait = (t - slot_born).masked_fill(~waiting, 0).amax(dim=-1)
            step_active = active.flatten(-2).any(-1) | busy_flag_mn(st2)
            ctr = update_counters(ctr, st2, retired=retired, lat=lat,
                                  outstanding=outstanding,
                                  head_wait=head_wait,
                                  step_active=step_active)
            if poll is not None:
                # an outstanding op holds its MSHR, which ``busy_flag_mn``
                # (in ``step_active``) already reads.
                poll.push(step_active.any())

        stt, cursor = st2, cursor + shift
        issued, slot_born = issued2, slot_born2

    if H > 1:
        stt = _unfold_state_mn(stt, st0)
    if ran < steps:
        stt = stt._replace(step_no=stt.step_no + (steps - ran))
        ctr = ctr._replace(steps=ctr.steps + (steps - ran))
    completed = ((cursor >= T).all(-1) & ~outstanding.flatten(-2).any(-1)
                 & ~busy_flag_mn(stt))
    extra = {}
    if open_loop:
        extra.update(soj_hist=soj_hist, admit_hist=admit_hist)
    if obs is not None:
        extra["obs"] = finalize_obs(obs, oc, comp)
    return _LoopOut(state=stt, counters=ctr, completed=completed,
                    cursor=cursor, issued=issued, retire=retire, **extra)
