"""Quiescence-free streaming driver for the N-remote engine (closed loop).

The port of ``repro.traffic.driver.run_stream`` for closed-loop runs:
every remote issues new ops from its stream EVERY step while earlier
transactions are still in flight.

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
  after the last step.

An accepted op retires once the agent's MSHR for its line is clear again
(hits the same step, misses when the grant lands).  The retirement TRACE
is what ``traffic.counters.validate_run`` replays into the atomic
``MultiNodeRef``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine_mn import EngineMN, EngineMNState, busy_flag_mn, step_mn
from ..core.messages import MsgType
from ..core.protocol import LocalOp
from .config import StreamConfig, WorkloadSpec
from .counters import Counters, RetirementTrace, make_counters, \
    update_counters

# the issue window scatters ops into dense planes where a zero is "no op".
assert int(LocalOp.NOP) == 0 and int(MsgType.NOP) == 0


def default_steps(ops: int, n_remotes: int, last_arrival: int = 0) -> int:
    """Step budget covering an ``ops``-per-remote stream plus drain tail
    (the reference's rule: it scales with TOTAL ops, ``R * ops``)."""
    return 2 * ops * n_remotes + 12 * ops + 64 + int(last_arrival)


class StreamRun(NamedTuple):
    """Result of one streaming run."""

    state: EngineMNState      # final engine state (on the engine's device)
    counters: Counters        # on the CPU
    msg_count: np.ndarray     # [16] int64: delivered messages, this run
    payload_msgs: int         # messages that carried line data, this run
    trace: Optional[RetirementTrace]
    completed: bool           # stream fully consumed AND engine quiescent


def run_stream(engine: EngineMN, cfg: StreamConfig,
               st: Optional[EngineMNState] = None) -> StreamRun:
    """Drive one closed-loop streaming run of ``engine`` under ``cfg``.

    ``st`` optionally continues from an earlier run's state.  The whole
    ``[T, R]`` op stream is checked against the engine's protocol subset
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
    T, R = op_np.shape
    if R != engine.n_remotes:
        raise ValueError(f"workload has {R} remotes, engine "
                         f"{engine.n_remotes}")
    steps = cfg.steps or default_steps(T, R)
    W = int(cfg.width)
    L, B = engine.n_lines, engine.block
    dev = engine.device

    st0 = engine.init() if st is None else st
    base_msgs = st0.msg_count.cpu().numpy().astype(np.int64)
    base_payload = int(st0.payload_msgs)

    wl_op = torch.as_tensor(op_np, dtype=torch.int8).to(dev)
    wl_line = torch.as_tensor(np.asarray(wl.line), dtype=torch.int64).to(dev)
    wl_value = torch.as_tensor(np.asarray(wl.value),
                               dtype=st0.dir.backing.dtype).to(dev)
    tsteps = torch.arange(steps, dtype=torch.int32, device=dev)
    ar = torch.arange(R, device=dev)[:, None]              # [R, 1]
    ar_rl = ar.expand(R, L)
    wr = torch.arange(W, device=dev)
    earlier = wr[None, :] < wr[:, None]                     # [Wk, Wj] j<k
    zb = torch.zeros(L, dtype=torch.bool, device=dev)
    zwv = torch.zeros((L, B), dtype=st0.dir.backing.dtype, device=dev)

    stt = st0
    cursor = torch.zeros(R, dtype=torch.int64, device=dev)
    issued = torch.zeros((R, W), dtype=torch.bool, device=dev)
    slot_born = torch.zeros((R, W), dtype=torch.int32, device=dev)
    outstanding = torch.zeros((R, L), dtype=torch.bool, device=dev)
    born = torch.zeros((R, L), dtype=torch.int32, device=dev)
    ctr = make_counters(R, dev)
    if cfg.collect_trace:
        out_idx = torch.zeros((R, L), dtype=torch.int64, device=dev)
        # row T is a scratch row the non-retiring lanes write into.
        retire = torch.full((T + 1, R), -1, dtype=torch.int32, device=dev)

    def plane(tgt, src, dtype):
        """Scatter ``[R, W]`` slot values into a dense ``[R, L]`` plane at
        columns ``tgt``; column L is a scratch column, sliced off."""
        p = torch.zeros((R, L + 1), dtype=dtype, device=dev)
        return p.scatter_(1, tgt, src.to(dtype))[:, :L]

    for t in range(steps):
        # ---- fetch each remote's issue window ---------------------------
        idx = cursor[:, None] + wr[None, :]                 # [R, W]
        active = idx < T
        idxc = torch.clamp(idx, max=T - 1)
        s_op = wl_op[idxc, ar]                              # [R, W]
        s_line = wl_line[idxc, ar]
        s_val = wl_value[idxc, ar]
        is_nop = s_op == int(LocalOp.NOP)
        pending = active & ~issued
        real = pending & ~is_nop
        # one MSHR per (remote, line): a slot waits behind an EARLIER
        # un-issued slot on its line, and while its line is in flight.
        can = real & ~outstanding[ar, s_line]
        if W > 1:
            same = s_line[:, :, None] == s_line[:, None, :]  # [R, Wk, Wj]
            can = can & ~(real[:, None, :] & same & earlier[None]).any(-1)
        # scatter the issuable slots into dense [R, L] planes: at most one
        # issuable slot per (remote, line); the rest go to scratch column L.
        tgt = torch.where(can, s_line, L)
        opd = plane(tgt, s_op, torch.int8)
        vald = plane(tgt, s_val, zwv.dtype)[:, :, None]
        born_d = plane(tgt, slot_born, torch.int32)

        # ---- one engine step under sustained traffic --------------------
        st2, out = step_mn(engine.tables, stt, opd, vald, zb, zb, zwv,
                           engine.delays, engine.credits)

        # ---- adopt newly accepted ops, detect retirements ---------------
        newly = out.accepted
        outstanding = outstanding | newly
        born = torch.where(newly, born_d, born)
        mshr_free = (st2.agents.pending_op == int(LocalOp.NOP)) & \
            (st2.agents.pending_req == int(MsgType.NOP))
        retired = outstanding & mshr_free
        outstanding = outstanding & ~retired

        if cfg.collect_trace:
            idx_d = plane(tgt, idxc, torch.int64)
            out_idx = torch.where(newly, idx_d, out_idx)
            row = torch.where(retired, out_idx, T)
            retire.index_put_((row, ar_rl), tsteps[t])

        # ---- slide each window past its issued prefix -------------------
        slot_acc = can & newly[ar, s_line]
        issued = issued | slot_acc | (pending & is_nop)
        shift = torch.cumprod(issued.to(torch.int32), dim=1).sum(1)
        k2 = wr[None, :] + shift[:, None]
        in_w = k2 < W
        k2c = torch.clamp(k2, max=W - 1)
        issued2 = torch.gather(issued, 1, k2c) & in_w
        slot_born2 = torch.where(in_w, torch.gather(slot_born, 1, k2c),
                                 t + 1)

        # ---- hardware-style counters ------------------------------------
        lat = t - born
        waiting = active & ~issued
        head_wait = (t - slot_born).masked_fill(~waiting, 0).amax(dim=1)
        step_active = active.any() | busy_flag_mn(st2)
        ctr = update_counters(ctr, st2, retired=retired, lat=lat,
                              outstanding=outstanding, head_wait=head_wait,
                              step_active=step_active)

        stt, cursor = st2, cursor + shift
        issued, slot_born = issued2, slot_born2

    completed = bool((cursor >= T).all() & ~outstanding.any()
                     & ~busy_flag_mn(stt))
    trace = None
    if cfg.collect_trace:
        trace = RetirementTrace(
            retire_step=retire[:-1].cpu().numpy(),
            op=op_np, line=np.asarray(wl.line), value=np.asarray(wl.value),
            n_lines=L)
    return StreamRun(
        state=stt,
        counters=Counters(*(x.cpu() for x in ctr)),
        msg_count=stt.msg_count.cpu().numpy().astype(np.int64) - base_msgs,
        payload_msgs=int(stt.payload_msgs) - base_payload,
        trace=trace,
        completed=completed,
    )
