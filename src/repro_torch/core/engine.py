"""The two-node coherency engine: directory + agent + VC transport, wired.

The port of ``repro.core.engine``: a home node (``core.directory``, the
directory and the backing store), one remote caching agent
(``core.agent``) and four virtual-channel classes between them
(``core.transport``) with per-VC delays (cross-VC reordering) and
credit-based flow control.  ``step`` is one step over all lines, phase
for phase the reference's and bit-identical to it on the same inputs
(``tests/test_torch_two_node.py``).

Deadlock freedom: the response classes have unbounded credit (a response
can always sink); the request classes have finite credit and stall at
submission.

Of the step's inner planes, two run as CUDA kernels on the card (their
plain versions on the CPU): the credit ranks of the three credited
submits (``credit_rank``: the dry run in ``stall_unready_ops``, the
remote's request submit, the home's downgrade submit) and the four
message-counter folds (``count_fold``, through ``_count``, which the
N-remote engine shares).

``Engine.run_ops`` drains to quiescence in a host loop: torch has no
device while-loop, so each round reads one combined flag on the host
(the reference fuses the loop into one ``lax.while_loop``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import coherency_step as K
from . import agent as ag
from . import directory as dr
from . import transport as tp
from .messages import MsgType
from .protocol import LocalOp, TwoNodeTables, two_node_tables

_NOP = int(MsgType.NOP)
_LOAD = int(LocalOp.LOAD)


def _count(msg_count, payload_msgs, mask, msg, has_payload):
    """Accumulate delivered-message counts by type through the
    ``count_fold`` kernel (its plain version on the CPU), which adds the
    running totals in the same launch.  Returns the new ``(msg_count [16]
    int32, payload_msgs [] int32)``.

    A fleet state carries one row of counts per member, ``msg_count [M,
    16]`` and ``payload_msgs [M]``, with the member axis leading every
    plane: then each member's lanes fold into its own row, through the
    grouped form of the same one launch."""
    if msg_count.dim() == 2:
        G = msg_count.shape[0]
        return K.count_fold(mask.reshape(G, -1).contiguous(),
                            msg.reshape(G, -1).contiguous(),
                            has_payload.reshape(G, -1).contiguous(),
                            base=(msg_count, payload_msgs), grouped=True)
    return K.count_fold(mask.contiguous(), msg.contiguous(),
                        has_payload.contiguous(),
                        base=(msg_count, payload_msgs))


class EngineState(NamedTuple):
    dir: dr.DirectoryState
    agent: ag.AgentState
    ch_req: tp.Channel     # remote -> home, coherence requests
    ch_resp: tp.Channel    # home -> remote, responses
    ch_hreq: tp.Channel    # home -> remote, home-initiated downgrades
    ch_hresp: tp.Channel   # remote -> home, downgrade replies
    hreq_pending: torch.Tensor   # [L] int8: home request awaiting reply
    want_read: torch.Tensor      # [L] bool: home-side read outstanding
    want_write: torch.Tensor     # [L] bool: home-side write outstanding
    want_wval: torch.Tensor      # [L, B]
    msg_count: torch.Tensor      # [16] int32: delivered messages by type
    payload_msgs: torch.Tensor   # [] int32: messages that carried data
    step_no: torch.Tensor        # [] int32


class StepOutput(NamedTuple):
    load_done: torch.Tensor    # [L] bool — a LOAD retired this step
    load_val: torch.Tensor     # [L, B]
    hread_done: torch.Tensor   # [L] bool — a home-side read retired
    hread_val: torch.Tensor    # [L, B]
    accepted: torch.Tensor     # [L] bool — this step's remote ops accepted


def make_engine_state(backing: torch.Tensor) -> EngineState:
    """A quiescent state over ``backing`` (on its device)."""
    L, B = backing.shape
    dev, dt = backing.device, backing.dtype

    def mk():
        return tp.make_channel(L, B, dt, device=dev)

    return EngineState(
        dir=dr.make_directory(backing),
        agent=ag.make_agent(L, B, dt, device=dev),
        ch_req=mk(), ch_resp=mk(), ch_hreq=mk(), ch_hresp=mk(),
        hreq_pending=torch.zeros(L, dtype=torch.int8, device=dev),
        want_read=torch.zeros(L, dtype=torch.bool, device=dev),
        want_write=torch.zeros(L, dtype=torch.bool, device=dev),
        want_wval=torch.zeros((L, B), dtype=dt, device=dev),
        msg_count=torch.zeros(16, dtype=torch.int32, device=dev),
        payload_msgs=torch.zeros((), dtype=torch.int32, device=dev),
        step_no=torch.zeros((), dtype=torch.int32, device=dev),
    )


def busy_flag(st: EngineState) -> torch.Tensor:
    """[] bool tensor: any transaction, channel slot or home want is still
    in flight (stays on the device)."""
    # the [L] int8 code planes are non-zero exactly where busy, so one OR
    # of them carries every per-lane test.
    lanes = (st.agent.pending_req | st.agent.pending_op | st.hreq_pending
             | st.ch_req.msg | st.ch_resp.msg | st.ch_hreq.msg
             | st.ch_hresp.msg)
    return lanes.any() | st.want_read.any() | st.want_write.any()


def stall_unready_ops(tables: TwoNodeTables, ch_req: tp.Channel,
                      eff_op: torch.Tensor, remote_state: torch.Tensor,
                      credits: torch.Tensor) -> torch.Tensor:
    """Defer local ops whose outgoing message the transport cannot take.

    Dry-runs the submission's acceptance (slot free + VC credit, the rank
    ``tp.submit`` takes) and masks the ops it refuses to NOP so the caller
    retries them: without this a dirty eviction would apply its M->I hit
    transition at the agent and then drop the VOL_DOWNGRADE_I payload
    when the VC is out of credit.  The surviving emissions are a subset of
    the dry run's candidates, so the real submit accepts all of them."""
    rs = remote_state.long()
    req_of = tables.loc_request[eff_op.long(), rs]
    would_emit = req_of != _NOP
    acc_pre = tp.credit_accept(ch_req, tp.CLASS_REMOTE_REQ,
                               would_emit & (ch_req.msg == _NOP), credits)
    return eff_op.masked_fill(would_emit & ~acc_pre, int(LocalOp.NOP))


def step(tables: TwoNodeTables, st: EngineState, op: torch.Tensor,
         op_val: torch.Tensor, want_read: torch.Tensor,
         want_write: torch.Tensor, wval: torch.Tensor, delays: torch.Tensor,
         credits: torch.Tensor, stateless: bool = False
         ) -> Tuple[EngineState, StepOutput]:
    """One engine step: op [L] int8 LocalOp, op_val [L, B], the home-side
    wants [L] bool and their values wval [L, B]."""
    msg_count, payload_msgs = st.msg_count, st.payload_msgs

    # accumulate new home-side wants.
    want_read = st.want_read | want_read
    want_write = st.want_write | want_write
    wv = torch.where((want_write & ~st.want_write)[:, None], wval,
                     st.want_wval)

    # ---- 1. time advances on all channels --------------------------------
    ch_req, ch_resp = tp.tick(st.ch_req), tp.tick(st.ch_resp)
    ch_hreq, ch_hresp = tp.tick(st.ch_hreq), tp.tick(st.ch_hresp)

    # ---- 2. deliver remote requests at the home directory ----------------
    ch_req_in = ch_req
    ch_req, arrived = tp.deliver(ch_req, tp.CLASS_REMOTE_REQ, delays)
    dstate, resp, resp_dirty, resp_pay = dr.process(
        tables, st.dir, arrived, ch_req_in.msg, ch_req_in.dirty,
        ch_req_in.payload, stateless=stateless)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, arrived,
                                     ch_req_in.msg, ch_req_in.dirty)
    # responses sink unconditionally (deadlock-freedom argument).
    send_resp = resp != _NOP
    ch_resp, _ = tp.submit(ch_resp, tp.CLASS_HOME_RESP, send_resp, resp,
                           resp_dirty, resp_pay, credits, unbounded=True)
    msg_count, payload_msgs = _count(
        msg_count, payload_msgs, send_resp, resp,
        (resp == int(MsgType.RESP_DATA))
        | (resp == int(MsgType.RESP_DATA_DIRTY)))

    # ---- 3. deliver responses at the remote agent ------------------------
    ch_resp_in = ch_resp
    ch_resp, r_arr = tp.deliver(ch_resp, tp.CLASS_HOME_RESP, delays)
    was_load = st.agent.pending_op == _LOAD
    astate, nack = ag.on_response(tables, st.agent, r_arr, ch_resp_in.msg,
                                  ch_resp_in.payload)
    load_done = r_arr & was_load & ~nack
    load_val = astate.cache.masked_fill(~load_done[:, None], 0)

    # ---- 4. deliver home-initiated downgrades at the remote --------------
    ch_hreq_in = ch_hreq
    ch_hreq, h_arr = tp.deliver(ch_hreq, tp.CLASS_HOME_REQ, delays)
    astate, hresp, hresp_dirty, hresp_pay = ag.on_home_msg(
        tables, astate, h_arr, ch_hreq_in.msg)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, h_arr,
                                     ch_hreq_in.msg, torch.zeros_like(h_arr))
    send_h = hresp != _NOP
    ch_hresp, _ = tp.submit(ch_hresp, tp.CLASS_REMOTE_RESP, send_h, hresp,
                            hresp_dirty, hresp_pay, credits, unbounded=True)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, send_h, hresp,
                                     hresp_dirty)

    # ---- 5. deliver downgrade replies at the home ------------------------
    ch_hresp_in = ch_hresp
    ch_hresp, hr_arr = tp.deliver(ch_hresp, tp.CLASS_REMOTE_RESP, delays)
    # the transaction layer matches the reply to the original home request:
    dstate, _, _, _ = dr.process(
        tables, dstate, hr_arr, st.hreq_pending, ch_hresp_in.dirty,
        ch_hresp_in.payload, stateless=stateless)
    hreq_pending = st.hreq_pending.masked_fill(hr_arr, _NOP)

    # ---- 6. remote submits local ops (fresh + parked retries) ------------
    # Lines with a home-initiated downgrade in flight are LOCKED for new
    # remote transactions (per-line mutual exclusion).
    locked = (hreq_pending != _NOP) | (ch_hreq.msg != _NOP)
    parked = (astate.pending_op != int(LocalOp.NOP)) & \
        (astate.pending_req == _NOP)
    eff_op = torch.where(parked, astate.pending_op, op)
    eff_op = eff_op.masked_fill(locked, int(LocalOp.NOP))
    eff_op = stall_unready_ops(tables, ch_req, eff_op, astate.remote_state,
                               credits)
    eff_val = torch.where(parked[:, None], astate.pending_val, op_val)
    astate2, accepted, emit, req_dirty, req_pay = ag.submit(
        tables, astate, eff_op, eff_val)
    send_req = emit != _NOP
    ch_req, acc_req = tp.submit(ch_req, tp.CLASS_REMOTE_REQ, send_req, emit,
                                req_dirty, req_pay, credits)
    # belt-and-braces: the dry run guarantees acceptance, but revert the
    # MSHR of any refused line so a miss retries rather than hangs.
    refused = send_req & ~acc_req
    astate2 = astate2._replace(
        pending_req=astate2.pending_req.masked_fill(refused, _NOP))
    # load hits retire immediately.
    o = eff_op.long()
    hit = tables.loc_hit[o, astate.remote_state.long()]
    load_hit = accepted & hit & (o == _LOAD)
    load_done = load_done | load_hit
    load_val = torch.where(load_hit[:, None], astate2.cache, load_val)

    # ---- 7. home-side accesses -------------------------------------------
    # The home only initiates a downgrade on a line with no remote
    # transaction anywhere in flight (per-line serialization, see step 6).
    remote_busy = (astate2.pending_req != _NOP) | \
        (astate2.pending_op != int(LocalOp.NOP)) | \
        (ch_req.msg != _NOP) | (ch_resp.msg != _NOP)
    idle_home = (hreq_pending == _NOP) & ~remote_busy
    need = dr.needed_downgrade(dstate, want_read & idle_home,
                               want_write & idle_home)
    # no downgrade needed -> the access retires now.
    ready = idle_home & (need == _NOP) & (want_read | want_write)
    hread_done = ready & want_read
    hread_val = dr.home_read_value(dstate).masked_fill(
        ~hread_done[:, None], 0)
    dstate = dr.home_apply_write(dstate, ready & want_write, wv)
    # downgrade needed -> emit on the home-request VC.
    send_hreq = idle_home & (need != _NOP)
    ch_hreq, acc_h = tp.submit(ch_hreq, tp.CLASS_HOME_REQ, send_hreq, need,
                               torch.zeros_like(send_hreq), dstate.home_buf,
                               credits)
    hreq_pending = torch.where(acc_h, need, hreq_pending)

    new = EngineState(
        dir=dstate, agent=astate2,
        ch_req=ch_req, ch_resp=ch_resp, ch_hreq=ch_hreq, ch_hresp=ch_hresp,
        hreq_pending=hreq_pending,
        want_read=want_read & ~ready, want_write=want_write & ~ready,
        want_wval=wv, msg_count=msg_count, payload_msgs=payload_msgs,
        step_no=st.step_no + 1,
    )
    # the caller's op was taken only where it (not a parked retry) ran.
    return new, StepOutput(load_done, load_val, hread_done, hread_val,
                           accepted & ~parked)


def run_ops(step_fn, busy_fn, st, opv: torch.Tensor, op_val: torch.Tensor,
            max_rounds: int, reduce_remotes: bool):
    """Submit ``opv`` and step until it is taken and the engine is quiet,
    at most ``max_rounds`` steps: the rounds of the reference's
    ``lax.while_loop``, in a host loop that reads one flag a round.
    ``step_fn(st, opv) -> (st, out)``; ``reduce_remotes`` folds the
    N-remote outputs' ``[R, L]`` planes over the remote axis (at most one
    remote acts per line per call).  Returns (state, done [L], vals [L,
    B], rounds, still_busy), the last two host values."""
    L, B = st.dir.backing.shape
    done = torch.zeros(L, dtype=torch.bool, device=opv.device)
    vals = torch.zeros((L, B), dtype=st.dir.backing.dtype,
                       device=opv.device)
    opv = opv.to(torch.int8)
    rounds = 0
    while rounds < max_rounds and bool(opv.any() | busy_fn(st)):
        st, out = step_fn(st, opv, op_val)
        opv = opv.masked_fill(out.accepted, 0)
        ld, lv = out.load_done, out.load_val
        if reduce_remotes:
            ld, lv = ld.any(0), lv.sum(0)
        done = done | ld
        vals = torch.where(ld[:, None], lv, vals)
        rounds += 1
    still_busy = (rounds == max_rounds) and bool(opv.any() | busy_fn(st))
    return st, done, vals, rounds, still_busy


class Engine:
    """Binds the tables (``FULL`` with ``moesi``, else ``MINIMAL``), the
    stateless home, delays, credits and a device to the step.  ``device``
    defaults to ``"cuda"``; with no GPU present that raises — pass
    ``device="cpu"`` for the plain path."""

    def __init__(self, backing, moesi: bool = True, stateless: bool = False,
                 delays: Optional[np.ndarray] = None,
                 credits: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.moesi = bool(moesi)
        self.stateless = bool(stateless)
        self.tables = two_node_tables(self.moesi, self.device)
        self._backing = torch.as_tensor(backing).to(self.device)
        self.n_lines, self.block = self._backing.shape
        self.delays = torch.as_tensor(
            delays if delays is not None else tp.DEFAULT_DELAYS,
            dtype=torch.int32).to(self.device)
        self.credits = torch.as_tensor(
            credits if credits is not None else tp.DEFAULT_CREDITS,
            dtype=torch.int32).to(self.device)

    def init(self) -> EngineState:
        """A quiescent state over a fresh copy of the backing data."""
        return make_engine_state(self._backing.clone())

    def step(self, st: EngineState, op=None, op_val=None,
             want_read=None, want_write=None, wval=None
             ) -> Tuple[EngineState, StepOutput]:
        L, B = self.n_lines, self.block
        dev, dt = self.device, st.dir.backing.dtype
        if op is None:
            op = torch.zeros(L, dtype=torch.int8, device=dev)
        if op_val is None:
            op_val = torch.zeros((L, B), dtype=dt, device=dev)
        if want_read is None:
            want_read = torch.zeros(L, dtype=torch.bool, device=dev)
        if want_write is None:
            want_write = torch.zeros(L, dtype=torch.bool, device=dev)
        if wval is None:
            wval = torch.zeros((L, B), dtype=dt, device=dev)
        return step(self.tables, st, op, op_val, want_read, want_write,
                    wval, self.delays, self.credits,
                    stateless=self.stateless)

    def quiescent(self, st: EngineState) -> bool:
        return not bool(busy_flag(st))

    def drain(self, st: EngineState, max_steps: int = 64) -> EngineState:
        """Run empty steps until all transactions retire (at most
        ``max_steps``)."""
        for _ in range(max_steps):
            if self.quiescent(st):
                break
            st, _ = self.step(st)
        return st

    def run_ops(self, st: EngineState, opv: torch.Tensor,
                op_val: torch.Tensor, max_rounds: int = 64):
        """Submit ``opv`` [L] and drain to quiescence: (state, done [L],
        vals [L, B], rounds, still_busy) — see the module-level
        ``run_ops``."""
        L, B = self.n_lines, self.block
        zb = torch.zeros(L, dtype=torch.bool, device=self.device)
        zwv = torch.zeros((L, B), dtype=st.dir.backing.dtype,
                          device=self.device)

        def step_fn(s, o, v):
            return step(self.tables, s, o, v, zb, zb, zwv, self.delays,
                        self.credits, stateless=self.stateless)

        return run_ops(step_fn, busy_flag, st, opv, op_val, max_rounds,
                       reduce_remotes=False)
