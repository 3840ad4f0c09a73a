"""The vectorized N-remote coherency engine (paper §4.1, R <= 64), on tensors.

The port of ``repro.core.engine_mn`` for one home, dense directory planes
and per-row credits: ``R`` caching remotes, each a 4-state agent
(``core.agent``) over one ``[R, L]`` slab, a sharer-vector home
(``core.directory_mn``) and four ``[R, L]`` virtual-channel planes
(``core.transport``).  ``step_mn`` is one step over all remotes and
lines, phase for phase the reference's, and bit-identical to it on the
same inputs (``tests/test_torch_engine.py``).

Transaction discipline: the home parks ONE request per line, chosen among
the ready remote requests and the home's own pending access (participant
R, parked as ``HOME_TXN``) by a per-line rotating priority pointer
(``arb_rr``); it fans out one ``HOME_DOWNGRADE_*`` per conflicting sharer
and grants once every reply has arrived and no voluntary downgrade is in
flight on the line.

Three of the step's inner planes run as CUDA kernels on the card (their
plain versions on the CPU): the credit ranks of the two credited submits
(``credit_rank``), the arbitration winner (``arb_winner``) and the five
message-counter folds (``count_fold``).

Not ported yet (they raise ``NotImplementedError``): several homes
(``n_homes``/``home_bw``) and the shared credit pool (ROADMAP Queue 1
item 8), bit-packed planes (item 9), wire-event emission (item 11) and
the fleet's home emulation (item 12).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import coherency_step as K
from . import agent as ag
from . import directory_mn as dmn
from . import transport as tp
from .engine import _count
from .messages import MAX_NODE, MsgType
from .protocol import (ENHANCED_MESI, FULL_MOESI, LocalOp, MnAbsorb,
                       ProtocolSubset, TorchTables, device_tables)
from .states import RemoteView

#: Remote-count ceiling, derived from the EWF v2 node-id field width.
MAX_REMOTES = MAX_NODE + 1

#: ``txn_msg`` sentinel of a line whose transaction slot the HOME holds.
HOME_TXN = 100

_NOP = int(MsgType.NOP)
_VOL_I = int(MsgType.VOL_DOWNGRADE_I)
_VOL_S = int(MsgType.VOL_DOWNGRADE_S)


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"repro_torch: {what} is not ported yet (ROADMAP.md, Queue 1 "
        f"item {item})")


class EngineMNState(NamedTuple):
    dir: dmn.DirectoryMNState
    agents: ag.AgentState        # every field has a leading [R] axis
    ch_req: tp.Channel           # [R, L] remote -> home requests + evictions
    ch_resp: tp.Channel          # [R, L] home -> remote grant responses
    ch_hreq: tp.Channel          # [R, L] home -> remote downgrades (fan-out)
    ch_hresp: tp.Channel         # [R, L] remote -> home downgrade replies
    hreq_pending: torch.Tensor   # [R, L] int8: outstanding HOME_DOWNGRADE_*
    txn_msg: torch.Tensor        # [L] int8: parked request type (NOP = none)
    txn_node: torch.Tensor       # [L] int32: parked requester id
    arb_rr: torch.Tensor         # [L] int32: rotating arbitration pointer
    want_read: torch.Tensor      # [L] bool: home-side read outstanding
    want_write: torch.Tensor     # [L] bool: home-side write outstanding
    want_wval: torch.Tensor      # [L, B]
    msg_count: torch.Tensor      # [16] int32: delivered messages by type
    payload_msgs: torch.Tensor   # [] int32: messages that carried data
    step_no: torch.Tensor        # [] int32


class StepMNOutput(NamedTuple):
    load_done: torch.Tensor      # [R, L] bool — a LOAD retired this step
    load_val: torch.Tensor       # [R, L, B]
    hread_done: torch.Tensor     # [L] bool
    hread_val: torch.Tensor      # [L, B]
    accepted: torch.Tensor       # [R, L] bool — caller ops taken this step


def make_engine_mn_state(backing: torch.Tensor, n_remotes: int
                         ) -> EngineMNState:
    """A quiescent engine over ``backing`` ([L, B], on its device)."""
    L, B = backing.shape
    R = n_remotes
    dev = backing.device

    def mk():
        return tp.make_channel(L, B, backing.dtype, dev, lead=(R,))

    return EngineMNState(
        dir=dmn.make_directory_mn(backing, R),
        agents=ag.make_agent(L, B, backing.dtype, dev, lead=(R,)),
        ch_req=mk(), ch_resp=mk(), ch_hreq=mk(), ch_hresp=mk(),
        hreq_pending=torch.zeros((R, L), dtype=torch.int8, device=dev),
        txn_msg=torch.zeros(L, dtype=torch.int8, device=dev),
        txn_node=torch.zeros(L, dtype=torch.int32, device=dev),
        arb_rr=torch.zeros(L, dtype=torch.int32, device=dev),
        want_read=torch.zeros(L, dtype=torch.bool, device=dev),
        want_write=torch.zeros(L, dtype=torch.bool, device=dev),
        want_wval=torch.zeros((L, B), dtype=backing.dtype, device=dev),
        msg_count=torch.zeros(16, dtype=torch.int32, device=dev),
        payload_msgs=torch.zeros((), dtype=torch.int32, device=dev),
        step_no=torch.zeros((), dtype=torch.int32, device=dev),
    )


class _Consts(NamedTuple):
    """Per-(R, L, device) constants of the step, built once; never written."""

    rids: torch.Tensor      # [R] int64
    vc4: torch.Tensor       # [4, L] int64 VC of each line, per message class
    zero_rl: torch.Tensor   # [R, L] bool
    zero_l: torch.Tensor    # [L] bool
    vol_kind: torch.Tensor  # [R, L] int8, MnAbsorb.VOL_I everywhere
    reply_s: torch.Tensor   # [] int8 MnAbsorb.REPLY_S
    reply_i: torch.Tensor   # [] int8 MnAbsorb.REPLY_I
    zero_f: torch.Tensor    # [] float32


@functools.lru_cache(maxsize=None)
def _consts(R: int, L: int, device: str) -> _Consts:
    def i8(v):
        return torch.tensor(v, dtype=torch.int8, device=device)

    classes = (tp.CLASS_REMOTE_REQ, tp.CLASS_HOME_RESP, tp.CLASS_HOME_REQ,
               tp.CLASS_REMOTE_RESP)
    return _Consts(
        rids=torch.arange(R, device=device),
        vc4=torch.stack([tp.vc_index(L, k, device) for k in classes]),
        zero_rl=torch.zeros((R, L), dtype=torch.bool, device=device),
        zero_l=torch.zeros(L, dtype=torch.bool, device=device),
        vol_kind=torch.full((R, L), int(MnAbsorb.VOL_I), dtype=torch.int8,
                            device=device),
        reply_s=i8(int(MnAbsorb.REPLY_S)), reply_i=i8(int(MnAbsorb.REPLY_I)),
        zero_f=torch.zeros((), dtype=torch.float32, device=device))


def _ready(ch: tp.Channel, delay_l: torch.Tensor) -> torch.Tensor:
    """[R, L] mask of in-flight messages whose VC delay has elapsed."""
    return (ch.msg != _NOP) & (ch.age >= delay_l)


def _pop(ch: tp.Channel, mask: torch.Tensor) -> tp.Channel:
    """Free the slots in ``mask``."""
    return ch._replace(msg=ch.msg.masked_fill(mask, _NOP))


def step_mn(tables: TorchTables, st: EngineMNState, op: torch.Tensor,
            op_val: torch.Tensor, want_read: torch.Tensor,
            want_write: torch.Tensor, wval: torch.Tensor,
            delays: torch.Tensor, credits: torch.Tensor,
            hreq_shared: bool = False, n_homes: int = 1, home_bw: int = 0,
            emit_events: bool = False, home_group=None, home_bw_t=None
            ) -> Tuple[EngineMNState, StepMNOutput]:
    """One engine step over all remotes and lines (see the module doc).

    ``tables`` come from ``protocol.device_tables`` on the state's
    device; ``op`` is the ``[R, L]`` int8 LocalOp plane, ``op_val`` its
    ``[R, L, B]`` store values, ``want_read``/``want_write``/``wval`` the
    home-side accesses.  The step makes no host synchronisation."""
    if hreq_shared:
        _not_ported("the shared home-request credit pool (hreq_shared)", 8)
    if n_homes != 1 or home_bw:
        _not_ported("several homes (n_homes/home_bw)", 8)
    if emit_events:
        _not_ported("wire-event emission (emit_events)", 11)
    if home_group is not None or home_bw_t is not None:
        _not_ported("the fleet's home emulation (home_group/home_bw_t)", 12)
    if st.hreq_pending.dtype != torch.int8:
        _not_ported("bit-packed directory planes", 9)

    R, L = ag.plane_shape(st.agents)
    c = _consts(R, L, str(st.txn_msg.device))
    rids = c.rids
    msg_count, payload_msgs = st.msg_count, st.payload_msgs
    # one gather of the per-line delays of the four classes.
    dly_req, dly_resp, dly_hreq, dly_hresp = delays[c.vc4]

    # accumulate new home-side wants.
    want_read = st.want_read | want_read
    want_write = st.want_write | want_write
    wv = torch.where((want_write & ~st.want_write)[..., None], wval,
                     st.want_wval)

    # ---- 1. time advances on all channels --------------------------------
    ch_req, ch_resp = tp.tick(st.ch_req), tp.tick(st.ch_resp)
    ch_hreq, ch_hresp = tp.tick(st.ch_hreq), tp.tick(st.ch_hresp)

    # ---- 2. downgrade replies arrive at the home -------------------------
    ch_hresp_in = ch_hresp
    ch_hresp, hr_arr = tp.deliver(ch_hresp, tp.CLASS_REMOTE_RESP, delays,
                                  delay_l=dly_hresp)
    rep_kind = torch.where(
        st.hreq_pending == int(MsgType.HOME_DOWNGRADE_S), c.reply_s,
        c.reply_i)
    dstate = dmn.absorb(tables, st.dir, hr_arr, rep_kind, ch_hresp_in.dirty,
                        ch_hresp_in.payload)
    hreq_pending = st.hreq_pending.masked_fill(hr_arr, _NOP)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, hr_arr,
                                     ch_hresp_in.msg, ch_hresp_in.dirty)

    # ---- 3. voluntary downgrades arrive at the home ----------------------
    ready_req = _ready(ch_req, dly_req)
    is_vol = (ch_req.msg == _VOL_I) | (ch_req.msg == _VOL_S)
    pop_vol = ready_req & is_vol
    dstate = dmn.absorb(tables, dstate, pop_vol, c.vol_kind, ch_req.dirty,
                        ch_req.payload)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, pop_vol,
                                     ch_req.msg, ch_req.dirty)

    # ---- 4. arbitration: remotes AND the home compete per free line ------
    req_ready = ready_req & ~is_vol
    # a line is free for a new transaction only when no downgrade round
    # trip is outstanding AND no grant response is still in flight.
    resp_in_flight = tp.any_in_flight(ch_resp)
    pend_any = (hreq_pending != _NOP).any(dim=-2)
    line_free = (st.txn_msg == _NOP) & ~pend_any & ~resp_in_flight
    home_ready = want_read | want_write
    any_req = req_ready.any(dim=-2) | home_ready
    # rotating priority: participant p ranks (p - arb_rr) mod (R+1); the
    # pointer advances past each winner, a bounded wait for every
    # participant (the home is participant R).
    ready_all = torch.cat([req_ready, home_ready[None, :]], dim=0)
    winner = K.arb_winner(ready_all, st.arb_rr)
    accept_line = any_req & line_free
    home_win = accept_line & (winner == R)
    arb_rr = torch.where(accept_line, (winner + 1) % (R + 1), st.arb_rr)
    win_node = torch.clamp(winner, max=R - 1)
    win_msg = dmn._take_remote(ch_req.msg, win_node).masked_fill(home_win,
                                                                  HOME_TXN)
    pop_req = (accept_line & ~home_win)[None, :] & \
        (rids[:, None] == winner[None, :])
    ch_req = _pop(ch_req, pop_vol | (pop_req & req_ready))
    txn_msg = torch.where(accept_line, win_msg, st.txn_msg)
    txn_node = torch.where(accept_line, winner, st.txn_node)
    msg_count, payload_msgs = _count(msg_count, payload_msgs,
                                     accept_line & ~home_win, win_msg,
                                     c.zero_l)

    # ---- 5. fan-out: emit one HOME_DOWNGRADE_* per conflicting sharer ----
    active_txn = txn_msg != _NOP
    is_home_txn = txn_msg == HOME_TXN
    node_c = torch.clamp(txn_node, max=R - 1)
    # an UPGRADE whose requester was concurrently invalidated is doomed to
    # a NACK — suppress its fan-out so the new owner keeps the line.
    req_view_now = dmn.view_of(dstate, node_c)
    doomed = active_txn & (txn_msg == int(MsgType.REQ_UPGRADE)) & \
        (req_view_now != int(RemoteView.S))
    needed_r = dmn.needed_downgrades(
        dstate, active_txn & ~doomed & ~is_home_txn, txn_msg, node_c, rids)
    # a parked HOME transaction fans out through the SAME machinery.
    needed_h = dmn.home_needed_downgrades(
        dstate, want_read & is_home_txn, want_write & is_home_txn)
    needed = torch.where(is_home_txn[None, :], needed_h, needed_r)
    send_h = (needed != _NOP) & (hreq_pending == _NOP)
    # home downgrades carry no data: a zero payload, broadcast (a 0-dim
    # tensor takes the channel's dtype under type promotion).
    ch_hreq, acc_h = tp.submit(ch_hreq, tp.CLASS_HOME_REQ, send_h, needed,
                               c.zero_rl, c.zero_f, credits)
    hreq_pending = torch.where(acc_h, needed, hreq_pending)

    # ---- 6. grant parked requests whose preconditions now hold -----------
    in_flight_vol = ((ch_req.msg == _VOL_I) | (ch_req.msg == _VOL_S)
                     ).any(dim=-2)
    in_flight_h = tp.any_in_flight(ch_hreq) | tp.any_in_flight(ch_hresp)
    # `needed` must be EMPTY, not merely pending-free: a fan-out refused
    # for credit leaves the sharer's view intact.
    complete = active_txn & ~(needed != _NOP).any(dim=-2) & \
        ~(hreq_pending != _NOP).any(dim=-2) & ~in_flight_vol & ~in_flight_h
    complete_r = complete & ~is_home_txn
    dstate, resp, resp_pay = dmn.grant(tables, dstate, complete_r, txn_msg,
                                       node_c, rids)
    # a completed HOME transaction services the access in place.
    complete_h = complete & is_home_txn
    hread_done = complete_h & want_read
    hread_val = dmn.home_value(dstate).masked_fill(
        ~hread_done[..., None], 0)
    dstate = dmn.home_apply_write(dstate, complete_h & want_write, wv)
    want_read2 = want_read & ~complete_h
    want_write2 = want_write & ~complete_h
    txn_msg = txn_msg.masked_fill(complete, _NOP)
    send_resp = (rids[:, None] == txn_node[None, :]) & (resp != _NOP)[None, :]
    ch_resp, _ = tp.submit(ch_resp, tp.CLASS_HOME_RESP, send_resp,
                           resp[None, :], c.zero_rl, resp_pay[None], credits,
                           unbounded=True)
    carries = (resp == int(MsgType.RESP_DATA)) | \
        (resp == int(MsgType.RESP_DATA_DIRTY))
    msg_count, payload_msgs = _count(msg_count, payload_msgs, resp != _NOP,
                                     resp, carries)

    # ---- 7. grant responses arrive at the remotes ------------------------
    ch_resp_in = ch_resp
    ch_resp, r_arr = tp.deliver(ch_resp, tp.CLASS_HOME_RESP, delays,
                                delay_l=dly_resp)
    was_load = st.agents.pending_op == int(LocalOp.LOAD)
    agents, nack = ag.on_response(tables, st.agents, r_arr, ch_resp_in.msg,
                                  ch_resp_in.payload, nack_holds=True)
    load_done = r_arr & was_load & ~nack
    load_val = agents.cache.masked_fill(~load_done[..., None], 0)

    # ---- 8. home-initiated downgrades arrive at the remotes --------------
    ch_hreq_in = ch_hreq
    ch_hreq, h_arr = tp.deliver(ch_hreq, tp.CLASS_HOME_REQ, delays,
                                delay_l=dly_hreq)
    agents, hresp, hresp_dirty, hresp_pay = ag.on_home_msg(
        tables, agents, h_arr, ch_hreq_in.msg)
    msg_count, payload_msgs = _count(msg_count, payload_msgs, h_arr,
                                     ch_hreq_in.msg, c.zero_rl)
    ch_hresp, _ = tp.submit(ch_hresp, tp.CLASS_REMOTE_RESP, hresp != _NOP,
                            hresp, hresp_dirty, hresp_pay, credits,
                            unbounded=True)

    # ---- 9. remotes submit local ops (fresh + parked retries) ------------
    locked = (hreq_pending != _NOP) | (ch_hreq.msg != _NOP)
    parked = (agents.pending_op != int(LocalOp.NOP)) & \
        (agents.pending_req == _NOP)
    eff_op = torch.where(parked, agents.pending_op, op)
    # lanes locked by a home downgrade, and ops outside the subset's MN
    # envelope, issue nothing.
    eff_op = eff_op.masked_fill(locked | ~tables.op_ok[eff_op.long()],
                                int(LocalOp.NOP))
    # An op that would emit a message stalls until the transport CAN take
    # it (slot + credit); the credit rank is computed ONCE, and this
    # dry-run verdict is the final acceptance (the emission set below can
    # only shrink on unchanged occupancy).
    rs = agents.remote_state.long()
    req_of = tables.loc_request[eff_op.long(), rs]
    would_emit = req_of != _NOP
    acc_pre = tp.credit_accept(ch_req, tp.CLASS_REMOTE_REQ,
                               would_emit & (ch_req.msg == _NOP), credits)
    eff_op = eff_op.masked_fill(would_emit & ~acc_pre, int(LocalOp.NOP))
    eff_val = torch.where(parked[..., None], agents.pending_val, op_val)
    agents2, accepted, emit, req_dirty, req_pay = ag.submit(
        tables, agents, eff_op, eff_val)
    ch_req = tp.place(ch_req, emit != _NOP, emit, req_dirty, req_pay)
    # load hits retire immediately.
    o = eff_op.long()
    hit = tables.loc_hit[o, rs]
    load_hit = accepted & hit & (o == int(LocalOp.LOAD))
    load_done = load_done | load_hit
    load_val = torch.where(load_hit[..., None], agents2.cache, load_val)

    new = EngineMNState(
        dir=dstate, agents=agents2,
        ch_req=ch_req, ch_resp=ch_resp, ch_hreq=ch_hreq, ch_hresp=ch_hresp,
        hreq_pending=hreq_pending, txn_msg=txn_msg, txn_node=txn_node,
        arb_rr=arb_rr,
        want_read=want_read2, want_write=want_write2, want_wval=wv,
        msg_count=msg_count, payload_msgs=payload_msgs,
        step_no=st.step_no + 1,
    )
    out = StepMNOutput(load_done, load_val, hread_done, hread_val,
                       accepted & ~parked)
    return new, out


def busy_flag_mn(st: EngineMNState) -> torch.Tensor:
    """[] bool tensor: any transaction, channel slot or home want is
    still in flight (stays on the device; no host synchronisation)."""
    # the [R, L] int8 code planes are non-zero exactly where busy, so one
    # OR of them carries every per-lane test.
    lanes = (st.agents.pending_req | st.agents.pending_op | st.hreq_pending
             | st.ch_req.msg | st.ch_resp.msg | st.ch_hreq.msg
             | st.ch_hresp.msg)
    return (lanes.any() | st.txn_msg.any() | st.want_read.any()
            | st.want_write.any())


class EngineMN:
    """Binds a protocol subset, delays, credits and a device to the step.

    ``moesi`` picks the full protocol (``True`` → FULL_MOESI, ``False`` →
    ENHANCED_MESI) unless an explicit ``subset`` is given.  ``device``
    defaults to ``"cuda"``; with no GPU present that raises — pass
    ``device="cpu"`` for the plain path."""

    def __init__(self, backing, n_remotes: int, moesi: bool = True,
                 delays: Optional[np.ndarray] = None,
                 credits: Optional[np.ndarray] = None,
                 subset: Optional[ProtocolSubset] = None,
                 shared_credits: bool = False,
                 n_homes: int = 1, home_bw: int = 0,
                 packed: bool = False, device=None):
        if not 1 <= n_remotes <= MAX_REMOTES:
            raise ValueError(f"EWF v2 carries 6-bit node ids "
                             f"(n_remotes={n_remotes})")
        if shared_credits:
            _not_ported("the shared home-request credit pool", 8)
        if n_homes != 1 or home_bw:
            _not_ported("several homes (n_homes/home_bw)", 8)
        if packed:
            _not_ported("bit-packed directory planes", 9)
        self.device = resolve_device(device)
        self.n_remotes = n_remotes
        self.subset = subset if subset is not None else \
            (FULL_MOESI if moesi else ENHANCED_MESI)
        self.moesi = self.subset.tables.moesi
        self.tables = device_tables(self.subset, self.device)
        self.shared_credits = False
        self.n_homes = 1
        self.home_bw = 0
        self._backing = torch.as_tensor(backing).to(self.device)
        self.n_lines, self.block = self._backing.shape
        self.delays = torch.as_tensor(
            delays if delays is not None else tp.DEFAULT_DELAYS,
            dtype=torch.int32).to(self.device)
        self.credits = torch.as_tensor(
            credits if credits is not None else tp.DEFAULT_CREDITS,
            dtype=torch.int32).to(self.device)

    @classmethod
    def from_config(cls, cfg, device=None) -> "EngineMN":
        """Build from a ``traffic.config.EngineConfig``-shaped object."""
        from .protocol import SUBSETS
        subset = SUBSETS[cfg.subset] if cfg.subset else None
        credits = None
        if cfg.credits:
            credits = np.asarray([cfg.credits] * tp.N_VCS, np.int32)
        dev = resolve_device(device)
        return cls(torch.zeros((cfg.lines, cfg.block), dtype=torch.float32,
                               device=dev),
                   n_remotes=cfg.remotes, moesi=cfg.moesi, subset=subset,
                   credits=credits, shared_credits=cfg.shared_credits,
                   n_homes=cfg.homes, home_bw=cfg.home_bw,
                   packed=cfg.packed, device=dev)

    def init(self) -> EngineMNState:
        """A quiescent state over a fresh copy of the backing data."""
        return make_engine_mn_state(self._backing.clone(), self.n_remotes)

    def step(self, st: EngineMNState, op=None, op_val=None,
             want_read=None, want_write=None, wval=None
             ) -> Tuple[EngineMNState, StepMNOutput]:
        R, L, B = self.n_remotes, self.n_lines, self.block
        dev, dt = self.device, st.dir.backing.dtype
        if op is None:
            op = torch.zeros((R, L), dtype=torch.int8, device=dev)
        if op_val is None:
            op_val = torch.zeros((R, L, B), dtype=dt, device=dev)
        if want_read is None:
            want_read = torch.zeros(L, dtype=torch.bool, device=dev)
        if want_write is None:
            want_write = torch.zeros(L, dtype=torch.bool, device=dev)
        if wval is None:
            wval = torch.zeros((L, B), dtype=dt, device=dev)
        return step_mn(self.tables, st, op, op_val, want_read, want_write,
                       wval, self.delays, self.credits)

    def quiescent(self, st: EngineMNState) -> bool:
        return not bool(busy_flag_mn(st))

    def drain(self, st: EngineMNState, max_steps: int = 128,
              strict: bool = True) -> EngineMNState:
        """Run empty steps until every transaction retires; raises
        ``RuntimeError`` if still busy after ``max_steps`` (``strict``)."""
        for _ in range(max_steps):
            if self.quiescent(st):
                return st
            st, _ = self.step(st)
        if strict and not self.quiescent(st):
            raise RuntimeError(
                f"EngineMN.drain: engine still busy after {max_steps} "
                f"steps (R={self.n_remotes}, L={self.n_lines})")
        return st
