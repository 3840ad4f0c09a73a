"""The plain reference of a sweep fleet: the N-remote coherency engine
(one home, dense ``[R, L]`` planes) and the closed-loop stream driver,
stepped over a leading member axis in plain PyTorch.

It follows the protocol of the ECI paper (``protocol.py``) with the
engine's schedule: per step, time advances on the four virtual-channel
planes; downgrade replies, then voluntary downgrades, are absorbed at the
home; each free line parks one ready request by rotating priority; the
home fans out one ``HOME_DOWNGRADE_*`` per conflicting sharer, within the
VC credits; a parked request is granted once its fan-out has landed;
grants and downgrades arrive at the remotes; each remote issues from a
window of ``W`` head-of-stream ops.  Each VC delivers after its own delay
and holds at most ``CREDITS`` messages per initiator.  The driver folds
the counters (retirement-latency histogram, channel occupancy, in-flight
transactions) and a retirement trace every step.

Nothing here is written for speed: every reduction is the plain tensor
expression, and the packed directory layout has no path of its own (a
packed run holds the same semantic state; ``check.record`` unpacks it).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import protocol as P

#: per-VC delivery delay in steps (5 classes x odd/even lines).
DELAYS = (1, 2, 1, 3, 2, 1, 3, 1, 2, 2)
#: messages each initiator may hold in flight on one VC.
CREDITS = 64
#: message classes: remote request, home response, home request, remote
#: response (each on the VC pair ``2 * class + line parity``; the VC
#: credits are uniform, so only the delays tell the VCs apart).
REQ, RESP, HREQ, HRESP = 0, 1, 2, 3
#: retirement-latency histogram edges, in steps.
LAT_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def default_steps(ops: int, n_remotes: int) -> int:
    """A closed-loop stream's step budget: its ops plus a drain tail."""
    return 2 * ops * n_remotes + 12 * ops + 64


class Dir(NamedTuple):
    home_state: torch.Tensor   # [M, L] int8
    view: torch.Tensor         # [M, R, L] int8 remote views
    backing: torch.Tensor      # [M, L, B] float32 data at rest
    home_buf: torch.Tensor     # [M, L, B] the home's copy
    illegal: torch.Tensor      # [M] int32


class Agents(NamedTuple):
    remote_state: torch.Tensor  # [M, R, L] int8
    cache: torch.Tensor         # [M, R, L, B]
    pending_req: torch.Tensor   # [M, R, L] int8 request in flight
    pending_op: torch.Tensor    # [M, R, L] int8 op to finish on the grant
    pending_val: torch.Tensor   # [M, R, L, B] its store value
    illegal: torch.Tensor       # [M, R] int32
    hits: torch.Tensor          # [M, R] int32
    misses: torch.Tensor        # [M, R] int32


class Channel(NamedTuple):
    msg: torch.Tensor          # [M, R, L] int8 (NOP = empty slot)
    dirty: torch.Tensor        # [M, R, L] bool
    payload: torch.Tensor      # [M, R, L, B]
    age: torch.Tensor          # [M, R, L] int32


class State(NamedTuple):
    dir: Dir
    agents: Agents
    ch_req: Channel
    ch_resp: Channel
    ch_hreq: Channel
    ch_hresp: Channel
    hreq_pending: torch.Tensor  # [M, R, L] int8 downgrade awaiting reply
    txn_msg: torch.Tensor       # [M, L] int8 parked request per line
    txn_node: torch.Tensor      # [M, L] int32 its requester
    arb_rr: torch.Tensor        # [M, L] int32 rotating priority pointer
    want_read: torch.Tensor     # [M, L] bool home-side accesses (none
    want_write: torch.Tensor    # [M, L] bool   in a fleet)
    want_wval: torch.Tensor     # [M, L, B]
    msg_count: torch.Tensor     # [M, 16] int32 messages delivered by type
    payload_msgs: torch.Tensor  # [M] int32 of them carrying line data
    step_no: torch.Tensor       # [] int32


class Counters(NamedTuple):
    lat_hist: torch.Tensor     # [M, R, 10] int32
    max_wait: torch.Tensor     # [M, R] int32
    retired: torch.Tensor      # [M, R] int32
    occ_sum: torch.Tensor      # [M, 4] int64
    occ_peak: torch.Tensor     # [M, 4] int32
    mshr_sum: torch.Tensor     # [M] int64
    mshr_peak: torch.Tensor    # [M] int32
    steps: torch.Tensor        # [M] int32
    active_steps: torch.Tensor  # [M] int32


class FleetResult(NamedTuple):
    state: State
    counters: Counters
    retire: torch.Tensor       # [M, T, R] int32 step each op retired, -1
    completed: torch.Tensor    # [M] bool


def make_state(M: int, R: int, L: int, B: int, device) -> State:
    """M quiescent engines with empty caches over zeroed backing data."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def ch():
        return Channel(z((M, R, L), torch.int8), z((M, R, L), torch.bool),
                       z((M, R, L, B), torch.float32),
                       z((M, R, L), torch.int32))

    return State(
        dir=Dir(z((M, L), torch.int8), z((M, R, L), torch.int8),
                z((M, L, B), torch.float32), z((M, L, B), torch.float32),
                z((M,), torch.int32)),
        agents=Agents(z((M, R, L), torch.int8), z((M, R, L, B), torch.float32),
                      z((M, R, L), torch.int8), z((M, R, L), torch.int8),
                      z((M, R, L, B), torch.float32), z((M, R), torch.int32),
                      z((M, R), torch.int32), z((M, R), torch.int32)),
        ch_req=ch(), ch_resp=ch(), ch_hreq=ch(), ch_hresp=ch(),
        hreq_pending=z((M, R, L), torch.int8),
        txn_msg=z((M, L), torch.int8), txn_node=z((M, L), torch.int32),
        arb_rr=z((M, L), torch.int32), want_read=z((M, L), torch.bool),
        want_write=z((M, L), torch.bool),
        want_wval=z((M, L, B), torch.float32),
        msg_count=z((M, 16), torch.int32), payload_msgs=z((M,), torch.int32),
        step_no=z((), torch.int32))


# ---- plain forms of the step's reductions ------------------------------

def credit_rank(active: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Per initiator row: a candidate's VC occupancy plus the candidates
    before it on its VC (odd and even lines are the two VCs)."""
    odd = (torch.arange(active.shape[-1], device=active.device) & 1).bool()
    out = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for par in (odd, ~odd):
        c = (cand & par).to(torch.int32)
        occ = (active & par).sum(-1, keepdim=True, dtype=torch.int32)
        out = torch.where(par, occ + torch.cumsum(c, -1, dtype=torch.int32)
                          - c, out)
    return out


def arb_winner(ready: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
    """Per line, the ready participant of least ``(p - rr) mod P``; with
    none ready, participant 0."""
    n = ready.shape[-2]
    p = torch.arange(n, device=ready.device, dtype=torch.int32)
    prio = torch.remainder(p[:, None] - rr[..., None, :], n)
    score = torch.where(ready, prio, n)
    best = score.min(-2, keepdim=True).values
    first = torch.where(score == best, p[:, None], n).min(-2).values
    return first.to(torch.int32)


def count(msg_count, payload_msgs, mask, msg, has_payload):
    """Add each member's masked messages by type, and those carrying
    data, to its running totals."""
    M = msg_count.shape[0]
    m = mask.reshape(M, -1)
    code = msg.reshape(M, -1).long()
    ok = m & (code >= 0) & (code < 16)
    idx = torch.where(ok, code, 16) + 17 * torch.arange(
        M, device=msg.device)[:, None]
    hist = torch.zeros(M * 17, dtype=torch.int64, device=msg.device)
    hist.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    hist = hist.view(M, 17)[:, :16].to(torch.int32)
    pay = (m & has_payload.reshape(M, -1)).sum(-1, dtype=torch.int32)
    return msg_count + hist, payload_msgs + pay


def lat_hist(lat: torch.Tensor, retired: torch.Tensor) -> torch.Tensor:
    """[rows, 10] int32: retired lanes by latency bucket
    (``sum_e lat >= e``)."""
    bucket = sum((lat >= e).long() for e in LAT_EDGES)
    rows = lat.shape[0]
    idx = bucket + 10 * torch.arange(rows, device=lat.device)[:, None]
    out = torch.zeros(rows * 10, dtype=torch.int64, device=lat.device)
    out.scatter_add_(0, idx.reshape(-1), retired.reshape(-1).long())
    return out.view(rows, 10).to(torch.int32)


# ---- the engine step -----------------------------------------------------

def _take(arr: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """``arr[m, node[m, l], l]`` (and ``[..., l, :]`` for payloads)."""
    idx = node.long()[:, None, :]
    if arr.dim() == 4:
        idx = idx[..., None].expand(-1, -1, -1, arr.shape[-1])
    return torch.gather(arr, 1, idx).squeeze(1)


def _delay(L: int, cls: int, device) -> torch.Tensor:
    """[L] delay of each line's VC for a message class."""
    odd = (torch.arange(L, device=device) & 1).bool()
    return torch.where(odd, DELAYS[2 * cls + 1], DELAYS[2 * cls])


def _submit(ch: Channel, want, msg, dirty, payload, credits: int = 0
            ) -> Tuple[Channel, torch.Tensor]:
    """Enqueue where ``want`` and the slot is free (and, with
    ``credits``, the lane's VC has credit); returns the channel and the
    accepted lanes."""
    free = ch.msg == P.NOP
    cand = want & free
    if credits:
        cand = cand & (credit_rank(~free, cand) < credits)
    return _place(ch, cand, msg, dirty, payload), cand


def _place(ch: Channel, put, msg, dirty, payload) -> Channel:
    return Channel(torch.where(put, msg, ch.msg),
                   torch.where(put, dirty, ch.dirty),
                   torch.where(put[..., None], payload, ch.payload),
                   ch.age.masked_fill(put, 0))


def _deliver(ch: Channel, delay_l) -> Tuple[Channel, torch.Tensor]:
    ready = (ch.msg != P.NOP) & (ch.age >= delay_l)
    return ch._replace(msg=ch.msg.masked_fill(ready, P.NOP)), ready


def _absorb(T: P.Tables, d: Dir, active, kind, dirty, payload) -> Dir:
    to_i = active & ((kind == P.ABS_VOL_I) | (kind == P.ABS_REPLY_I))
    # a clean reply to a recall confirms S only while the home still
    # believes EM (a crossing eviction may have cleared the view).
    to_s = active & (kind == P.ABS_REPLY_S) & ((d.view == P.V_EM) | dirty)
    view = d.view.masked_fill(to_i, P.V_I).masked_fill(to_s, P.V_S)
    d_act = active & dirty
    any_dirty = d_act.any(1)
    src = torch.argmax(d_act.to(torch.int8), dim=1)   # first dirty remote
    d_kind = _take(kind, src).long()
    d_pay = _take(payload, src)
    hs = d.home_state.long()
    home = torch.where(any_dirty, T.absorb_new_home[d_kind, 1, hs],
                       d.home_state)
    backing = torch.where((T.absorb_to_backing[d_kind, 1, hs]
                           & any_dirty)[..., None], d_pay, d.backing)
    home_buf = torch.where((T.absorb_to_homebuf[d_kind, 1, hs]
                            & any_dirty)[..., None], d_pay, d.home_buf)
    # the last sharer leaving a hidden-O line leaves the home dirty (M).
    o_to_m = (active & (kind == P.ABS_VOL_I)).any(1) & \
        ~(view != P.V_I).any(1) & (home == P.H_O)
    return d._replace(home_state=home.masked_fill(o_to_m, P.H_M), view=view,
                      backing=backing, home_buf=home_buf)


def _needed(d: Dir, active, msg, node, control: str) -> torch.Tensor:
    """The downgrade each remote needs before the line's request can be
    granted: a shared read recalls an EM holder to S, an exclusive read
    or an upgrade invalidates every other holder."""
    R = d.view.shape[1]
    others = torch.arange(R, device=msg.device)[:, None] != node[:, None, :]
    shared = (active & (msg == P.REQ_READ_SHARED))[:, None, :]
    excl = (active & ((msg == P.REQ_READ_EXCL)
                      | (msg == P.REQ_UPGRADE)))[:, None, :]
    recall = shared & others & (d.view == P.V_EM)
    inval = excl & others & (d.view != P.V_I)
    if control == "no_invalidate":
        inval = torch.zeros_like(inval)
    out = inval.to(torch.int8) * P.HOME_DOWNGRADE_I
    return out.masked_fill(recall, P.HOME_DOWNGRADE_S)


def _grant(T: P.Tables, d: Dir, active, msg, node):
    m = msg.long().clamp(max=P.N_MSG - 1)
    hs = d.home_state.long()
    req_view = _take(d.view, node).to(torch.int32)
    legal = T.grant_legal[m, hs] & (req_view == T.request_view[m])
    race = active & (m == P.REQ_UPGRADE) & (req_view != P.V_S)
    do = active & legal
    val = torch.where((d.home_state != P.H_I)[..., None], d.home_buf,
                      d.backing)
    backing = torch.where((do & T.grant_wb[m, hs])[..., None], d.home_buf,
                          d.backing)
    R = d.view.shape[1]
    onehot = torch.arange(R, device=msg.device)[:, None] == node[:, None, :]
    view = torch.where(onehot & do[:, None, :], T.grant_view[m][:, None, :],
                       d.view)
    resp = T.grant_resp[m, hs].masked_fill(~do, P.NOP)
    resp = resp.masked_fill(race, P.RESP_NACK)
    bad = (active & ~legal & ~race).sum(-1, dtype=torch.int32)
    return d._replace(home_state=torch.where(do, T.grant_new_home[m, hs],
                                             d.home_state),
                      view=view, backing=backing,
                      illegal=d.illegal + bad), resp, val


def step(T: P.Tables, st: State, op: torch.Tensor, op_val: torch.Tensor,
         credits: int = CREDITS, control: str = ""
         ) -> Tuple[State, torch.Tensor]:
    """One step of every member; returns the new state and the ops the
    remotes accepted this step (``[M, R, L]``).  Every VC holds
    ``credits`` messages per initiator.  ``control`` names a
    guarantee to break (``"no_invalidate"``: stores leave the other
    sharers' copies valid) — the comparison's control, never a
    benchmark run."""
    M, R, L = st.agents.remote_state.shape
    dev = op.device
    rids = torch.arange(R, device=dev)
    # (every constant is made on the device: a host-to-device copy would
    # wait for the queued steps.)
    d_req, d_resp, d_hreq, d_hresp = (_delay(L, c, dev)
                                      for c in (REQ, RESP, HREQ, HRESP))
    zero_rl = torch.zeros((M, R, L), dtype=torch.bool, device=dev)
    zero_l = torch.zeros((M, L), dtype=torch.bool, device=dev)

    # 1. time advances on every channel
    ch_req, ch_resp, ch_hreq, ch_hresp = (
        c._replace(age=c.age + (c.msg != P.NOP))
        for c in (st.ch_req, st.ch_resp, st.ch_hreq, st.ch_hresp))

    # 2. downgrade replies arrive at the home
    hresp_in = ch_hresp
    ch_hresp, hr_arr = _deliver(ch_hresp, d_hresp)
    kind = torch.where(st.hreq_pending == P.HOME_DOWNGRADE_S,
                       P.ABS_REPLY_S, P.ABS_REPLY_I).to(torch.int8)
    d = _absorb(T, st.dir, hr_arr, kind, hresp_in.dirty, hresp_in.payload)
    pending = st.hreq_pending.masked_fill(hr_arr, P.NOP)
    mc, pm = count(st.msg_count, st.payload_msgs, hr_arr, hresp_in.msg,
                   hresp_in.dirty)

    # 3. voluntary downgrades arrive at the home
    ready_req = (ch_req.msg != P.NOP) & (ch_req.age >= d_req)
    is_vol = (ch_req.msg == P.VOL_DOWNGRADE_I) | \
        (ch_req.msg == P.VOL_DOWNGRADE_S)
    pop_vol = ready_req & is_vol
    d = _absorb(T, d, pop_vol, torch.full_like(ch_req.msg, P.ABS_VOL_I),
                ch_req.dirty, ch_req.payload)
    mc, pm = count(mc, pm, pop_vol, ch_req.msg, ch_req.dirty)

    # 4. each free line parks one ready request, by rotating priority
    #    (the home is participant R; it has no access in a fleet)
    req_ready = ready_req & ~is_vol
    line_free = (st.txn_msg == P.NOP) & ~(pending != P.NOP).any(1) & \
        ~(ch_resp.msg != P.NOP).any(1)
    home_ready = st.want_read | st.want_write
    winner = arb_winner(torch.cat([req_ready, home_ready[:, None, :]], 1),
                        st.arb_rr)
    accept = (req_ready.any(1) | home_ready) & line_free
    home_win = accept & (winner == R)
    arb_rr = torch.where(accept, (winner + 1) % (R + 1), st.arb_rr)
    win_msg = _take(ch_req.msg, winner.clamp(max=R - 1)).masked_fill(
        home_win, P.HOME_TXN)
    pop_req = (accept & ~home_win)[:, None, :] & \
        (rids[:, None] == winner[:, None, :])
    ch_req = ch_req._replace(msg=ch_req.msg.masked_fill(
        pop_vol | (pop_req & req_ready), P.NOP))
    txn_msg = torch.where(accept, win_msg, st.txn_msg)
    txn_node = torch.where(accept, winner, st.txn_node)
    mc, pm = count(mc, pm, accept & ~home_win, win_msg, zero_l)

    # 5. fan-out: one HOME_DOWNGRADE_* per conflicting sharer
    active = txn_msg != P.NOP
    node = txn_node.clamp(max=R - 1)
    # an upgrade whose requester lost its copy meanwhile is NACKed: it
    # fans out nothing.
    doomed = active & (txn_msg == P.REQ_UPGRADE) & \
        (_take(d.view, node) != P.V_S)
    needed = _needed(d, active & ~doomed & (txn_msg != P.HOME_TXN), txn_msg,
                     node, control)
    send = (needed != P.NOP) & (pending == P.NOP)
    ch_hreq, acc = _submit(ch_hreq, send, needed, zero_rl,
                           torch.zeros((), device=dev), credits)
    pending = torch.where(acc, needed, pending)

    # 6. grant parked requests whose fan-out has landed
    vol_left = ((ch_req.msg == P.VOL_DOWNGRADE_I)
                | (ch_req.msg == P.VOL_DOWNGRADE_S)).any(1)
    h_left = (ch_hreq.msg != P.NOP).any(1) | (ch_hresp.msg != P.NOP).any(1)
    complete = active & ~(needed != P.NOP).any(1) & \
        ~(pending != P.NOP).any(1) & ~vol_left & ~h_left
    d, resp, resp_pay = _grant(T, d, complete & (txn_msg != P.HOME_TXN),
                               txn_msg, node)
    txn_msg = txn_msg.masked_fill(complete, P.NOP)
    to_req = (rids[:, None] == txn_node[:, None, :]) & \
        (resp != P.NOP)[:, None, :]
    ch_resp, _ = _submit(ch_resp, to_req, resp[:, None, :], zero_rl,
                         resp_pay[:, None])
    carries = (resp == P.RESP_DATA) | (resp == P.RESP_DATA_DIRTY)
    mc, pm = count(mc, pm, resp != P.NOP, resp, carries)

    # 7. grants arrive at the remotes
    resp_in = ch_resp
    ch_resp, r_arr = _deliver(ch_resp, d_resp)
    a = st.agents
    req, rm = a.pending_req.long(), resp_in.msg.long()
    new_rs = T.resp_new_state[req, rm].to(torch.int32)
    legal = new_rs >= 0
    do = r_arr & legal
    nack = r_arr & (rm == P.RESP_NACK)
    # a NACK keeps the current state: a crossing invalidation may have
    # moved it below the state the request left from.
    new_rs = torch.where(nack, a.remote_state.to(torch.int32), new_rs)
    data = (rm == P.RESP_DATA) | (rm == P.RESP_DATA_DIRTY)
    cache = torch.where((do & data)[..., None], resp_in.payload, a.cache)
    store = do & (a.pending_op == P.STORE) & ~nack
    cache = torch.where(store[..., None], a.pending_val, cache)
    after = torch.where(store, P.R_M, new_rs)
    a = a._replace(
        remote_state=torch.where(do, after.to(torch.int8), a.remote_state),
        cache=cache, pending_req=a.pending_req.masked_fill(do, P.NOP),
        pending_op=a.pending_op.masked_fill(do & ~nack, P.NOP),
        illegal=a.illegal + (r_arr & ~legal).sum(-1, dtype=torch.int32))

    # 8. home downgrades arrive at the remotes, which reply
    hreq_in = ch_hreq
    ch_hreq, h_arr = _deliver(ch_hreq, d_hreq)
    hm, rs = hreq_in.msg.long(), a.remote_state.long()
    ok = h_arr & T.rem_legal[hm, rs]
    reply = T.rem_resp[hm, rs].masked_fill(~ok, P.NOP)
    reply_dirty = ok & T.rem_resp_dirty[hm, rs]
    reply_pay = a.cache
    a = a._replace(
        remote_state=torch.where(ok, T.rem_new_state[hm, rs],
                                 a.remote_state),
        illegal=a.illegal + (h_arr & ~T.rem_legal[hm, rs]).sum(
            -1, dtype=torch.int32))
    mc, pm = count(mc, pm, h_arr, hreq_in.msg, zero_rl)
    ch_hresp, _ = _submit(ch_hresp, reply != P.NOP, reply, reply_dirty,
                          reply_pay)

    # 9. remotes issue: parked retries first, then the fresh ops; lanes
    #    under a home downgrade issue nothing; an op that would send a
    #    request waits for its slot and credit.
    locked = (pending != P.NOP) | (ch_hreq.msg != P.NOP)
    parked = (a.pending_op != P.NOP) & (a.pending_req == P.NOP)
    eff = torch.where(parked, a.pending_op, op)
    eff = eff.masked_fill(locked | ~T.op_ok[eff.long()], P.NOP)
    rs = a.remote_state.long()
    emits = T.loc_request[eff.long(), rs] != P.NOP
    free = ch_req.msg == P.NOP
    cand = emits & free
    ok_credit = cand & (credit_rank(~free, cand) < credits)
    eff = eff.masked_fill(emits & ~ok_credit, P.NOP)
    val = torch.where(parked[..., None], a.pending_val, op_val)
    o = eff.long()
    taken = (o != P.NOP) & (a.pending_req == P.NOP)
    hit = T.loc_hit[o, rs]
    request = T.loc_request[o, rs]
    is_hit, is_miss = taken & hit, taken & ~hit
    is_load = taken & (o == P.LOAD)
    a2 = Agents(
        remote_state=torch.where(is_hit, T.loc_new_state[o, rs],
                                 a.remote_state),
        cache=torch.where((is_hit & (o == P.STORE))[..., None], val,
                          a.cache),
        pending_req=torch.where(is_miss, request, a.pending_req),
        pending_op=torch.where(is_miss, eff.to(torch.int8), a.pending_op),
        pending_val=torch.where(is_miss[..., None], val, a.pending_val),
        illegal=a.illegal,
        hits=a.hits + (is_load & hit).sum(-1, dtype=torch.int32),
        misses=a.misses + (is_load & ~hit).sum(-1, dtype=torch.int32))
    emit = request.masked_fill(~taken, P.NOP)
    ch_req = _place(ch_req, emit != P.NOP, emit,
                    T.loc_req_dirty[o, rs], a.cache)

    new = State(dir=d, agents=a2, ch_req=ch_req, ch_resp=ch_resp,
                ch_hreq=ch_hreq, ch_hresp=ch_hresp, hreq_pending=pending,
                txn_msg=txn_msg, txn_node=txn_node, arb_rr=arb_rr,
                want_read=st.want_read, want_write=st.want_write,
                want_wval=st.want_wval, msg_count=mc, payload_msgs=pm,
                step_no=st.step_no + 1)
    return new, taken & ~parked


def busy(st: State) -> torch.Tensor:
    """[M] bool: anything in flight in the member."""
    lanes = (st.agents.pending_req | st.agents.pending_op | st.ch_req.msg
             | st.ch_resp.msg | st.ch_hreq.msg | st.ch_hresp.msg
             | st.hreq_pending)
    return lanes.flatten(1).any(1) | (st.txn_msg != 0).any(1) | \
        st.want_read.any(1) | st.want_write.any(1)


# ---- the closed-loop driver ----------------------------------------------

def run_fleet(op: np.ndarray, line: np.ndarray, value: np.ndarray,
              widths: Sequence[int], lines: int, block: int, steps: int,
              device="cpu", credits: int = CREDITS,
              control: str = "") -> FleetResult:
    """Drive M members' ``[M, T, R]`` op streams (int8 ops, line ids,
    float32 store values) for ``steps`` steps; member ``m`` keeps a
    window of ``widths[m]`` head-of-stream ops per remote.

    Per remote and step, the window's un-issued slots go in order; a
    slot waits behind an earlier un-issued slot on its line and while
    its line has a transaction in flight (one MSHR per line); an op
    retires when its line's MSHR is clear again; the window slides past
    its issued prefix."""
    dev = torch.device(device)
    T_ = P.tables(dev)
    M, T, R = op.shape
    L, B = lines, block
    W = max(widths)
    op_t = torch.as_tensor(op, dtype=torch.int8, device=dev
                           ).transpose(1, 2).contiguous()       # [M, R, T]
    line_t = torch.as_tensor(line, dtype=torch.int64, device=dev
                             ).transpose(1, 2).contiguous()
    val_t = torch.as_tensor(value, dtype=torch.float32, device=dev
                            ).transpose(1, 2).contiguous()
    w_lim = torch.as_tensor(np.asarray(widths, np.int64), device=dev
                            )[:, None, None]
    wr = torch.arange(W, device=dev)
    earlier = wr[None, :] < wr[:, None]
    st = make_state(M, R, L, B, dev)
    cursor = torch.zeros((M, R), dtype=torch.int64, device=dev)
    issued = torch.zeros((M, R, W), dtype=torch.bool, device=dev)
    slot_born = torch.zeros((M, R, W), dtype=torch.int32, device=dev)
    outstanding = torch.zeros((M, R, L), dtype=torch.bool, device=dev)
    born = torch.zeros((M, R, L), dtype=torch.int32, device=dev)
    out_idx = torch.zeros((M, R, L), dtype=torch.int64, device=dev)
    retire = torch.full((M, R, T + 1), -1, dtype=torch.int32, device=dev)
    z = torch.zeros
    ctr = Counters(z((M, R, 10), dtype=torch.int32, device=dev),
                   z((M, R), dtype=torch.int32, device=dev),
                   z((M, R), dtype=torch.int32, device=dev),
                   z((M, 4), dtype=torch.int64, device=dev),
                   z((M, 4), dtype=torch.int32, device=dev),
                   z((M,), dtype=torch.int64, device=dev),
                   z((M,), dtype=torch.int32, device=dev),
                   z((M,), dtype=torch.int32, device=dev),
                   z((M,), dtype=torch.int32, device=dev))

    def plane(tgt, src, dtype):
        p = torch.zeros((M, R, L + 1), dtype=dtype, device=dev)
        return p.scatter_(-1, tgt, src.to(dtype))[..., :L]

    for t in range(steps):
        idx = cursor[..., None] + wr
        active = (idx < T) & (wr < w_lim)
        idxc = idx.clamp(max=T - 1)
        s_op, s_line, s_val = (x.gather(-1, idxc)
                               for x in (op_t, line_t, val_t))
        is_nop = s_op == P.NOP
        pend = active & ~issued
        real = pend & ~is_nop
        can = real & ~outstanding.gather(-1, s_line)
        if W > 1:
            same = s_line[..., :, None] == s_line[..., None, :]
            can = can & ~(real[..., None, :] & same & earlier).any(-1)
        tgt = torch.where(can, s_line, L)
        st2, newly = step(T_, st, plane(tgt, s_op, torch.int8),
                          plane(tgt, s_val, torch.float32)[..., None]
                          .expand(M, R, L, B), credits, control)
        outstanding = outstanding | newly
        born = torch.where(newly, plane(tgt, slot_born, torch.int32), born)
        clear = (st2.agents.pending_op == P.NOP) & \
            (st2.agents.pending_req == P.NOP)
        retired = outstanding & clear
        outstanding = outstanding & ~retired
        out_idx = torch.where(newly, plane(tgt, idxc, torch.int64), out_idx)
        retire.scatter_(-1, torch.where(retired, out_idx, T), t)

        taken = can & newly.gather(-1, s_line)
        issued = issued | taken | (pend & is_nop)
        shift = torch.cumprod(issued.to(torch.int32), -1).sum(-1)
        k2 = wr + shift[..., None]
        in_w = k2 < w_lim
        k2c = k2.clamp(max=W - 1)
        issued2 = issued.gather(-1, k2c) & in_w
        born2 = torch.where(in_w, slot_born.gather(-1, k2c), t + 1)

        lat = t - born
        waiting = active & ~issued
        head_wait = (t - slot_born).masked_fill(~waiting, 0).amax(-1)
        step_active = active.flatten(1).any(1) | busy(st2)
        hist = ctr.lat_hist + lat_hist(lat.reshape(-1, L), retired.reshape(
            -1, L)).view(M, R, 10)
        live = lat.masked_fill(~(retired | outstanding), 0).amax(-1)
        msgs = torch.stack([st2.ch_req.msg, st2.ch_resp.msg,
                            st2.ch_hreq.msg, st2.ch_hresp.msg], 1)
        occ = (msgs != P.NOP).flatten(2).sum(-1, dtype=torch.int32)
        mshr = outstanding.flatten(1).sum(-1, dtype=torch.int32)
        ctr = Counters(
            hist, torch.maximum(ctr.max_wait, torch.maximum(live, head_wait)),
            ctr.retired + retired.sum(-1, dtype=torch.int32),
            ctr.occ_sum + occ, torch.maximum(ctr.occ_peak, occ),
            ctr.mshr_sum + mshr, torch.maximum(ctr.mshr_peak, mshr),
            ctr.steps + 1, ctr.active_steps + step_active.to(torch.int32))
        st, cursor = st2, cursor + shift
        issued, slot_born = issued2, born2

    completed = (cursor >= T).all(-1) & ~outstanding.flatten(1).any(1) & \
        ~busy(st)
    return FleetResult(st, ctr, retire[..., :-1].transpose(1, 2), completed)
