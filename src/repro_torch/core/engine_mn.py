"""The vectorized N-remote coherency engine (paper §4.1, R <= 64), on tensors.

The port of ``repro.core.engine_mn``: ``R`` caching remotes, each a
4-state agent (``core.agent``) over one ``[R, L]`` slab, a sharer-vector
home (``core.directory_mn``) and four ``[R, L]`` virtual-channel planes
(``core.transport``).  ``step_mn`` is one step over all remotes and
lines, phase for phase the reference's, and bit-identical to it on the
same inputs (``tests/test_torch_engine.py``, ``tests/test_torch_packed.py``).

Transaction discipline: the home parks ONE request per line, chosen among
the ready remote requests and the home's own pending access (participant
R, parked as ``HOME_TXN``) by a per-line rotating priority pointer
(``arb_rr``); it fans out one ``HOME_DOWNGRADE_*`` per conflicting sharer
and grants once every reply has arrived and no voluntary downgrade is in
flight on the line.

Options, as in the reference:

* ``n_homes = H > 1`` — line ownership interleaves across H homes by
  address (``line % H``); the step folds the flat ``[R, L]`` state into
  the home-major ``[H, R, L/H]`` layout at entry and unfolds at exit, so
  each home has its own arbitration, transaction and MSHR plane and its
  own credit pools.  ``home_bw > 0`` caps the new transactions each home
  parks per step;
* ``hreq_shared`` — the home's fan-out submits rank against one shared
  credit pool across all R rows;
* bit-packed planes — the directory view and the pending home-downgrade
  mask are ``[2, L, W]`` int32 words (``W = ceil(R/32)``) instead of
  ``[R, L]`` int8; the state's dtype tells the layouts apart (int8 dense,
  int32 packed).

Of the step's inner planes, six run as CUDA kernels on the card (their
plain versions on the CPU): the credit ranks of the credited submits
(``credit_rank``), the arbitration winner (``arb_winner``), the five
message-counter folds (``count_fold``) and, on packed planes, the five
any-bit reductions (``packed_any``) and the fan-out words
(``packed_fanout``).

``EngineMN.run_ops`` submits an op plane and drains to quiescence in the
two-node engine's host loop (``core.engine.run_ops``), as
``CoherentStore`` does with several remotes.

``emit_events=True`` also returns the step's wire events
(``StepEvents``), the feed of the observability plane
(``traffic.observe``).

Fleets (``traffic.fleet``): ``step_folded`` takes a state whose leading
axis is a MEMBER axis — one independent engine per member, each with
its own ``msg_count [M, 16]`` and ``payload_msgs [M]`` (the counter
fold is then grouped by member) — and the home emulation
``home_group``/``home_bw_t``: H address-interleaved homes emulated over
the flat layout, VC parity from the plane-local line index and each
home's new-transaction acceptance capped in the folded plane's rotating
order, bit-identical to the ``[H, R, L/H]`` fold while VC credits never
bind.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import coherency_step as K
from ..spans import span
from . import agent as ag
from . import directory_mn as dmn
from . import transport as tp
from .engine import _count, run_ops
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


class EngineMNState(NamedTuple):
    dir: dmn.DirectoryMNState
    agents: ag.AgentState        # every field has a leading [R] axis
    ch_req: tp.Channel           # [R, L] remote -> home requests + evictions
    ch_resp: tp.Channel          # [R, L] home -> remote grant responses
    ch_hreq: tp.Channel          # [R, L] home -> remote downgrades (fan-out)
    ch_hresp: tp.Channel         # [R, L] remote -> home downgrade replies
    hreq_pending: torch.Tensor   # [R, L] int8: outstanding HOME_DOWNGRADE_*
    #                              (packed: [2, L, W] int32 words — plane 0
    #                              = HD_S pending, plane 1 = HD_I pending)
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


# ---------------------------------------------------------------------------
# Multi-home fold: the [R, L] <-> [H, R, L/H] layout change.
#
# Global line ``l = q*H + h`` lands at ``[h, ..., q]``: a reshape of the
# line axis and a move of the home axis to the front.  Every transport,
# agent and directory function is polymorphic over leading batch axes, so
# the same step body runs the folded layout.  The folded tensors are made
# contiguous: the kernel wrappers take contiguous tensors only.
# ---------------------------------------------------------------------------


def _f_l(x: torch.Tensor, H: int) -> torch.Tensor:
    """[L, ...] -> [H, L/H, ...]."""
    return x.reshape((x.shape[0] // H, H) + tuple(x.shape[1:])) \
        .movedim(1, 0).contiguous()


def _u_l(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_f_l``: [H, L/H, ...] -> [L, ...]."""
    return x.movedim(0, 1).reshape(
        (x.shape[0] * x.shape[1],) + tuple(x.shape[2:])).contiguous()


def _f_rl(x: torch.Tensor, H: int) -> torch.Tensor:
    """[R, L, ...] -> [H, R, L/H, ...]; a packed ``[2, L, W]`` word
    array folds the same way, to ``[H, 2, L/H, W]``."""
    r, l = x.shape[:2]
    return x.reshape((r, l // H, H) + tuple(x.shape[2:])) \
        .movedim(2, 0).contiguous()


def _u_rl(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_f_rl``: [H, R, L/H, ...] -> [R, L, ...]."""
    return x.movedim(0, 2).reshape(
        (x.shape[1], x.shape[2] * x.shape[0]) + tuple(x.shape[3:])
    ).contiguous()


def _fold_state_mn(st: EngineMNState, H: int) -> EngineMNState:
    """Flat [R, L] state -> home-major [H, R, L/H] layout.

    The agents' per-remote tallies (``illegal``/``hits``/``misses``, [R])
    have no line axis: the folded state carries [H, R] zeros and
    ``_unfold_state_mn`` adds the per-home deltas onto the flat totals."""
    chf = lambda ch: tp.Channel(*(_f_rl(a, H) for a in ch))  # noqa: E731
    zr = st.agents.illegal.new_zeros((H,) + tuple(st.agents.illegal.shape))
    return EngineMNState(
        dir=st.dir._replace(
            home_state=_f_l(st.dir.home_state, H),
            view=_f_rl(st.dir.view, H),
            backing=_f_l(st.dir.backing, H),
            home_buf=_f_l(st.dir.home_buf, H)),
        agents=st.agents._replace(
            remote_state=_f_rl(st.agents.remote_state, H),
            cache=_f_rl(st.agents.cache, H),
            pending_req=_f_rl(st.agents.pending_req, H),
            pending_op=_f_rl(st.agents.pending_op, H),
            pending_val=_f_rl(st.agents.pending_val, H),
            illegal=zr, hits=zr, misses=zr),
        ch_req=chf(st.ch_req), ch_resp=chf(st.ch_resp),
        ch_hreq=chf(st.ch_hreq), ch_hresp=chf(st.ch_hresp),
        hreq_pending=_f_rl(st.hreq_pending, H),
        txn_msg=_f_l(st.txn_msg, H),
        txn_node=_f_l(st.txn_node, H),
        arb_rr=_f_l(st.arb_rr, H),
        want_read=_f_l(st.want_read, H),
        want_write=_f_l(st.want_write, H),
        want_wval=_f_l(st.want_wval, H),
        msg_count=st.msg_count, payload_msgs=st.payload_msgs,
        step_no=st.step_no)


def _unfold_state_mn(st: EngineMNState, flat: EngineMNState
                     ) -> EngineMNState:
    """Home-major [H, R, L/H] state -> flat [R, L]; ``flat`` supplies the
    pre-fold per-remote tallies the folded zeros started from."""
    chu = lambda ch: tp.Channel(*(_u_rl(a) for a in ch))  # noqa: E731
    ag_in = flat.agents
    return EngineMNState(
        dir=st.dir._replace(
            home_state=_u_l(st.dir.home_state),
            view=_u_rl(st.dir.view),
            backing=_u_l(st.dir.backing),
            home_buf=_u_l(st.dir.home_buf)),
        agents=st.agents._replace(
            remote_state=_u_rl(st.agents.remote_state),
            cache=_u_rl(st.agents.cache),
            pending_req=_u_rl(st.agents.pending_req),
            pending_op=_u_rl(st.agents.pending_op),
            pending_val=_u_rl(st.agents.pending_val),
            illegal=ag_in.illegal + st.agents.illegal.sum(
                0, dtype=torch.int32),
            hits=ag_in.hits + st.agents.hits.sum(0, dtype=torch.int32),
            misses=ag_in.misses + st.agents.misses.sum(
                0, dtype=torch.int32)),
        ch_req=chu(st.ch_req), ch_resp=chu(st.ch_resp),
        ch_hreq=chu(st.ch_hreq), ch_hresp=chu(st.ch_hresp),
        hreq_pending=_u_rl(st.hreq_pending),
        txn_msg=_u_l(st.txn_msg),
        txn_node=_u_l(st.txn_node),
        arb_rr=_u_l(st.arb_rr),
        want_read=_u_l(st.want_read),
        want_write=_u_l(st.want_write),
        want_wval=_u_l(st.want_wval),
        msg_count=st.msg_count, payload_msgs=st.payload_msgs,
        step_no=st.step_no)


class StepEvents(NamedTuple):
    """Wire events of ONE engine step, in delivery order: the feed of the
    observability plane (``traffic.observe``).

    The five sites are the step's ``_count`` sites in phase order
    (hresp arrivals, voluntary downgrades, request acceptance, grant
    issue, home-downgrade delivery).  Per-remote sites are ``[R, L]``;
    the home-side sites (one transaction per line) are ``[L]``.
    ``step_mn`` returns them on flat global lines; ``step_folded``
    returns them in its state's layout (``unfold_events`` flattens)."""

    hresp_arr: torch.Tensor    # [R, L] bool — downgrade replies at home
    hresp_msg: torch.Tensor    # [R, L] int8
    hresp_dirty: torch.Tensor  # [R, L] bool
    vol_arr: torch.Tensor      # [R, L] bool — voluntary downgrades absorbed
    vol_msg: torch.Tensor      # [R, L] int8
    vol_dirty: torch.Tensor    # [R, L] bool
    req_acc: torch.Tensor      # [L] bool — remote request parked (wins arb)
    req_msg: torch.Tensor      # [L] int8
    req_node: torch.Tensor     # [L] int32
    grant: torch.Tensor        # [L] bool — grant response issued
    grant_msg: torch.Tensor    # [L] int8
    grant_node: torch.Tensor   # [L] int32
    grant_pay: torch.Tensor    # [L] bool — the grant carries line data
    hd_arr: torch.Tensor       # [R, L] bool — HOME_DOWNGRADE_* delivered
    hd_msg: torch.Tensor       # [R, L] int8


#: the ``[L]`` (home-side) fields of ``StepEvents``; the rest are [R, L].
_EVENT_LINE_FIELDS = frozenset({"req_acc", "req_msg", "req_node", "grant",
                                "grant_msg", "grant_node", "grant_pay"})


def unfold_events(ev: StepEvents) -> StepEvents:
    """Events of a home-major fold (``[H, R, L/H]``, ``[H, L/H]``) on
    flat global lines."""
    return StepEvents(**{
        f: (_u_l(x) if f in _EVENT_LINE_FIELDS else _u_rl(x))
        for f, x in ev._asdict().items()})


def make_engine_mn_state(backing: torch.Tensor, n_remotes: int,
                         packed: bool = False) -> EngineMNState:
    """A quiescent engine over ``backing`` ([L, B], on its device);
    ``packed`` keeps the directory view and the pending home-downgrade
    mask as ``[2, L, W]`` int32 word planes."""
    L, B = backing.shape
    R = n_remotes
    dev = backing.device

    def mk():
        return tp.make_channel(L, B, backing.dtype, dev, lead=(R,))

    hreq = (torch.zeros((2, L, dmn.n_words(R)), dtype=torch.int32,
                        device=dev) if packed else
            torch.zeros((R, L), dtype=torch.int8, device=dev))
    return EngineMNState(
        dir=dmn.make_directory_mn(backing, R, packed=packed),
        agents=ag.make_agent(L, B, backing.dtype, dev, lead=(R,)),
        ch_req=mk(), ch_resp=mk(), ch_hreq=mk(), ch_hresp=mk(),
        hreq_pending=hreq,
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
    """Per-(lead, R, L, device) constants of the step, built once; never
    written.  ``lead`` is ``()`` for one home and ``(H,)`` under the fold,
    where R and L are the folded plane's (L/H lines per home)."""

    rids: torch.Tensor      # [R] int64
    lines: torch.Tensor     # [L] int64
    vc4: torch.Tensor       # [4, L] int64 VC of each line, per message class
    zero_rl: torch.Tensor   # [*lead, R, L] bool
    zero_l: torch.Tensor    # [*lead, L] bool
    vol_kind: torch.Tensor  # [*lead, R, L] int8, MnAbsorb.VOL_I everywhere
    reply_s: torch.Tensor   # [] int8 MnAbsorb.REPLY_S
    reply_i: torch.Tensor   # [] int8 MnAbsorb.REPLY_I
    zero_f: torch.Tensor    # [] float32


@functools.lru_cache(maxsize=None)
def _consts(lead: Tuple[int, ...], R: int, L: int, device: str) -> _Consts:
    def i8(v):
        return torch.tensor(int(v), dtype=torch.int8, device=device)

    # VC parity follows the step's OWN line axis: the parity of the
    # plane-local line ``l // H`` under the fold, as in the reference.
    classes = (tp.CLASS_REMOTE_REQ, tp.CLASS_HOME_RESP, tp.CLASS_HOME_REQ,
               tp.CLASS_REMOTE_RESP)
    return _Consts(
        rids=torch.arange(R, device=device),
        lines=torch.arange(L, device=device),
        vc4=torch.stack([tp.vc_index(L, k, device) for k in classes]),
        zero_rl=torch.zeros(lead + (R, L), dtype=torch.bool, device=device),
        zero_l=torch.zeros(lead + (L,), dtype=torch.bool, device=device),
        vol_kind=torch.full(lead + (R, L), int(MnAbsorb.VOL_I),
                            dtype=torch.int8, device=device),
        reply_s=i8(MnAbsorb.REPLY_S), reply_i=i8(MnAbsorb.REPLY_I),
        zero_f=torch.zeros((), dtype=torch.float32, device=device))


class _Emul(NamedTuple):
    """Constants of the home emulation over ``lead`` (``()`` or ``(M,)``)
    flat ``[L]`` line planes, built once per (home plan, device).

    Sequence position ``k`` lists each home's lines in plane order, home
    by home: home ``h_k = k // Lh``, plane position ``r_k = k % Lh``; the
    line at ``k`` in the plane's order rotated by ``off`` is ``((r_k +
    off) % Lh) * hg + h_k``, and line ``l`` (home ``l % hg``, plane
    position ``l // hg``) sits at ``k = (l % hg) * Lh + (l // hg - off) %
    Lh``."""

    vc4: Optional[torch.Tensor]  # [4, *lead, 1, L] (lead ()): [4, L]) VC
    #                              of each line; None when every hg is 1
    cap: Optional[torch.Tensor]  # [*lead, 1] int32 acceptance cap (L + 1
    #                              = none); None when no member caps
    hg: torch.Tensor             # [*lead, 1] int64 homes
    lh: torch.Tensor             # [*lead, 1] int64 lines per home
    h_k: torch.Tensor            # [*lead, L] int64
    r_k: torch.Tensor            # [*lead, L] int64
    seg: torch.Tensor            # [*lead, L] int64: first k of h_k's run
    h_l: torch.Tensor            # [*lead, L] int64: l % hg
    q_l: torch.Tensor            # [*lead, L] int64: l // hg


@functools.lru_cache(maxsize=None)
def _emul(home_group: Tuple[int, ...], home_bw_t: Tuple[int, ...],
          members: bool, L: int, device: str) -> _Emul:
    for hg in home_group:
        if hg < 1 or L % hg:
            raise ValueError(f"home_group={hg} must be >= 1 and divide "
                             f"the {L} lines")
    lead = (len(home_group),) if members else ()

    def col(vals):
        return torch.tensor(vals, dtype=torch.int64,
                            device=device).reshape(lead + (1,))

    hg = col(home_group)
    lh = L // hg
    ar = torch.arange(L, device=device).expand(lead + (L,))
    h_k, r_k = ar // lh, ar % lh
    vc4 = None
    if any(h != 1 for h in home_group):
        par = (ar // hg) & 1
        if members:
            par = par[:, None, :]                    # [M, 1, L]
        classes = (tp.CLASS_REMOTE_REQ, tp.CLASS_HOME_RESP,
                   tp.CLASS_HOME_REQ, tp.CLASS_REMOTE_RESP)
        vc4 = torch.stack([2 * k + par for k in classes])
    cap = None
    if any(home_bw_t):
        cap = col([b if b > 0 else L + 1 for b in home_bw_t]).to(torch.int32)
    return _Emul(vc4=vc4, cap=cap, hg=hg, lh=lh, h_k=h_k, r_k=r_k,
                 seg=h_k * lh, h_l=ar % hg, q_l=ar // hg)


def _emul_rank(e: _Emul, accept_line: torch.Tensor,
               step_no: torch.Tensor) -> torch.Tensor:
    """[*lead, L] int32: each accepted line's rank among its home's
    accepted lines in the plane's order rotated by ``step_no % Lh`` — the
    reference's ``[L, L]`` comparison count, as an exclusive cumsum over
    the lines sorted by (home, rotated position)."""
    off = step_no % e.lh
    seq = ((e.r_k + off) % e.lh) * e.hg + e.h_k
    rolled = accept_line.gather(-1, seq).to(torch.int32)
    excl = torch.cumsum(rolled, -1, dtype=torch.int32) - rolled
    rank_k = excl - excl.gather(-1, e.seg)
    return rank_k.gather(-1, e.h_l * e.lh + (e.q_l - off) % e.lh)


def _ready(ch: tp.Channel, delay_l: torch.Tensor) -> torch.Tensor:
    """[R, L] mask of in-flight messages whose VC delay has elapsed."""
    return (ch.msg != _NOP) & (ch.age >= delay_l)


def _pop(ch: tp.Channel, mask: torch.Tensor) -> tp.Channel:
    """Free the slots in ``mask``."""
    return ch._replace(msg=ch.msg.masked_fill(mask, _NOP))


def _pend_or(hp: torch.Tensor) -> torch.Tensor:
    """OR of the two packed pending word planes ([..., 2, L, W] ->
    [..., L, W]): "any HOME_DOWNGRADE_* outstanding" per (remote bit,
    line)."""
    return hp[..., 0, :, :] | hp[..., 1, :, :]


def step_mn(tables: TorchTables, st: EngineMNState, op: torch.Tensor,
            op_val: torch.Tensor, want_read: torch.Tensor,
            want_write: torch.Tensor, wval: torch.Tensor,
            delays: torch.Tensor, credits: torch.Tensor,
            hreq_shared: bool = False, n_homes: int = 1, home_bw: int = 0,
            emit_events: bool = False, home_group=None, home_bw_t=None
            ) -> tuple:
    """One engine step over all remotes and lines (see the module doc).

    ``tables`` come from ``protocol.device_tables`` on the state's
    device; ``op`` is the ``[R, L]`` int8 LocalOp plane, ``op_val`` its
    ``[R, L, B]`` store values, ``want_read``/``want_write``/``wval`` the
    home-side accesses.  ``hreq_shared`` ranks the fan-out submits
    against one shared credit pool; ``n_homes``/``home_bw`` run H
    address-interleaved homes, each parking at most ``home_bw`` new
    transactions per step (0 = unbounded): the flat state is folded
    into the home-major layout, stepped by ``step_folded`` and unfolded
    again.  The state's layout (dense int8 or packed int32 planes) is
    read from ``hreq_pending``'s dtype.  ``emit_events`` returns
    ``(state, output, StepEvents)`` on flat lines.  The step makes no
    host synchronisation.

    ``home_group``/``home_bw_t`` (ints; fleet use, with the defaults of
    ``n_homes`` and ``home_bw``) emulate ``home_group`` homes of
    ``home_bw_t`` new transactions a step each (0 = no cap) over the flat
    layout (see the module doc); ``home_group = 1`` with ``home_bw_t =
    0`` is the default step, bit for bit."""
    if home_group is not None or home_bw_t is not None:
        assert n_homes == 1 and not home_bw, \
            "home_group emulation composes with the FLAT layout only " \
            "(n_homes/home_bw must stay at their defaults)"
    if n_homes == 1:
        return step_folded(tables, st, op, op_val, want_read, want_write,
                           wval, delays, credits, hreq_shared=hreq_shared,
                           home_bw=home_bw, emit_events=emit_events,
                           home_group=home_group, home_bw_t=home_bw_t)
    H = n_homes
    res = step_folded(
        tables, _fold_state_mn(st, H), _f_rl(op, H), _f_rl(op_val, H),
        _f_l(want_read, H), _f_l(want_write, H), _f_l(wval, H), delays,
        credits, hreq_shared=hreq_shared, home_bw=home_bw,
        emit_events=emit_events)
    new, out = res[:2]
    flat = (_unfold_state_mn(new, st), StepMNOutput(
        load_done=_u_rl(out.load_done), load_val=_u_rl(out.load_val),
        hread_done=_u_l(out.hread_done), hread_val=_u_l(out.hread_val),
        accepted=_u_rl(out.accepted)))
    return flat + (unfold_events(res[2]),) if emit_events else flat


def step_folded(tables: TorchTables, st: EngineMNState, op: torch.Tensor,
                op_val: torch.Tensor, want_read: torch.Tensor,
                want_write: torch.Tensor, wval: torch.Tensor,
                delays: torch.Tensor, credits: torch.Tensor,
                hreq_shared: bool = False, home_bw: int = 0,
                emit_events: bool = False, home_group=None,
                home_bw_t=None) -> tuple:
    """The step body over a home-major state: the flat ``[R, L]`` layout
    of one home, or the ``[H, R, L/H]`` fold of H homes (``_fold_state_mn``;
    the inputs folded alike), whose leading axis batches every phase.
    The outputs (and, with ``emit_events``, the ``StepEvents`` appended
    to them) keep the state's layout.  ``run_stream`` keeps a multi-home
    state folded across its whole loop and calls this.

    A fleet state (``msg_count [M, 16]``) leads with its member axis
    instead, and ``home_group``/``home_bw_t`` are then tuples of M ints,
    one per member (see ``step_mn`` for the emulation; ``None`` for
    both is every member's ``home_group = 1``, ``home_bw_t = 0``)."""
    # R/L come from the (always dense) agent plane: the directory and
    # MSHR slabs change layout under the packed planes.
    R, L = ag.plane_shape(st.agents)
    packed = st.hreq_pending.dtype == torch.int32
    lead = tuple(st.txn_msg.shape[:-1])
    dev = str(st.txn_msg.device)
    c = _consts(lead, R, L, dev)
    emul = None
    if home_group is not None or home_bw_t is not None:
        assert not home_bw, "home_group emulation replaces home_bw"
        members = st.msg_count.dim() == 2
        n = lead[0] if members else 1

        def per(v, default):
            if v is None:
                return (default,) * n
            return tuple(int(x) for x in v) if members else (int(v),)

        emul = _emul(per(home_group, 1), per(home_bw_t, 0), members, L,
                     dev)
    rids = c.rids
    msg_count, payload_msgs = st.msg_count, st.payload_msgs
    # one gather of the per-line delays of the four classes.  VC parity
    # follows the plane-local line index under the home emulation.
    vc4 = c.vc4 if emul is None or emul.vc4 is None else emul.vc4
    dly_req, dly_resp, dly_hreq, dly_hresp = delays[vc4]

    with span("engine.deliver"):
        # accumulate new home-side wants.
        want_read = st.want_read | want_read
        want_write = st.want_write | want_write
        wv = torch.where((want_write & ~st.want_write)[..., None], wval,
                         st.want_wval)

        # ---- 1. time advances on all channels ----------------------------
        ch_req, ch_resp = tp.tick(st.ch_req), tp.tick(st.ch_resp)
        ch_hreq, ch_hresp = tp.tick(st.ch_hreq), tp.tick(st.ch_hresp)

        # ---- 2. downgrade replies arrive at the home ---------------------
        ch_hresp_in = ch_hresp
        ch_hresp, hr_arr = tp.deliver(ch_hresp, tp.CLASS_REMOTE_RESP, delays,
                                      delay_l=dly_hresp)
        if packed:
            # plane 0 of the packed MSHR mask is "HOME_DOWNGRADE_S pending";
            # a reply arrives only for a sent (= pending) downgrade, so the
            # bit IS the reply's kind wherever absorb reads it.
            rep_kind = torch.where(
                dmn.unpack_mask(st.hreq_pending[..., 0, :, :], R), c.reply_s,
                c.reply_i)
        else:
            rep_kind = torch.where(
                st.hreq_pending == int(MsgType.HOME_DOWNGRADE_S), c.reply_s,
                c.reply_i)
        dstate = dmn.absorb(tables, st.dir, hr_arr, rep_kind,
                            ch_hresp_in.dirty, ch_hresp_in.payload)
        if packed:
            hreq_pending = st.hreq_pending & \
                ~dmn.pack_mask(hr_arr)[..., None, :, :]
        else:
            hreq_pending = st.hreq_pending.masked_fill(hr_arr, _NOP)
        msg_count, payload_msgs = _count(msg_count, payload_msgs, hr_arr,
                                         ch_hresp_in.msg, ch_hresp_in.dirty)

        # ---- 3. voluntary downgrades arrive at the home ------------------
        ready_req = _ready(ch_req, dly_req)
        is_vol = (ch_req.msg == _VOL_I) | (ch_req.msg == _VOL_S)
        pop_vol = ready_req & is_vol
        dstate = dmn.absorb(tables, dstate, pop_vol, c.vol_kind, ch_req.dirty,
                            ch_req.payload)
        msg_count, payload_msgs = _count(msg_count, payload_msgs, pop_vol,
                                         ch_req.msg, ch_req.dirty)
        # observability site 2: voluntary downgrades as absorbed (pre-pop).
        vol_msg, vol_dirty = ch_req.msg, ch_req.dirty

    with span("engine.arbitrate"):
        # ---- 4. arbitration: remotes AND the home compete per free line --
        req_ready = ready_req & ~is_vol
        # a line is free for a new transaction only when no downgrade round
        # trip is outstanding AND no grant response is still in flight.
        resp_in_flight = tp.any_in_flight(ch_resp)
        if packed:
            # the pending words before phase 5's update: phases 4 and 5 read
            # them, so they are ORed once.
            pend_w = _pend_or(hreq_pending)
            pend_any = dmn.any_bits(pend_w)
        else:
            pend_any = (hreq_pending != _NOP).any(dim=-2)
        line_free = (st.txn_msg == _NOP) & ~pend_any & ~resp_in_flight
        home_ready = want_read | want_write
        any_req = req_ready.any(dim=-2) | home_ready
        # rotating priority: participant p ranks (p - arb_rr) mod (R+1); the
        # pointer advances past each winner, a bounded wait for every
        # participant (the home is participant R).
        ready_all = torch.cat([req_ready, home_ready[..., None, :]], dim=-2)
        winner = K.arb_winner(ready_all, st.arb_rr)
        accept_line = any_req & line_free
        if emul is not None and emul.cap is not None:
            # the emulated homes' acceptance cap: each home keeps its first
            # ``home_bw_t`` accepted lines in the folded plane's rotating
            # order (``_emul_rank``).
            accept_line = accept_line & \
                (_emul_rank(emul, accept_line, st.step_no) < emul.cap)
        elif home_bw:
            # each home parks at most ``home_bw`` NEW transactions per step
            # (in-flight ones proceed); the priority order's origin line
            # rotates every step, so a saturated low range cannot starve the
            # tail.  Rank = accepted lines before this one in rotated order.
            off = st.step_no % L
            rolled = accept_line.index_select(-1, (c.lines + off) % L) \
                .to(torch.int32)
            rank = (torch.cumsum(rolled, -1, dtype=torch.int32) - rolled) \
                .index_select(-1, (c.lines - off) % L)
            accept_line = accept_line & (rank < home_bw)
        home_win = accept_line & (winner == R)
        arb_rr = torch.where(accept_line, (winner + 1) % (R + 1), st.arb_rr)
        win_node = torch.clamp(winner, max=R - 1)
        win_msg = dmn._take_remote(ch_req.msg, win_node).masked_fill(home_win,
                                                                      HOME_TXN)
        pop_req = (accept_line & ~home_win)[..., None, :] & \
            (rids[:, None] == winner[..., None, :])
        ch_req = _pop(ch_req, pop_vol | (pop_req & req_ready))
        txn_msg = torch.where(accept_line, win_msg, st.txn_msg)
        txn_node = torch.where(accept_line, winner, st.txn_node)
        msg_count, payload_msgs = _count(msg_count, payload_msgs,
                                         accept_line & ~home_win, win_msg,
                                         c.zero_l)

    with span("engine.fanout"):
        # ---- 5. fan-out: emit one HOME_DOWNGRADE_* per conflicting sharer
        active_txn = txn_msg != _NOP
        is_home_txn = txn_msg == HOME_TXN
        node_c = torch.clamp(txn_node, max=R - 1)
        # an UPGRADE whose requester was concurrently invalidated is doomed to
        # a NACK — suppress its fan-out so the new owner keeps the line.
        req_view_now = dmn.view_of(dstate, node_c)
        doomed = active_txn & (txn_msg == int(MsgType.REQ_UPGRADE)) & \
            (req_view_now != int(RemoteView.S))
        if packed:
            # recall (HD_S) / invalidate (HD_I) targets as word planes, then
            # widened to the dense [R, L] lane mask the transport submit
            # takes.  One launch gives the remote requests' planes and, on a
            # parked HOME transaction's lines (left out of the active mask),
            # the home side's.  The planes are disjoint per line, so the
            # HD_S-first combine matches the dense expression.
            need_s_w, need_i_w = dmn.needed_words(
                dstate, active_txn & ~doomed & ~is_home_txn, txn_msg, node_c,
                home_read=want_read & is_home_txn,
                home_write=want_write & is_home_txn)
            needed = (dmn.unpack_mask(need_i_w, R).to(torch.int8)
                      * int(MsgType.HOME_DOWNGRADE_I)).masked_fill(
                dmn.unpack_mask(need_s_w, R), int(MsgType.HOME_DOWNGRADE_S))
            send_h = (needed != _NOP) & ~dmn.unpack_mask(pend_w, R)
        else:
            needed_r = dmn.needed_downgrades(
                dstate, active_txn & ~doomed & ~is_home_txn, txn_msg, node_c,
                rids)
            # a parked HOME transaction fans out through the SAME machinery.
            needed_h = dmn.home_needed_downgrades(
                dstate, want_read & is_home_txn, want_write & is_home_txn)
            needed = torch.where(is_home_txn[..., None, :], needed_h, needed_r)
            send_h = (needed != _NOP) & (hreq_pending == _NOP)
        # home downgrades carry no data: a zero payload, broadcast (a 0-dim
        # tensor takes the channel's dtype under type promotion).
        ch_hreq, acc_h = tp.submit(ch_hreq, tp.CLASS_HOME_REQ, send_h, needed,
                                   c.zero_rl, c.zero_f, credits,
                                   shared=hreq_shared)
        if packed:
            # acc_h lies inside send_h, so on pending-free lanes, and each
            # accepted lane sits in exactly one plane: OR-in is the store.
            acc_w = dmn.pack_mask(acc_h)
            hreq_pending = torch.stack(
                [hreq_pending[..., 0, :, :] | (acc_w & need_s_w),
                 hreq_pending[..., 1, :, :] | (acc_w & need_i_w)], dim=-3)
        else:
            hreq_pending = torch.where(acc_h, needed, hreq_pending)

    with span("engine.grant"):
        # ---- 6. grant parked requests whose preconditions now hold -------
        in_flight_vol = ((ch_req.msg == _VOL_I) | (ch_req.msg == _VOL_S)
                         ).any(dim=-2)
        in_flight_h = tp.any_in_flight(ch_hreq) | tp.any_in_flight(ch_hresp)
        # `needed` must be EMPTY, not merely pending-free: a fan-out refused
        # for credit leaves the sharer's view intact.
        if packed:
            # one launch over the fan-out planes and the updated pending
            # planes, read where they lie: any(x) | any(y) == any(x | y).
            complete = active_txn & ~dmn.any_bits(
                need_s_w, need_i_w, hreq_pending[..., 0, :, :],
                hreq_pending[..., 1, :, :]) & ~in_flight_vol & ~in_flight_h
        else:
            complete = active_txn & ~(needed != _NOP).any(dim=-2) & \
                ~(hreq_pending != _NOP).any(dim=-2) & ~in_flight_vol & \
                ~in_flight_h
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
        send_resp = (rids[:, None] == txn_node[..., None, :]) & \
            (resp != _NOP)[..., None, :]
        ch_resp, _ = tp.submit(ch_resp, tp.CLASS_HOME_RESP, send_resp,
                               resp[..., None, :], c.zero_rl,
                               resp_pay[..., None, :, :], credits,
                               unbounded=True)
        carries = (resp == int(MsgType.RESP_DATA)) | \
            (resp == int(MsgType.RESP_DATA_DIRTY))
        msg_count, payload_msgs = _count(msg_count, payload_msgs, resp != _NOP,
                                         resp, carries)

    with span("engine.respond"):
        # ---- 7. grant responses arrive at the remotes --------------------
        ch_resp_in = ch_resp
        ch_resp, r_arr = tp.deliver(ch_resp, tp.CLASS_HOME_RESP, delays,
                                    delay_l=dly_resp)
        was_load = st.agents.pending_op == int(LocalOp.LOAD)
        agents, nack = ag.on_response(tables, st.agents, r_arr, ch_resp_in.msg,
                                      ch_resp_in.payload, nack_holds=True)
        load_done = r_arr & was_load & ~nack
        load_val = agents.cache.masked_fill(~load_done[..., None], 0)

        # ---- 8. home-initiated downgrades arrive at the remotes ----------
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

    with span("engine.submit"):
        # ---- 9. remotes submit local ops (fresh + parked retries) --------
        if packed:
            locked = dmn.unpack_mask(_pend_or(hreq_pending), R) | \
                (ch_hreq.msg != _NOP)
        else:
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
        if not emit_events:
            return new, out
        return new, out, StepEvents(
            hresp_arr=hr_arr, hresp_msg=ch_hresp_in.msg,
            hresp_dirty=ch_hresp_in.dirty,
            vol_arr=pop_vol, vol_msg=vol_msg, vol_dirty=vol_dirty,
            req_acc=accept_line & ~home_win, req_msg=win_msg,
            req_node=win_node,
            grant=resp != _NOP, grant_msg=resp, grant_node=node_c,
            grant_pay=carries,
            hd_arr=h_arr, hd_msg=ch_hreq_in.msg)


def busy_flag_mn(st: EngineMNState) -> torch.Tensor:
    """[] bool tensor: any transaction, channel slot or home want is
    still in flight (stays on the device; no host synchronisation).
    Works on both layouts of ``hreq_pending``; a fleet state (``msg_count
    [M, 16]``) gets one flag per member, ``[M]``."""
    # the [R, L] int8 code planes are non-zero exactly where busy, so one
    # OR of them carries every per-lane test.
    lanes = (st.agents.pending_req | st.agents.pending_op | st.ch_req.msg
             | st.ch_resp.msg | st.ch_hreq.msg | st.ch_hresp.msg)
    if st.msg_count.dim() == 2:
        def anym(x):
            return x.flatten(1).any(1)
    else:
        def anym(x):
            return x.any()
    return (anym(lanes) | anym(st.hreq_pending) | anym(st.txn_msg)
            | anym(st.want_read) | anym(st.want_write))


class EngineMN:
    """Binds a protocol subset, delays, credits, a home plan, a directory
    layout and a device to the step.

    ``moesi`` picks the full protocol (``True`` → FULL_MOESI, ``False`` →
    ENHANCED_MESI) unless an explicit ``subset`` is given.
    ``shared_credits`` ranks the home's fan-out against one credit pool
    across all R rows; ``n_homes`` interleaves line ownership across that
    many homes (it must divide the line count) and ``home_bw`` caps each
    home's new transactions per step (0 = unbounded); ``packed`` keeps
    the directory view and the pending home-downgrade mask as
    ``[2, L, ceil(R/32)]`` int32 word planes.  ``device`` defaults to
    ``"cuda"``; with no GPU present that raises — pass ``device="cpu"``
    for the plain path."""

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
        self.device = resolve_device(device)
        self.n_remotes = n_remotes
        self.subset = subset if subset is not None else \
            (FULL_MOESI if moesi else ENHANCED_MESI)
        self.moesi = self.subset.tables.moesi
        self.tables = device_tables(self.subset, self.device)
        self._backing = torch.as_tensor(backing).to(self.device)
        self.n_lines, self.block = self._backing.shape
        if n_homes < 1 or self.n_lines % n_homes:
            raise ValueError(
                f"n_homes={n_homes} must divide n_lines={self.n_lines} "
                f"(the address-interleaved fold reshapes the line axis)")
        if home_bw < 0:
            raise ValueError(f"home_bw={home_bw} must be >= 0 (0 = "
                             f"unbounded acceptance)")
        self.shared_credits = bool(shared_credits)
        self.n_homes = n_homes
        self.home_bw = home_bw
        self.packed = bool(packed)
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
        return make_engine_mn_state(self._backing.clone(), self.n_remotes,
                                    packed=self.packed)

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
                       wval, self.delays, self.credits,
                       hreq_shared=self.shared_credits,
                       n_homes=self.n_homes, home_bw=self.home_bw)

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
                f"steps (R={self.n_remotes}, L={self.n_lines}, "
                f"H={self.n_homes})")
        return st

    def run_ops(self, st: EngineMNState, opv: torch.Tensor,
                op_val: torch.Tensor, max_rounds: int = 64):
        """Submit ``opv`` [R, L] and drain to quiescence: (state, done [L],
        vals [L, B], rounds, still_busy), ``done`` and ``vals`` reduced
        over the remote axis (at most one remote acts per line per call)
        — see ``core.engine.run_ops``."""
        L, B = self.n_lines, self.block
        zb = torch.zeros(L, dtype=torch.bool, device=self.device)
        zwv = torch.zeros((L, B), dtype=st.dir.backing.dtype,
                          device=self.device)

        def step_fn(s, o, v):
            return step_mn(self.tables, s, o, v, zb, zb, zwv, self.delays,
                           self.credits, hreq_shared=self.shared_credits,
                           n_homes=self.n_homes, home_bw=self.home_bw)

        return run_ops(step_fn, busy_flag_mn, st, opv, op_val, max_rounds,
                       reduce_remotes=True)
