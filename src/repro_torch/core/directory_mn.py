"""Sharer-vector home directory for the N-remote engine (paper §4.1).

The port of ``repro.core.directory_mn``, dense layout only: a full view
VECTOR ``[R, L]`` per line (the classic full-map directory, sharer set =
``view != I``).  ``absorb`` applies downgrade payloads arriving at the
home, ``grant`` completes requests whose fan-out preconditions hold, and
``needed_downgrades`` is the write-invalidate fan-out rule.  The
bit-packed word-plane layout is not ported yet.

Every function is polymorphic over LEADING batch axes; the remote axis
is always ``dim=-2`` of ``view``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .messages import MsgType
from .protocol import N_MSG, MnAbsorb, TorchTables
from .states import HomeState, RemoteView

_NOP = int(MsgType.NOP)


class DirectoryMNState(NamedTuple):
    home_state: torch.Tensor   # [L] int8 HomeState
    view: torch.Tensor         # [R, L] int8 RemoteView per remote
    backing: torch.Tensor      # [L, B] at-rest data
    home_buf: torch.Tensor     # [L, B] home's copy (valid when state != I)
    illegal: torch.Tensor      # [] int32


def make_directory_mn(backing: torch.Tensor, n_remotes: int
                      ) -> DirectoryMNState:
    n_lines = backing.shape[0]
    dev = backing.device
    return DirectoryMNState(
        home_state=torch.zeros(n_lines, dtype=torch.int8, device=dev),
        view=torch.zeros((n_remotes, n_lines), dtype=torch.int8, device=dev),
        backing=backing,
        home_buf=torch.zeros_like(backing),
        illegal=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _take_remote(arr: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Gather ``arr[..., node[l], l]`` — one remote's row per line.

    ``arr`` is ``[..., R, L]`` (or ``[..., R, L, B]``), ``node`` is
    ``[..., L]`` (any integer dtype)."""
    idx = node.long()
    if arr.dim() == node.dim() + 2:            # [..., R, L, B] payloads
        idx = idx[..., None, :, None].expand(
            idx.shape[:-1] + (1,) + idx.shape[-1:] + arr.shape[-1:])
        return torch.gather(arr, -3, idx).squeeze(-3)
    return torch.gather(arr, -2, idx[..., None, :]).squeeze(-2)


def view_of(st: DirectoryMNState, node: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` int32 — the per-line requester's ``RemoteView`` code."""
    return _take_remote(st.view, node).to(torch.int32)


def home_value(st: DirectoryMNState) -> torch.Tensor:
    """[..., L, B] — the line value as seen by the home (own copy if
    cached)."""
    has = st.home_state != int(HomeState.I)
    return torch.where(has[..., None], st.home_buf, st.backing)


def absorb(tables: TorchTables, st: DirectoryMNState, active: torch.Tensor,
           kind: torch.Tensor, dirty: torch.Tensor, payload: torch.Tensor
           ) -> DirectoryMNState:
    """Apply per-remote downgrade-ish arrivals to the directory.

    ``active``/``kind``/``dirty`` are ``[R, L]`` (kind an int8
    ``MnAbsorb`` code), ``payload`` ``[R, L, B]``.  View updates commute
    across remotes; at most one absorb per line can be dirty (single
    writer), so home-state/data effects select the unique dirty source.
    A STATELESS home tracks nothing and absorbs by doing nothing."""
    if tables.stateless_home:
        return st
    vol_i = int(MnAbsorb.VOL_I)
    rep_s = int(MnAbsorb.REPLY_S)
    rep_i = int(MnAbsorb.REPLY_I)

    to_i = active & ((kind == vol_i) | (kind == rep_i))
    # a clean reply to a recall-to-shared only confirms S if the home
    # still believes EM — a crossing voluntary eviction may already have
    # cleared the view, and the remote is then truly I (races, §3.3).
    to_s = active & (kind == rep_s) & \
        ((st.view == int(RemoteView.EM)) | dirty)
    view = st.view.masked_fill(to_i, int(RemoteView.I))
    view = view.masked_fill(to_s, int(RemoteView.S))

    d_act = active & dirty                              # [..., R, L]
    any_dirty = d_act.any(dim=-2)                       # [..., L]
    src = torch.argmax(d_act.to(torch.int8), dim=-2)    # first dirty remote
    d_kind = _take_remote(kind, src).long()             # [..., L]
    d_pay = _take_remote(payload, src)                  # [..., L, B]

    hs = st.home_state.long()
    new_home = tables.absorb_new_home[d_kind, 1, hs]
    to_back = tables.absorb_to_backing[d_kind, 1, hs] & any_dirty
    to_buf = tables.absorb_to_homebuf[d_kind, 1, hs] & any_dirty

    home_state = torch.where(any_dirty, new_home, st.home_state)
    backing = torch.where(to_back[..., None], d_pay, st.backing)
    home_buf = torch.where(to_buf[..., None], d_pay, st.home_buf)

    # hidden-O upkeep: when the LAST sharer leaves a hidden-O line, the
    # home is simply dirty-exclusive again (O -> M).
    no_sharers = ~(view != int(RemoteView.I)).any(dim=-2)
    was_vol = (active & (kind == vol_i)).any(dim=-2)
    o_to_m = was_vol & no_sharers & (home_state == int(HomeState.O))
    home_state = home_state.masked_fill(o_to_m, int(HomeState.M))
    return st._replace(home_state=home_state, view=view, backing=backing,
                       home_buf=home_buf)


def needed_downgrades(st: DirectoryMNState, active: torch.Tensor,
                      msg: torch.Tensor, node: torch.Tensor,
                      rids: torch.Tensor = None) -> torch.Tensor:
    """[..., R, L] int8 — the HOME_DOWNGRADE_* each remote needs before
    ``msg`` from ``node`` can be granted (NOP where none)."""
    if rids is None:
        rids = torch.arange(st.view.shape[-2], device=st.view.device)
    others = rids[:, None] != node[..., None, :]        # [..., R, L]
    shared_req = active & (msg == int(MsgType.REQ_READ_SHARED))
    excl_req = active & ((msg == int(MsgType.REQ_READ_EXCL))
                         | (msg == int(MsgType.REQ_UPGRADE)))
    recall = shared_req[..., None, :] & others & \
        (st.view == int(RemoteView.EM))
    inval = excl_req[..., None, :] & others & (st.view != int(RemoteView.I))
    out = inval.to(torch.int8) * int(MsgType.HOME_DOWNGRADE_I)
    return out.masked_fill(recall, int(MsgType.HOME_DOWNGRADE_S))


def home_needed_downgrades(st: DirectoryMNState, want_read: torch.Tensor,
                           want_write: torch.Tensor) -> torch.Tensor:
    """[..., R, L] int8 — downgrades required before a HOME-side access:
    reads recall a dirty owner to S, writes invalidate every sharer."""
    recall = want_read[..., None, :] & (st.view == int(RemoteView.EM))
    inval = want_write[..., None, :] & (st.view != int(RemoteView.I))
    out = inval.to(torch.int8) * int(MsgType.HOME_DOWNGRADE_I)
    return out.masked_fill(recall & ~inval, int(MsgType.HOME_DOWNGRADE_S))


def grant(tables: TorchTables, st: DirectoryMNState, active: torch.Tensor,
          msg: torch.Tensor, node: torch.Tensor, rids: torch.Tensor = None
          ) -> Tuple[DirectoryMNState, torch.Tensor, torch.Tensor]:
    """Complete requests whose downgrade preconditions hold.

    ``active``/``msg``/``node`` are ``[..., L]``.  Returns (new_state,
    resp [..., L] int8 (NOP where inactive), payload [..., L, B]).  An
    UPGRADE whose requester view was concurrently invalidated is NACKed.
    A STATELESS home serves READ_SHARED from the at-rest data and records
    nothing."""
    # a line the home holds parks the HOME_TXN sentinel (100), outside the
    # tables' 16 message rows: clamp it onto the last row, as the
    # reference's gathers clamp; those lanes are never ``active``.
    m = msg.long().clamp(max=N_MSG - 1)
    hs = st.home_state.long()
    req_view = view_of(st, node)

    want_view = tables.request_view[m]
    legal = tables.grant_legal[m, hs] & (req_view == want_view)
    is_upgrade_race = active & (m == int(MsgType.REQ_UPGRADE)) & \
        (req_view != int(RemoteView.S))
    do = active & legal

    val = home_value(st)                                # serve-then-move
    new_home = tables.grant_new_home[m, hs]
    resp = tables.grant_resp[m, hs]
    wb = tables.grant_wb[m, hs]

    if tables.stateless_home:
        backing, home_state, view = st.backing, st.home_state, st.view
    else:
        backing = torch.where((do & wb)[..., None], st.home_buf, st.backing)
        home_state = torch.where(do, new_home, st.home_state)
        new_view = tables.grant_view[m]
        if rids is None:
            rids = torch.arange(st.view.shape[-2], device=st.view.device)
        onehot = rids[:, None] == node[..., None, :]
        view = torch.where(onehot & do[..., None, :],
                           new_view[..., None, :], st.view)

    resp = resp.masked_fill(~do, _NOP)
    resp = resp.masked_fill(is_upgrade_race, int(MsgType.RESP_NACK))
    bad = active & ~legal & ~is_upgrade_race
    new = st._replace(home_state=home_state, view=view, backing=backing,
                      illegal=st.illegal + bad.sum(dtype=torch.int32))
    return new, resp, val


def home_apply_write(st: DirectoryMNState, mask: torch.Tensor,
                     value: torch.Tensor) -> DirectoryMNState:
    """Home-side writes for ``mask`` lines (preconditions: all views I)."""
    has = st.home_state != int(HomeState.I)
    wb = mask & has
    direct = mask & ~has
    return st._replace(
        home_buf=torch.where(wb[..., None], value, st.home_buf),
        home_state=st.home_state.masked_fill(wb, int(HomeState.M)),
        backing=torch.where(direct[..., None], value, st.backing),
    )
