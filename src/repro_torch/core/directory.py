"""Home-node directory of the two-node engine (paper §4.2), on tensors.

The port of ``repro.core.directory``: the stable-state machine is the
dense ``[msg, home_state, view]`` table of ``FULL`` or ``MINIMAL``
(``core.protocol.two_node_tables``), applied to all lines at once with
gathers — no per-line control flow.

``stateless=True`` is the STATELESS specialization of §3.4: the home
never mutates per-line state, serves reads from the backing store and
ignores voluntary downgrades.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .messages import MsgType
from .protocol import TwoNodeTables
from .states import HomeState, RemoteView

_NOP = int(MsgType.NOP)
_M, _O, _S, _I = (int(HomeState.M), int(HomeState.O), int(HomeState.S),
                  int(HomeState.I))


class DirectoryState(NamedTuple):
    home_state: torch.Tensor   # [L] int8 HomeState
    view: torch.Tensor         # [L] int8 RemoteView (home's belief)
    backing: torch.Tensor      # [L, B] the at-rest data (DRAM analogue)
    home_buf: torch.Tensor     # [L, B] home's cached copy (valid when != I)
    illegal: torch.Tensor      # [] int32: count of illegal transitions seen


def make_directory(backing: torch.Tensor) -> DirectoryState:
    """An idle directory over ``backing`` (on its device)."""
    n_lines, dev = backing.shape[0], backing.device
    return DirectoryState(
        home_state=torch.zeros(n_lines, dtype=torch.int8, device=dev),
        view=torch.zeros(n_lines, dtype=torch.int8, device=dev),
        backing=backing,
        home_buf=torch.zeros_like(backing),
        illegal=torch.zeros((), dtype=torch.int32, device=dev),
    )


def process(tables: TwoNodeTables, st: DirectoryState, active: torch.Tensor,
            msg: torch.Tensor, dirty: torch.Tensor, payload: torch.Tensor,
            stateless: bool = False
            ) -> Tuple[DirectoryState, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Apply one incoming message per active line to the directory.

    ``msg`` [L] int8 is the request, or for a reply to a home downgrade
    the ORIGINAL home request type with the reply's ``dirty`` flag;
    ``payload`` [L, B] the incoming data.  Returns (new_state, resp_msg
    [L] int8 (NOP where no response is due), resp_dirty [L] bool,
    resp_payload [L, B])."""
    m = msg.long()
    if stateless:
        # §3.4: single joint state I*; answer READ_SHARED from backing,
        # ignore voluntary downgrades, nothing else may arrive (req. 5).
        is_read = active & (m == int(MsgType.REQ_READ_SHARED))
        is_vol = active & ((m == int(MsgType.VOL_DOWNGRADE_I))
                           | (m == int(MsgType.VOL_DOWNGRADE_S)))
        resp = torch.where(is_read, int(MsgType.RESP_DATA), _NOP) \
            .to(torch.int8)
        bad = active & ~is_read & ~is_vol
        st = st._replace(illegal=st.illegal + bad.sum(dtype=torch.int32))
        return st, resp, torch.zeros_like(dirty), st.backing

    hs = st.home_state.long()
    vw = st.view.long()
    new_home = tables.home_new_home[m, hs, vw].long()
    new_view = tables.home_new_view[m, hs, vw]
    resp = tables.home_resp[m, hs, vw]
    resp_dirty = tables.home_resp_dirty[m, hs, vw]
    wb_flag = tables.home_writeback[m, hs, vw]
    legal = tables.home_legal[m, hs, vw]

    # clean-case substitution: a downgrade that arrives WITHOUT dirty data
    # cannot leave the home holding dirty state (source-indexed override);
    # a clean downgrade also has nothing to write back.
    clean_home = tables.home_clean_case[m, hs, vw].long()
    new_home = torch.where(dirty, new_home, clean_home)
    writeback = wb_flag & dirty

    do = active & legal

    # 1. absorb a dirty payload into home_buf when entering M or O;
    # 2. the home takes a shared copy on downgrade-to-shared responses.
    absorbs = do & dirty & ((new_home == _M) | (new_home == _O))
    takes_copy = do & (new_home == _S) & (hs == _I)
    home_buf = torch.where((absorbs | (takes_copy & dirty))[:, None],
                           payload, st.home_buf)
    home_buf = torch.where((takes_copy & ~dirty)[:, None], st.backing,
                           home_buf)
    # 3. write dirty payloads back to the backing store;
    # 3b. the invisible writeback of the home's own dirty copy when it
    #     gives up ownership cleanly (the message carries no payload).
    backing = torch.where((do & writeback)[:, None], payload, st.backing)
    own_wb = do & wb_flag & ~dirty & ((hs == _M) | (hs == _O))
    backing = torch.where(own_wb[:, None], st.home_buf, backing)

    # the home serves its own copy if it has one (invisible to the remote
    # — requirement 4), else backing.
    resp_payload = torch.where((hs != _I)[:, None], st.home_buf, backing)

    new = DirectoryState(
        home_state=torch.where(do, new_home.to(torch.int8), st.home_state),
        view=torch.where(do, new_view, st.view),
        backing=backing,
        home_buf=home_buf,
        illegal=st.illegal + (active & ~legal).sum(dtype=torch.int32),
    )
    return new, resp.masked_fill(~do, _NOP), resp_dirty & do, resp_payload


def needed_downgrade(st: DirectoryState, want_read: torch.Tensor,
                     want_write: torch.Tensor) -> torch.Tensor:
    """[L] int8 MsgType: the home-initiated request each home-side access
    needs.  Home reads require the remote not to hold a dirty copy (view
    EM -> downgrade to S); home writes require remote I."""
    vw = st.view
    need_s = want_read & (vw == int(RemoteView.EM))
    need_i = want_write & (vw != int(RemoteView.I))
    out = torch.where(need_i, int(MsgType.HOME_DOWNGRADE_I), _NOP)
    out = torch.where(need_s & ~need_i, int(MsgType.HOME_DOWNGRADE_S), out)
    return out.to(torch.int8)


def home_read_value(st: DirectoryState) -> torch.Tensor:
    """[L, B] — the value the home side reads (own copy if cached)."""
    has = st.home_state != _I
    return torch.where(has[:, None], st.home_buf, st.backing)


def home_apply_write(st: DirectoryState, mask: torch.Tensor,
                     value: torch.Tensor) -> DirectoryState:
    """Apply home-side writes for ``mask`` lines (after the remote is I)."""
    has = st.home_state != _I
    wb = mask & has
    direct = mask & ~has
    return st._replace(
        home_buf=torch.where(wb[:, None], value, st.home_buf),
        home_state=st.home_state.masked_fill(wb, _M),
        backing=torch.where(direct[:, None], value, st.backing),
    )
