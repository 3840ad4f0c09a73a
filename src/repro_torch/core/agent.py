"""Remote caching agent: the 4-state protocol of Fig. 1(b), on tensors.

The port of ``repro.core.agent``.  The remote only ever sees the merged
joint states ``*S, *I, IE, IM``, so the agent is a 4-state machine per
line plus one MSHR (pending transaction) per line; ``pending_req != NOP``
marks a line with a request in flight.

Every function is polymorphic over LEADING batch axes: ``[L]`` fields
model one agent, ``[R, L]`` the N-remote engine's R agents — the tallies
(``illegal``, ``hits``, ``misses``) reduce over the LINE axis only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device
from .messages import MsgType
from .protocol import LocalOp, TorchTables
from .states import RemoteState

_NOP = int(MsgType.NOP)


class AgentState(NamedTuple):
    remote_state: torch.Tensor   # [L] int8 RemoteState
    cache: torch.Tensor          # [L, B] local copy (valid when != I)
    pending_req: torch.Tensor    # [L] int8 MsgType in flight (NOP = none)
    pending_op: torch.Tensor     # [L] int8 LocalOp to complete after grant
    pending_val: torch.Tensor    # [L, B] store value awaiting grant
    illegal: torch.Tensor        # [] int32
    hits: torch.Tensor           # [] int32
    misses: torch.Tensor         # [] int32


def plane_shape(agents: AgentState) -> tuple:
    """(R, L) of a batched-agent state: the canonical dense plane shape."""
    return tuple(agents.remote_state.shape[-2:])


def make_agent(n_lines: int, block: int, dtype=torch.float32,
               device=None, lead: Tuple[int, ...] = ()) -> AgentState:
    """Idle agents on ``device`` (default the card; raises without
    one)."""
    z = dict(device=resolve_device(device))
    return AgentState(
        remote_state=torch.zeros(lead + (n_lines,), dtype=torch.int8, **z),
        cache=torch.zeros(lead + (n_lines, block), dtype=dtype, **z),
        pending_req=torch.zeros(lead + (n_lines,), dtype=torch.int8, **z),
        pending_op=torch.zeros(lead + (n_lines,), dtype=torch.int8, **z),
        pending_val=torch.zeros(lead + (n_lines, block), dtype=dtype, **z),
        illegal=torch.zeros(lead, dtype=torch.int32, **z),
        hits=torch.zeros(lead, dtype=torch.int32, **z),
        misses=torch.zeros(lead, dtype=torch.int32, **z),
    )


def submit(tables: TorchTables, st: AgentState, op: torch.Tensor,
           value: torch.Tensor
           ) -> Tuple[AgentState, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Issue local ops (LOAD/STORE/EVICT) against the agent.

    Ops on lines with a pending transaction are REFUSED (one MSHR per
    line); hits complete immediately, misses park and emit a request.
    One agent row may issue several ops in one call, one per line.

    Returns (state, accepted, request_msg, req_dirty, req_payload).
    """
    o = op.long()
    rs = st.remote_state.long()
    idle = st.pending_req == _NOP
    accepted = (o != int(LocalOp.NOP)) & idle

    new_state = tables.loc_new_state[o, rs]
    request = tables.loc_request[o, rs]
    req_dirty = tables.loc_req_dirty[o, rs]
    hit = tables.loc_hit[o, rs]

    is_hit = accepted & hit
    is_miss = accepted & ~hit
    is_store_hit = is_hit & (o == int(LocalOp.STORE))

    remote_state = torch.where(is_hit, new_state, st.remote_state)
    cache = torch.where(is_store_hit[..., None], value, st.cache)
    req_payload = st.cache

    pending_req = torch.where(is_miss, request, st.pending_req)
    pending_op = torch.where(is_miss, op.to(torch.int8), st.pending_op)
    pending_val = torch.where(is_miss[..., None], value, st.pending_val)

    emit = request.masked_fill(~accepted, _NOP)

    is_load = accepted & (o == int(LocalOp.LOAD))
    new = AgentState(
        remote_state=remote_state,
        cache=cache,
        pending_req=pending_req,
        pending_op=pending_op,
        pending_val=pending_val,
        illegal=st.illegal,
        hits=st.hits + (is_load & hit).sum(-1, dtype=torch.int32),
        misses=st.misses + (is_load & ~hit).sum(-1, dtype=torch.int32),
    )
    return new, accepted, emit, req_dirty, req_payload


def on_response(tables: TorchTables, st: AgentState, active: torch.Tensor,
                resp: torch.Tensor, payload: torch.Tensor,
                nack_holds: bool = False
                ) -> Tuple[AgentState, torch.Tensor]:
    """Complete pending transactions with their responses.

    Returns (state, nack) — NACKed lines keep their op parked for a
    retry.  ``nack_holds=True`` (the N-remote engine) keeps the CURRENT
    state on a NACK: a crossing invalidation may already have moved it
    below the state the request was issued from."""
    req = st.pending_req.long()
    rm = resp.long()
    new_state = tables.resp_new_state[req, rm].to(torch.int32)
    legal = new_state >= 0
    do = active & legal
    nack = active & (rm == int(MsgType.RESP_NACK))
    if nack_holds:
        new_state = torch.where(nack, st.remote_state.to(torch.int32),
                                new_state)

    carries = (rm == int(MsgType.RESP_DATA)) | \
        (rm == int(MsgType.RESP_DATA_DIRTY))
    cache = torch.where((do & carries)[..., None], payload, st.cache)

    # a parked STORE completes now and dirties the line.
    is_store = do & (st.pending_op == int(LocalOp.STORE)) & ~nack
    cache = torch.where(is_store[..., None], st.pending_val, cache)
    state_after = torch.where(is_store, int(RemoteState.M), new_state)

    new = st._replace(
        remote_state=torch.where(do, state_after.to(torch.int8),
                                 st.remote_state),
        cache=cache,
        pending_req=st.pending_req.masked_fill(do, _NOP),
        pending_op=st.pending_op.masked_fill(do & ~nack, int(LocalOp.NOP)),
        illegal=st.illegal + (active & ~legal).sum(-1, dtype=torch.int32),
    )
    return new, nack


def on_home_msg(tables: TorchTables, st: AgentState, active: torch.Tensor,
                msg: torch.Tensor
                ) -> Tuple[AgentState, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Process home-initiated downgrades (transitions 8, 9).

    Returns (state, resp_msg, resp_dirty, resp_payload) — the reply is
    mandatory (requirement 2 / Table 1)."""
    m = msg.long()
    rs = st.remote_state.long()
    new_state = tables.rem_new_state[m, rs]
    resp = tables.rem_resp[m, rs]
    resp_dirty = tables.rem_resp_dirty[m, rs]
    legal = tables.rem_legal[m, rs]
    do = active & legal
    new = st._replace(
        remote_state=torch.where(do, new_state, st.remote_state),
        illegal=st.illegal + (active & ~legal).sum(-1, dtype=torch.int32),
    )
    return new, resp.masked_fill(~do, _NOP), do & resp_dirty, st.cache


def read_hit_values(st: AgentState, lines_mask: torch.Tensor
                    ) -> torch.Tensor:
    """[L, B] cache content for lines held in a readable state."""
    readable = st.remote_state != int(RemoteState.I)
    return st.cache.masked_fill(~(lines_mask & readable)[..., None], 0)
