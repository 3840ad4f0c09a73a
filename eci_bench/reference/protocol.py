"""The protocol tables the plain reference steps with, built here from
the ECI paper's Table 1 and Fig. 1 (full MOESI, the N-remote
sharer-vector home).

Codes are plain integers: home states I S E M O = 0..4, remote states
I S E M = 0..3, remote views I S EM = 0..2, message types as in Table 1
(NOP 0, REQ_READ_SHARED 1, REQ_READ_EXCL 2, REQ_UPGRADE 3,
VOL_DOWNGRADE_S 4, VOL_DOWNGRADE_I 5, HOME_DOWNGRADE_S 6,
HOME_DOWNGRADE_I 7, RESP_DATA 8, RESP_DATA_DIRTY 9, RESP_ACK 10,
RESP_NACK 11), local ops NOP LOAD STORE EVICT DEMOTE = 0..4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# home states, remote states, remote views
H_I, H_S, H_E, H_M, H_O = range(5)
R_I, R_S, R_E, R_M = range(4)
V_I, V_S, V_EM = range(3)
# message types
NOP = 0
REQ_READ_SHARED, REQ_READ_EXCL, REQ_UPGRADE = 1, 2, 3
VOL_DOWNGRADE_S, VOL_DOWNGRADE_I = 4, 5
HOME_DOWNGRADE_S, HOME_DOWNGRADE_I = 6, 7
RESP_DATA, RESP_DATA_DIRTY, RESP_ACK, RESP_NACK = 8, 9, 10, 11
N_MSG = 16
#: the code a line parks while the home itself holds its transaction.
HOME_TXN = 100
# local ops
LOAD, STORE, EVICT, DEMOTE = 1, 2, 3, 4
N_OPS = 5
# kinds of payload the home absorbs
ABS_VOL_I, ABS_REPLY_S, ABS_REPLY_I = 0, 1, 2


class Tables(NamedTuple):
    """Every table the step gathers from, as tensors on one device."""

    loc_new_state: torch.Tensor   # [op, remote state] int8
    loc_request: torch.Tensor     # [op, remote state] int8 message
    loc_req_dirty: torch.Tensor   # [op, remote state] bool
    loc_hit: torch.Tensor         # [op, remote state] bool
    rem_new_state: torch.Tensor   # [msg, remote state] int8
    rem_resp: torch.Tensor        # [msg, remote state] int8
    rem_resp_dirty: torch.Tensor  # [msg, remote state] bool
    rem_legal: torch.Tensor       # [msg, remote state] bool
    resp_new_state: torch.Tensor  # [request, response] int8, -1 illegal
    grant_new_home: torch.Tensor  # [msg, home state] int8
    grant_resp: torch.Tensor      # [msg, home state] int8
    grant_wb: torch.Tensor        # [msg, home state] bool
    grant_legal: torch.Tensor     # [msg, home state] bool
    grant_view: torch.Tensor      # [msg] int8 requester view after a grant
    absorb_new_home: torch.Tensor   # [kind, dirty, home state] int8
    absorb_to_backing: torch.Tensor  # [kind, dirty, home state] bool
    absorb_to_homebuf: torch.Tensor  # [kind, dirty, home state] bool
    request_view: torch.Tensor    # [msg] int32 view a request needs
    op_ok: torch.Tensor           # [op] bool: ops the N-remote engine takes


def _local():
    """A local op at the remote: new state, request emitted, dirty
    payload, hit (completes without a message)."""
    ns = np.zeros((N_OPS, 4), np.int8)
    rq = np.zeros((N_OPS, 4), np.int8)
    rd = np.zeros((N_OPS, 4), bool)
    ht = np.zeros((N_OPS, 4), bool)

    def put(op, rs, new, req, dirty, hit):
        ns[op, rs], rq[op, rs], rd[op, rs], ht[op, rs] = new, req, dirty, hit

    for rs in range(4):                       # NOP: nothing happens
        put(NOP, rs, rs, NOP, False, True)
    put(LOAD, R_I, R_I, REQ_READ_SHARED, False, False)
    for rs in (R_S, R_E, R_M):
        put(LOAD, rs, rs, NOP, False, True)
    put(STORE, R_I, R_I, REQ_READ_EXCL, False, False)
    put(STORE, R_S, R_S, REQ_UPGRADE, False, False)
    put(STORE, R_E, R_M, NOP, False, True)    # the silent E -> M upgrade
    put(STORE, R_M, R_M, NOP, False, True)
    put(EVICT, R_I, R_I, NOP, False, True)
    put(EVICT, R_S, R_I, VOL_DOWNGRADE_I, False, True)
    put(EVICT, R_E, R_I, VOL_DOWNGRADE_I, False, True)
    put(EVICT, R_M, R_I, VOL_DOWNGRADE_I, True, True)
    put(DEMOTE, R_I, R_I, NOP, False, True)
    put(DEMOTE, R_S, R_S, NOP, False, True)
    put(DEMOTE, R_E, R_S, VOL_DOWNGRADE_S, False, True)
    put(DEMOTE, R_M, R_S, VOL_DOWNGRADE_S, True, True)
    return ns, rq, rd, ht


def _remote():
    """A home-initiated downgrade at the remote: new state, the
    mandatory reply, its dirty flag, legal."""
    ns = np.zeros((N_MSG, 4), np.int8)
    rp = np.full((N_MSG, 4), RESP_NACK, np.int8)
    rd = np.zeros((N_MSG, 4), bool)
    lg = np.zeros((N_MSG, 4), bool)
    rows = {(HOME_DOWNGRADE_I, R_I): (R_I, RESP_ACK, False),
            (HOME_DOWNGRADE_I, R_S): (R_I, RESP_ACK, False),
            (HOME_DOWNGRADE_I, R_E): (R_I, RESP_ACK, False),
            (HOME_DOWNGRADE_I, R_M): (R_I, RESP_DATA_DIRTY, True),
            (HOME_DOWNGRADE_S, R_I): (R_I, RESP_ACK, False),
            (HOME_DOWNGRADE_S, R_S): (R_S, RESP_ACK, False),
            (HOME_DOWNGRADE_S, R_E): (R_S, RESP_ACK, False),
            (HOME_DOWNGRADE_S, R_M): (R_S, RESP_DATA_DIRTY, True)}
    for (m, rs), (new, resp, dirty) in rows.items():
        ns[m, rs], rp[m, rs], rd[m, rs], lg[m, rs] = new, resp, dirty, True
    return ns, rp, rd, lg


def _responses():
    """A response completing a pending request: the remote's new state."""
    t = np.full((N_MSG, N_MSG), -1, np.int8)
    for (req, resp), new in {(REQ_READ_SHARED, RESP_DATA): R_S,
                             (REQ_READ_EXCL, RESP_DATA): R_E,
                             (REQ_READ_EXCL, RESP_DATA_DIRTY): R_M,
                             (REQ_UPGRADE, RESP_ACK): R_E,
                             (REQ_READ_SHARED, RESP_NACK): R_I,
                             (REQ_READ_EXCL, RESP_NACK): R_I,
                             (REQ_UPGRADE, RESP_NACK): R_S}.items():
        t[req, resp] = new
    return t


def _grants():
    """The home granting a request once its fan-out has landed."""
    nh = np.zeros((N_MSG, 5), np.int8)
    rp = np.full((N_MSG, 5), RESP_NACK, np.int8)
    wb = np.zeros((N_MSG, 5), bool)
    lg = np.zeros((N_MSG, 5), bool)
    vw = np.zeros(N_MSG, np.int8)
    # a shared read: clean data always (the remote never sees O), the
    # home keeps its state, E degrades to S, M goes to the hidden O
    vw[REQ_READ_SHARED] = V_S
    for hs in range(5):
        lg[REQ_READ_SHARED, hs] = True
        rp[REQ_READ_SHARED, hs] = RESP_DATA
        nh[REQ_READ_SHARED, hs] = hs
    nh[REQ_READ_SHARED, H_E] = H_S
    nh[REQ_READ_SHARED, H_M] = H_O
    # an exclusive read or an upgrade: the home gives the line up,
    # writing a dirty copy back first
    for msg, resp in ((REQ_READ_EXCL, RESP_DATA), (REQ_UPGRADE, RESP_ACK)):
        vw[msg] = V_EM
        for hs in range(5):
            lg[msg, hs] = True
            rp[msg, hs] = resp
            nh[msg, hs] = H_I
            wb[msg, hs] = hs in (H_M, H_O)
    # an upgrade implies the requester holds S: the home holds no E or M
    lg[REQ_UPGRADE, H_E] = lg[REQ_UPGRADE, H_M] = False
    return nh, rp, wb, lg, vw


def _absorbs():
    """A payload arriving at the home: [kind, dirty, home state]."""
    nh = np.zeros((3, 2, 5), np.int8)
    bk = np.zeros((3, 2, 5), bool)
    hb = np.zeros((3, 2, 5), bool)
    for hs in range(5):
        nh[:, :, hs] = hs
        if hs in (H_I, H_O):
            nh[ABS_VOL_I, 1, hs] = H_M      # kept dirty at home, hidden
            hb[ABS_VOL_I, 1, hs] = True
        else:
            bk[ABS_VOL_I, 1, hs] = True     # written through
        nh[ABS_REPLY_S, 1, hs] = H_O
        hb[ABS_REPLY_S, 1, hs] = True
        bk[ABS_REPLY_I, 1, hs] = True
    return nh, bk, hb


def tables(device) -> Tables:
    """The tables of full MOESI on ``device``."""
    l_ns, l_rq, l_rd, l_ht = _local()
    r_ns, r_rp, r_rd, r_lg = _remote()
    g_nh, g_rp, g_wb, g_lg, g_vw = _grants()
    a_nh, a_bk, a_hb = _absorbs()
    rv = np.zeros(N_MSG, np.int32)
    rv[REQ_UPGRADE] = V_S
    ok = np.zeros(N_OPS, bool)
    ok[[NOP, LOAD, STORE, EVICT]] = True      # no DEMOTE with N remotes

    def t(a):
        return torch.as_tensor(a, device=device)

    return Tables(t(l_ns), t(l_rq), t(l_rd), t(l_ht), t(r_ns), t(r_rp),
                  t(r_rd), t(r_lg), t(_responses()), t(g_nh), t(g_rp),
                  t(g_wb), t(g_lg), t(g_vw), t(a_nh), t(a_bk), t(a_hb),
                  t(rv), t(ok))
