"""The ECI protocol envelope as dense transition tables (§3.3, §3.4).

A copy of the table side of ``repro.core.protocol`` (numpy, as there):
the 2-node tables and their dense bake (``bake``), the protocol-subset
lattice (``ProtocolSubset``, ``FULL_MOESI``/``ENHANCED_MESI``/
``READ_ONLY``/``STATELESS``) and the N-remote sharer-vector tables
(``bake_mn``/``mn_tables``).  The ``verify_envelope*`` checks are not
ported yet.

``device_tables`` puts one subset's baked tables on a device as tensors,
once per (subset, device): the engine's step gathers from those, never
from numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, NamedTuple, Tuple

import numpy as np
import torch

from .messages import MsgType
from .states import HomeState, RemoteState, RemoteView

# ---------------------------------------------------------------------------
# Local operations the remote application issues against its agent.
# ---------------------------------------------------------------------------


class LocalOp:
    NOP = 0
    LOAD = 1          # read a line
    STORE = 2         # write a line
    EVICT = 3         # voluntary downgrade to I (transitions 4,5,6)
    DEMOTE = 4        # voluntary downgrade to S (transition 7)
    N = 5


# ---------------------------------------------------------------------------
# Table rows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HomeRow:
    """Effect of an incoming message on the home directory."""

    new_home: int            # HomeState
    new_view: int            # RemoteView
    resp: int                # MsgType of the response (NOP = none)
    resp_dirty: bool         # response payload is dirty data
    writeback: bool          # home writes a dirty payload to the backing store
    legal: bool = True


@dataclasses.dataclass(frozen=True)
class RemoteRow:
    """Effect of an incoming home-initiated message on the remote agent."""

    new_remote: int          # RemoteState
    resp: int                # MsgType (responses to home downgrades mandatory)
    resp_dirty: bool
    legal: bool = True


@dataclasses.dataclass(frozen=True)
class LocalRow:
    """Effect of a local op on the remote agent: either a silent transition
    or an outgoing request (and a stall until its response)."""

    new_remote: int          # state after the *silent* part (or pending base)
    request: int             # MsgType to emit (NOP = silent / hit)
    req_dirty: bool          # request carries dirty payload (writebacks)
    hit: bool                # local op completes without any message


ILLEGAL_HOME = HomeRow(new_home=0, new_view=0, resp=int(MsgType.RESP_NACK),
                       resp_dirty=False, writeback=False, legal=False)
ILLEGAL_REMOTE = RemoteRow(new_remote=0, resp=int(MsgType.RESP_NACK),
                           resp_dirty=False, legal=False)

H, R, V, M = HomeState, RemoteState, RemoteView, MsgType


# ---------------------------------------------------------------------------
# Home directory table: (incoming msg, home state, remote view) -> HomeRow.
# ---------------------------------------------------------------------------


def build_home_table(moesi: bool) -> Dict[Tuple[int, int, int], HomeRow]:
    """Build the home-node transition table.

    ``moesi=False`` gives the MINIMAL enhanced-MESI protocol (dirty data is
    written back before sharing — home never enters O/M via downgrades);
    ``moesi=True`` adds the hidden-O forwarding of transition 10.
    """
    t: Dict[Tuple[int, int, int], HomeRow] = {}

    def put(msg, home, view, row):
        t[(int(msg), int(home), int(view))] = row

    # ---- transition 1: remote READ_SHARED (remote I -> S) ----
    put(M.REQ_READ_SHARED, H.I, V.I,
        HomeRow(H.I, V.S, M.RESP_DATA, False, False))          # II  -> IS
    put(M.REQ_READ_SHARED, H.S, V.I,
        HomeRow(H.S, V.S, M.RESP_DATA, False, False))          # SI  -> SS
    put(M.REQ_READ_SHARED, H.E, V.I,
        HomeRow(H.S, V.S, M.RESP_DATA, False, False))          # EI  -> SS
    if moesi:
        # transition 10 (the MOESI concession): forward dirty data and keep
        # it hidden-dirty at home.  Requirement 4: the response must look
        # exactly like a clean RESP_DATA to the remote.
        put(M.REQ_READ_SHARED, H.M, V.I,
            HomeRow(H.O, V.S, M.RESP_DATA, False, False))      # MI  -> (O)S
    else:
        # minimal protocol: write back, then share — same remote observation.
        put(M.REQ_READ_SHARED, H.M, V.I,
            HomeRow(H.S, V.S, M.RESP_DATA, False, True))       # MI  -> SS

    # ---- transition 2: remote READ_EXCL (remote I -> E/M) ----
    put(M.REQ_READ_EXCL, H.I, V.I,
        HomeRow(H.I, V.EM, M.RESP_DATA, False, False))         # II  -> IE
    put(M.REQ_READ_EXCL, H.S, V.I,
        HomeRow(H.I, V.EM, M.RESP_DATA, False, False))         # SI  -> IE
    put(M.REQ_READ_EXCL, H.E, V.I,
        HomeRow(H.I, V.EM, M.RESP_DATA, False, False))         # EI  -> IE
    if moesi:
        # ownership transfer: dirty data forwarded, remote enters M.
        put(M.REQ_READ_EXCL, H.M, V.I,
            HomeRow(H.I, V.EM, M.RESP_DATA_DIRTY, True, False))  # MI -> IM
    else:
        put(M.REQ_READ_EXCL, H.M, V.I,
            HomeRow(H.I, V.EM, M.RESP_DATA, False, True))      # MI -> IE (wb)

    # ---- transition 3: remote UPGRADE (remote S -> E) ----
    # Table 1: the upgrade response never carries a payload, so a dirty home
    # copy must be written back invisibly (requirement 4 / recommendation 2).
    put(M.REQ_UPGRADE, H.I, V.S,
        HomeRow(H.I, V.EM, M.RESP_ACK, False, False))          # IS  -> IE
    put(M.REQ_UPGRADE, H.S, V.S,
        HomeRow(H.I, V.EM, M.RESP_ACK, False, False))          # SS  -> IE
    put(M.REQ_UPGRADE, H.O, V.S,
        HomeRow(H.I, V.EM, M.RESP_ACK, False, True))           # (O)S -> IE, wb
    # race: remote's copy was concurrently invalidated -> NACK, must re-read.
    put(M.REQ_UPGRADE, H.I, V.I, ILLEGAL_HOME)

    # ---- transition 7 (voluntary downgrade M/E -> S); no response ----
    if moesi:
        # dirty case: the home absorbs the payload into the hidden O state
        # (requirement 4: invisible to the remote).  Clean case (remote was
        # E) degrades to home I via CLEAN_CASE_HOME.
        put(M.VOL_DOWNGRADE_S, H.I, V.EM,
            HomeRow(H.O, V.S, M.NOP, False, False))            # IM -> (O)S
    else:
        put(M.VOL_DOWNGRADE_S, H.I, V.EM,
            HomeRow(H.I, V.S, M.NOP, False, True))             # wb if dirty

    # ---- transitions 4,5,6 (voluntary downgrade -> I); no response ----
    put(M.VOL_DOWNGRADE_I, H.I, V.EM,
        HomeRow(H.M if moesi else H.I, V.I, M.NOP, False, not moesi))
    put(M.VOL_DOWNGRADE_I, H.I, V.S,
        HomeRow(H.I, V.I, M.NOP, False, False))                # IS  -> II
    put(M.VOL_DOWNGRADE_I, H.S, V.S,
        HomeRow(H.S, V.I, M.NOP, False, False))                # SS  -> SI
    put(M.VOL_DOWNGRADE_I, H.O, V.S,
        HomeRow(H.M, V.I, M.NOP, False, False) if moesi else
        HomeRow(H.S, V.I, M.NOP, False, True))                 # (O)S -> MI

    # ---- responses to HOME-initiated downgrades (transitions 8, 9) ----
    # transition 8 ('downgrade remote to invalid'): reply mandatory so the
    # home can distinguish remote I/S/E/M after the fact (paper §3.3).
    put(M.HOME_DOWNGRADE_I, H.I, V.S,
        HomeRow(H.I, V.I, M.NOP, False, False))                # IS -> II
    put(M.HOME_DOWNGRADE_I, H.S, V.S,
        HomeRow(H.E, V.I, M.NOP, False, False))                # SS -> EI
    put(M.HOME_DOWNGRADE_I, H.O, V.S,
        HomeRow(H.M, V.I, M.NOP, False, False) if moesi else
        HomeRow(H.E, V.I, M.NOP, False, True))                 # (O)S -> MI
    put(M.HOME_DOWNGRADE_I, H.I, V.EM,
        HomeRow(H.M if moesi else H.I, V.I, M.NOP, False, not moesi))
    # transition 9 ('downgrade remote to shared'): home takes a shared copy.
    put(M.HOME_DOWNGRADE_S, H.I, V.EM,
        HomeRow(H.O if moesi else H.S, V.S, M.NOP, False, not moesi))

    return t


#: When a voluntary downgrade or a downgrade-response arrives with a CLEAN
#: payload flag, the home's new state must degrade gracefully: the table rows
#: for ``V.EM`` sources assume the dirty (remote-was-M) case; these
#: SOURCE-keyed overrides give the clean (remote-was-E) outcome (the home
#: cannot have absorbed dirty data that was never sent).
#: Keyed by (msg, src_home_state, src_view) -> clean-case new home state.
CLEAN_CASE_HOME: Dict[Tuple[int, int, int], int] = {
    (int(M.VOL_DOWNGRADE_I), int(H.I), int(V.EM)): int(H.I),   # IE -> II
    (int(M.VOL_DOWNGRADE_S), int(H.I), int(V.EM)): int(H.I),   # IE -> IS
    (int(M.HOME_DOWNGRADE_I), int(H.I), int(V.EM)): int(H.I),  # IE -> II
    (int(M.HOME_DOWNGRADE_S), int(H.I), int(V.EM)): int(H.S),  # IE -> SS
}


# ---------------------------------------------------------------------------
# Remote agent: home-initiated messages -> RemoteRow.
# ---------------------------------------------------------------------------


def build_remote_table() -> Dict[Tuple[int, int], RemoteRow]:
    t: Dict[Tuple[int, int], RemoteRow] = {}

    def put(msg, remote, row):
        t[(int(msg), int(remote))] = row

    # transition 8: home wants the line back / evicted.
    put(M.HOME_DOWNGRADE_I, R.I, RemoteRow(R.I, M.RESP_ACK, False))   # race
    put(M.HOME_DOWNGRADE_I, R.S, RemoteRow(R.I, M.RESP_ACK, False))
    put(M.HOME_DOWNGRADE_I, R.E, RemoteRow(R.I, M.RESP_ACK, False))
    put(M.HOME_DOWNGRADE_I, R.M, RemoteRow(R.I, M.RESP_DATA_DIRTY, True))
    # transition 9: home wants a shared copy.
    put(M.HOME_DOWNGRADE_S, R.I, RemoteRow(R.I, M.RESP_ACK, False))   # race
    put(M.HOME_DOWNGRADE_S, R.S, RemoteRow(R.S, M.RESP_ACK, False))   # race
    put(M.HOME_DOWNGRADE_S, R.E, RemoteRow(R.S, M.RESP_ACK, False))
    put(M.HOME_DOWNGRADE_S, R.M, RemoteRow(R.S, M.RESP_DATA_DIRTY, True))
    return t


# ---------------------------------------------------------------------------
# Remote agent: local ops -> LocalRow.
# ---------------------------------------------------------------------------


def build_local_table() -> Dict[Tuple[int, int], LocalRow]:
    t: Dict[Tuple[int, int], LocalRow] = {}

    def put(op, remote, row):
        t[(int(op), int(remote))] = row

    n = int(M.NOP)
    # LOAD
    put(LocalOp.LOAD, R.I, LocalRow(R.I, int(M.REQ_READ_SHARED), False, False))
    for s in (R.S, R.E, R.M):
        put(LocalOp.LOAD, s, LocalRow(int(s), n, False, True))
    # STORE
    put(LocalOp.STORE, R.I, LocalRow(R.I, int(M.REQ_READ_EXCL), False, False))
    put(LocalOp.STORE, R.S, LocalRow(R.S, int(M.REQ_UPGRADE), False, False))
    # recommendation 1: the E->M upgrade is SILENT (internal dotted edge).
    put(LocalOp.STORE, R.E, LocalRow(R.M, n, False, True))
    put(LocalOp.STORE, R.M, LocalRow(R.M, n, False, True))
    # EVICT (transitions 4,5,6) — voluntary, no reply expected.
    put(LocalOp.EVICT, R.I, LocalRow(R.I, n, False, True))
    put(LocalOp.EVICT, R.S, LocalRow(R.I, int(M.VOL_DOWNGRADE_I), False, True))
    put(LocalOp.EVICT, R.E, LocalRow(R.I, int(M.VOL_DOWNGRADE_I), False, True))
    put(LocalOp.EVICT, R.M, LocalRow(R.I, int(M.VOL_DOWNGRADE_I), True, True))
    # DEMOTE (transition 7).
    put(LocalOp.DEMOTE, R.I, LocalRow(R.I, n, False, True))
    put(LocalOp.DEMOTE, R.S, LocalRow(R.S, n, False, True))
    put(LocalOp.DEMOTE, R.E, LocalRow(R.S, int(M.VOL_DOWNGRADE_S), False, True))
    put(LocalOp.DEMOTE, R.M, LocalRow(R.S, int(M.VOL_DOWNGRADE_S), True, True))
    # NOP
    for s in (R.I, R.S, R.E, R.M):
        put(LocalOp.NOP, s, LocalRow(int(s), n, False, True))
    return t


# ---------------------------------------------------------------------------
# Response handling at the remote (completing a pending request).
#   (pending request msg, response msg) -> new remote state (-1 = illegal)
# ---------------------------------------------------------------------------


RESPONSE_TABLE: Dict[Tuple[int, int], int] = {
    (int(M.REQ_READ_SHARED), int(M.RESP_DATA)): int(R.S),
    (int(M.REQ_READ_EXCL), int(M.RESP_DATA)): int(R.E),
    (int(M.REQ_READ_EXCL), int(M.RESP_DATA_DIRTY)): int(R.M),
    (int(M.REQ_UPGRADE), int(M.RESP_ACK)): int(R.E),
    # NACK: fall back to I and retry (the agent re-issues).
    (int(M.REQ_READ_SHARED), int(M.RESP_NACK)): int(R.I),
    (int(M.REQ_READ_EXCL), int(M.RESP_NACK)): int(R.I),
    (int(M.REQ_UPGRADE), int(M.RESP_NACK)): int(R.S),
}


# ---------------------------------------------------------------------------
# Dense (numpy) bakes of the tables for the vectorized jit engines.
# ---------------------------------------------------------------------------


N_MSG = 16
N_HOME = 5
N_VIEW = 3
N_REMOTE = 4


@dataclasses.dataclass(frozen=True)
class DenseTables:
    """All protocol tables as dense int arrays (gather-friendly)."""

    # home: [msg, home_state, view] -> fields
    home_new_home: np.ndarray
    home_new_view: np.ndarray
    home_resp: np.ndarray
    home_resp_dirty: np.ndarray
    home_writeback: np.ndarray
    home_legal: np.ndarray
    home_clean_case: np.ndarray      # [msg, src_home, src_view] -> clean home
    # remote: [msg, remote_state] -> fields
    rem_new_state: np.ndarray
    rem_resp: np.ndarray
    rem_resp_dirty: np.ndarray
    rem_legal: np.ndarray
    # local: [op, remote_state] -> fields
    loc_new_state: np.ndarray
    loc_request: np.ndarray
    loc_req_dirty: np.ndarray
    loc_hit: np.ndarray
    # responses: [pending_req_msg, resp_msg] -> new remote state (-1 illegal)
    resp_new_state: np.ndarray
    moesi: bool


def bake(moesi: bool) -> DenseTables:
    home = build_home_table(moesi)
    rem = build_remote_table()
    loc = build_local_table()

    h_nh = np.zeros((N_MSG, N_HOME, N_VIEW), np.int8)
    h_nv = np.zeros((N_MSG, N_HOME, N_VIEW), np.int8)
    h_rp = np.full((N_MSG, N_HOME, N_VIEW), int(M.RESP_NACK), np.int8)
    h_rd = np.zeros((N_MSG, N_HOME, N_VIEW), bool)
    h_wb = np.zeros((N_MSG, N_HOME, N_VIEW), bool)
    h_lg = np.zeros((N_MSG, N_HOME, N_VIEW), bool)
    for (msg, hs, vw), row in home.items():
        h_nh[msg, hs, vw] = int(row.new_home)
        h_nv[msg, hs, vw] = int(row.new_view)
        h_rp[msg, hs, vw] = int(row.resp)
        h_rd[msg, hs, vw] = row.resp_dirty
        h_wb[msg, hs, vw] = row.writeback
        h_lg[msg, hs, vw] = row.legal

    h_cc = h_nh.copy()
    for (msg, hs, vw), clean_hs in CLEAN_CASE_HOME.items():
        h_cc[msg, hs, vw] = clean_hs

    r_ns = np.zeros((N_MSG, N_REMOTE), np.int8)
    r_rp = np.full((N_MSG, N_REMOTE), int(M.RESP_NACK), np.int8)
    r_rd = np.zeros((N_MSG, N_REMOTE), bool)
    r_lg = np.zeros((N_MSG, N_REMOTE), bool)
    for (msg, rs), row in rem.items():
        r_ns[msg, rs] = int(row.new_remote)
        r_rp[msg, rs] = int(row.resp)
        r_rd[msg, rs] = row.resp_dirty
        r_lg[msg, rs] = row.legal

    l_ns = np.zeros((LocalOp.N, N_REMOTE), np.int8)
    l_rq = np.zeros((LocalOp.N, N_REMOTE), np.int8)
    l_rd = np.zeros((LocalOp.N, N_REMOTE), bool)
    l_ht = np.zeros((LocalOp.N, N_REMOTE), bool)
    for (op, rs), row in loc.items():
        l_ns[op, rs] = int(row.new_remote)
        l_rq[op, rs] = int(row.request)
        l_rd[op, rs] = row.req_dirty
        l_ht[op, rs] = row.hit

    rsp = np.full((N_MSG, N_MSG), -1, np.int8)
    for (req, resp), ns in RESPONSE_TABLE.items():
        rsp[req, resp] = ns

    return DenseTables(h_nh, h_nv, h_rp, h_rd, h_wb, h_lg, h_cc,
                       r_ns, r_rp, r_rd, r_lg,
                       l_ns, l_rq, l_rd, l_ht, rsp, moesi)


MINIMAL = bake(moesi=False)
FULL = bake(moesi=True)


# ---------------------------------------------------------------------------
# Protocol subsets (paper §3.4): the customization lattice.
#
# ECI's headline feature is that the protocol is *meant to be subsetted* per
# application.  A subset is a mask over message types and local ops;
# legality is governed by requirement 5 ("an implementation must support all
# transitions the partner may signal, unless it can be guaranteed these
# won't be generated") — so a subset is only sound relative to a *workload
# guarantee* (e.g. read-only).  The lattice members live HERE (next to the
# tables they mask) so that ``bake_mn`` below can bake per-subset N-remote
# tables without a circular import; ``core.specialize`` re-exports them and
# keeps the model-checking/metrics front-end.
# ---------------------------------------------------------------------------


#: Local ops admitted by the N-remote envelope: DEMOTE (transition 7) is
#: excluded — the op set of the ``MultiNodeRef`` oracle, a sound subset
#: under requirement 5 (the workload guarantees no VOL_DOWNGRADE_S is ever
#: generated, so the MN home need not support it).
MN_LOCAL_OPS = frozenset({LocalOp.NOP, LocalOp.LOAD, LocalOp.STORE,
                          LocalOp.EVICT})


@dataclasses.dataclass(frozen=True)
class ProtocolSubset:
    """A named subset of the ECI envelope.

    ``name`` doubles as the key of the baked-table / compiled-program
    caches (``bake_mn``, the engines' jitted steps), so custom subsets must
    use a name distinct from the built-in lattice members'.
    """

    name: str
    tables: DenseTables
    #: messages the REMOTE may send (requirement 5 for the home side)
    remote_may_send: FrozenSet[int]
    #: messages the HOME may send
    home_may_send: FrozenSet[int]
    #: local ops the application may issue
    local_ops: FrozenSet[int]
    #: the home tracks no per-line state (§3.4 final simplification)
    stateless_home: bool = False

    def allowed_ops(self, n_remotes: int = 1) -> FrozenSet[int]:
        """The op codes this subset admits on an ``n_remotes`` engine —
        one LocalOp encoding feeds both engines; the N-remote envelope
        additionally excludes DEMOTE (``MN_LOCAL_OPS``)."""
        ops = frozenset(self.local_ops) | {int(LocalOp.NOP)}
        if n_remotes > 1:
            ops = ops & frozenset(int(o) for o in MN_LOCAL_OPS)
        return ops

    def check_workload(self, ops, n_remotes: int = 1) -> bool:
        """True iff an op program stays within the subset's guarantee.

        Vectorized — this runs on every public store op and on the traffic
        driver's whole ``[T, R]`` stream / ``[R, W]`` issue window, so a
        python per-element loop would tax the very path the benchmarks
        time.  With ``n_remotes > 1`` the check uses the N-remote op set
        (DEMOTE programs are REJECTED rather than silently dropped by the
        engine — the op encoding is shared, the envelopes are not).
        """
        allowed = self.allowed_ops(n_remotes)
        return bool(np.isin(np.asarray(ops),
                            np.fromiter(allowed, np.int64, len(allowed))
                            ).all())


FULL_MOESI = ProtocolSubset(
    name="full_moesi",
    tables=FULL,
    remote_may_send=frozenset(map(int, (
        M.REQ_READ_SHARED, M.REQ_READ_EXCL, M.REQ_UPGRADE,
        M.VOL_DOWNGRADE_S, M.VOL_DOWNGRADE_I,
        M.RESP_ACK, M.RESP_DATA_DIRTY))),
    home_may_send=frozenset(map(int, (
        M.HOME_DOWNGRADE_S, M.HOME_DOWNGRADE_I,
        M.RESP_DATA, M.RESP_DATA_DIRTY, M.RESP_ACK, M.RESP_NACK))),
    local_ops=frozenset((LocalOp.LOAD, LocalOp.STORE, LocalOp.EVICT,
                         LocalOp.DEMOTE)),
)

ENHANCED_MESI = dataclasses.replace(
    FULL_MOESI, name="enhanced_mesi", tables=MINIMAL)

READ_ONLY = ProtocolSubset(
    name="read_only",
    tables=MINIMAL,
    # Fig. 1(b) read-only: only transitions 1 (upgrade to shared) and 6
    # (voluntary downgrade to invalid) remain.
    remote_may_send=frozenset(map(int, (M.REQ_READ_SHARED,
                                        M.VOL_DOWNGRADE_I, M.RESP_ACK))),
    # home keeps only 'downgrade remote to invalid' (evict clean data).
    home_may_send=frozenset(map(int, (M.HOME_DOWNGRADE_I, M.RESP_DATA,
                                      M.RESP_NACK))),
    local_ops=frozenset((LocalOp.LOAD, LocalOp.EVICT)),
)

STATELESS = ProtocolSubset(
    name="stateless",
    tables=MINIMAL,
    remote_may_send=frozenset(map(int, (M.REQ_READ_SHARED,
                                        M.VOL_DOWNGRADE_I))),
    home_may_send=frozenset(map(int, (M.RESP_DATA,))),
    local_ops=frozenset((LocalOp.LOAD, LocalOp.EVICT)),
    stateless_home=True,
)

SUBSETS: Dict[str, ProtocolSubset] = {
    s.name: s for s in (FULL_MOESI, ENHANCED_MESI, READ_ONLY, STATELESS)
}


# ---------------------------------------------------------------------------
# N-remote (sharer-vector) dense-table extensions (paper §4.1).
#
# The paper's formal specification "covered 4-node NUMA systems"; the tables
# below are its executable superset for one home + up to 64 caching remotes
# (the EWF v2 node-id ceiling — every rule is per-(requester, other-remote),
# so the tables themselves are independent of the remote count).
# The DIRECTORY keeps a per-remote view vector (a full-map sharer directory a
# la Censier-Feautrier, paper ref [10]); a request is granted only after the
# home has fanned out and collected every needed downgrade, so the grant
# tables are keyed on (request msg, home state) alone — the requester's view
# and the other remotes' views are preconditions enforced by the directory's
# needed-downgrade rule (``mn_needed_mask``), checked mechanically by
# ``verify_envelope_mn``.
#
# The N-remote envelope is the MultiNodeRef superset: local ops exclude
# DEMOTE (transition 7), a sound subset under requirement 5 (the workload
# guarantees no VOL_DOWNGRADE_S is ever generated).
# ---------------------------------------------------------------------------


class MnAbsorb:
    """Kinds of payload-absorbing messages the MN home can receive."""

    VOL_I = 0     # voluntary downgrade-to-I from a remote (transitions 4-6)
    REPLY_S = 1   # reply to HOME_DOWNGRADE_S (transition 9)
    REPLY_I = 2   # reply to HOME_DOWNGRADE_I (transition 8)
    N = 3


#: Requests the MN remote may send and the requester view each requires.
MN_REQUEST_VIEW = {
    int(M.REQ_READ_SHARED): int(V.I),
    int(M.REQ_READ_EXCL): int(V.I),
    int(M.REQ_UPGRADE): int(V.S),
}


@dataclasses.dataclass(frozen=True)
class DenseTablesMN:
    """Sharer-vector home tables (gather-friendly), layered on DenseTables.

    Since the protocol-parametric refactor the bake is per-SUBSET, not
    per-mode: the grant tables are masked to the messages the subset's
    remote may send, and the subset's op/message masks plus the
    ``stateless_home`` flag ride along for the engine (``core.engine_mn``
    keys its compiled programs on ``name``).

    grant_*: [N_MSG, N_HOME] — effect of granting a request once its
      downgrade preconditions hold (post-fan-out).
    absorb_*: [MnAbsorb.N, 2, N_HOME] — effect of a downgrade payload
      arriving at the home, indexed by (kind, dirty, home state).
    """

    grant_new_home: np.ndarray    # [msg, home] -> HomeState
    grant_resp: np.ndarray        # [msg, home] -> MsgType of the response
    grant_wb: np.ndarray          # [msg, home] -> write home_buf to backing
    grant_legal: np.ndarray       # [msg, home] -> bool
    grant_view: np.ndarray        # [msg] -> requester RemoteView after grant
    absorb_new_home: np.ndarray   # [kind, dirty, home] -> HomeState
    absorb_to_backing: np.ndarray  # [kind, dirty, home] -> payload->backing
    absorb_to_homebuf: np.ndarray  # [kind, dirty, home] -> payload->home_buf
    base: DenseTables
    moesi: bool
    # -- subset parametrization (the §3.4 lattice, baked) ------------------
    name: str                     # subset name (compiled-program cache key)
    op_ok: np.ndarray             # [LocalOp.N] local op admitted by subset
    remote_send_ok: np.ndarray    # [N_MSG] remote may send
    home_send_ok: np.ndarray      # [N_MSG] home may send
    stateless_home: bool          # home tracks NO per-line state


#: subset name -> baked MN tables (and the subset that produced them).
#: The engines' jitted-step caches key on the NAME, so a name must map to
#: exactly one ProtocolSubset for the life of the process.
_MN_BAKED: Dict[str, DenseTablesMN] = {}
_MN_BAKED_FROM: Dict[str, ProtocolSubset] = {}


def mn_tables(name: str) -> DenseTablesMN:
    """Look up baked MN tables by subset name."""
    return _MN_BAKED[name]


def bake_mn(subset: ProtocolSubset) -> DenseTablesMN:
    """Bake the N-remote grant/absorb tables from a ``ProtocolSubset``.

    The mode (MESI/MOESI) comes from the subset's base tables; the grant
    tables are additionally masked to ``subset.remote_may_send`` so a
    request outside the subset is ILLEGAL at the home (counted in
    ``DirectoryMNState.illegal``) rather than silently granted.  Semantics
    mirror the atomic oracle ``core.multinode.MultiNodeRef`` transition
    for transition — the bisimulation tests in ``tests/test_engine_mn.py``
    and ``tests/test_specialize_mn.py`` hold the two to state/value
    equality per lattice member.  Bakes are memoized by ``subset.name``.
    """
    hit = _MN_BAKED.get(subset.name)
    if hit is not None:
        if _MN_BAKED_FROM[subset.name] is not subset:
            raise ValueError(
                f"subset name {subset.name!r} is already baked for a "
                "different ProtocolSubset — names key the engines' "
                "compiled-program caches; give a custom subset a unique "
                "name")
        return hit
    moesi = subset.tables.moesi
    g_nh = np.zeros((N_MSG, N_HOME), np.int8)
    g_rp = np.full((N_MSG, N_HOME), int(M.RESP_NACK), np.int8)
    g_wb = np.zeros((N_MSG, N_HOME), bool)
    g_lg = np.zeros((N_MSG, N_HOME), bool)
    g_vw = np.zeros((N_MSG,), np.int8)

    rs = int(M.REQ_READ_SHARED)
    re = int(M.REQ_READ_EXCL)
    up = int(M.REQ_UPGRADE)

    # -- READ_SHARED grant (precondition: no remote owner) -----------------
    g_vw[rs] = int(V.S)
    for hs in (H.I, H.S, H.E, H.M, H.O):
        g_lg[rs, int(hs)] = True
        g_rp[rs, int(hs)] = int(M.RESP_DATA)     # requirement 4: always clean
        g_nh[rs, int(hs)] = int(hs)
    g_nh[rs, int(H.E)] = int(H.S)                # EI -> SS
    if moesi:
        g_nh[rs, int(H.M)] = int(H.O)            # transition 10: MI -> (O)S
    else:
        g_nh[rs, int(H.M)] = int(H.S)            # write-through, then share
        g_wb[rs, int(H.M)] = True
    if not moesi:
        g_lg[rs, int(H.O)] = False               # O unreachable in MESI mode

    # -- READ_EXCL / UPGRADE grant (precondition: every other view is I) ---
    for msg, resp in ((re, int(M.RESP_DATA)), (up, int(M.RESP_ACK))):
        g_vw[msg] = int(V.EM)
        for hs in (H.I, H.S, H.E, H.M, H.O):
            g_lg[msg, int(hs)] = True
            g_rp[msg, int(hs)] = resp            # requirement 4: uniform
            g_nh[msg, int(hs)] = int(H.I)        # home gives the line up
            if hs in (H.M, H.O):
                g_wb[msg, int(hs)] = True        # invisible writeback first
        if not moesi:
            g_lg[msg, int(H.O)] = False
    # an UPGRADE implies the requester holds S, so the home cannot hold the
    # line exclusively — (E, S) and (M, S) are not joint states.
    g_lg[up, int(H.E)] = False
    g_lg[up, int(H.M)] = False

    # -- absorb tables ------------------------------------------------------
    a_nh = np.zeros((MnAbsorb.N, 2, N_HOME), np.int8)
    a_bk = np.zeros((MnAbsorb.N, 2, N_HOME), bool)
    a_hb = np.zeros((MnAbsorb.N, 2, N_HOME), bool)
    for kind in range(MnAbsorb.N):
        for dirty in (0, 1):
            for hs in range(N_HOME):
                a_nh[kind, dirty, hs] = hs       # default: home unchanged
    for hs in range(N_HOME):
        # voluntary downgrade-to-I with a dirty payload (remote was M).
        if moesi and hs in (int(H.I), int(H.O)):
            a_nh[MnAbsorb.VOL_I, 1, hs] = int(H.M)   # absorb, stay hidden
            a_hb[MnAbsorb.VOL_I, 1, hs] = True
        else:
            a_bk[MnAbsorb.VOL_I, 1, hs] = True       # write-through
        # dirty reply to a recall-to-shared (owner was M).
        if moesi:
            a_nh[MnAbsorb.REPLY_S, 1, hs] = int(H.O)  # hidden-O (req. 4)
            a_hb[MnAbsorb.REPLY_S, 1, hs] = True
        else:
            a_nh[MnAbsorb.REPLY_S, 1, hs] = int(H.S)  # write back, keep copy
            a_hb[MnAbsorb.REPLY_S, 1, hs] = True
            a_bk[MnAbsorb.REPLY_S, 1, hs] = True
        # dirty reply to an invalidation: write-through in BOTH modes (the
        # line is about to be granted exclusively; nothing stays at home).
        a_bk[MnAbsorb.REPLY_I, 1, hs] = True

    # -- subset masks -------------------------------------------------------
    # requests outside the subset's remote_may_send are illegal at the home
    # (requirement 5 is checked the OTHER way by verify_envelope_mn: every
    # message the remote MAY send must be grantable).
    r_ok = np.zeros((N_MSG,), bool)
    for m_ in subset.remote_may_send:
        r_ok[int(m_)] = True
    h_ok = np.zeros((N_MSG,), bool)
    for m_ in subset.home_may_send:
        h_ok[int(m_)] = True
    for m_ in MN_REQUEST_VIEW:
        if not r_ok[m_]:
            g_lg[m_, :] = False
    o_ok = np.zeros((LocalOp.N,), bool)
    for o_ in subset.allowed_ops(n_remotes=2):
        o_ok[int(o_)] = True

    t = DenseTablesMN(g_nh, g_rp, g_wb, g_lg, g_vw, a_nh, a_bk, a_hb,
                      subset.tables, moesi,
                      name=subset.name, op_ok=o_ok,
                      remote_send_ok=r_ok, home_send_ok=h_ok,
                      stateless_home=subset.stateless_home)
    _MN_BAKED[subset.name] = t
    _MN_BAKED_FROM[subset.name] = subset
    return t


MN_MINIMAL = bake_mn(ENHANCED_MESI)
MN_FULL = bake_mn(FULL_MOESI)
MN_READ_ONLY = bake_mn(READ_ONLY)
MN_STATELESS = bake_mn(STATELESS)



# ---------------------------------------------------------------------------
# Tables on a device.
# ---------------------------------------------------------------------------


class TorchTables(NamedTuple):
    """One subset's baked tables as tensors on one device.

    Codes stay int8 and masks bool, the dtypes of the reference's
    tables; the engine casts gathered codes to int64 before using them
    as indices."""

    # 2-node tables used by the MN agents: [op|msg, state] -> field
    loc_new_state: torch.Tensor   # [LocalOp.N, N_REMOTE] int8
    loc_request: torch.Tensor     # [LocalOp.N, N_REMOTE] int8
    loc_req_dirty: torch.Tensor   # [LocalOp.N, N_REMOTE] bool
    loc_hit: torch.Tensor         # [LocalOp.N, N_REMOTE] bool
    rem_new_state: torch.Tensor   # [N_MSG, N_REMOTE] int8
    rem_resp: torch.Tensor        # [N_MSG, N_REMOTE] int8
    rem_resp_dirty: torch.Tensor  # [N_MSG, N_REMOTE] bool
    rem_legal: torch.Tensor       # [N_MSG, N_REMOTE] bool
    resp_new_state: torch.Tensor  # [N_MSG, N_MSG] int8 (-1 = illegal)
    # N-remote home tables
    grant_new_home: torch.Tensor  # [N_MSG, N_HOME] int8
    grant_resp: torch.Tensor      # [N_MSG, N_HOME] int8
    grant_wb: torch.Tensor        # [N_MSG, N_HOME] bool
    grant_legal: torch.Tensor     # [N_MSG, N_HOME] bool
    grant_view: torch.Tensor      # [N_MSG] int8
    absorb_new_home: torch.Tensor   # [MnAbsorb.N, 2, N_HOME] int8
    absorb_to_backing: torch.Tensor  # [MnAbsorb.N, 2, N_HOME] bool
    absorb_to_homebuf: torch.Tensor  # [MnAbsorb.N, 2, N_HOME] bool
    request_view: torch.Tensor    # [N_MSG] int32: MN_REQUEST_VIEW, 0 elsewhere
    op_ok: torch.Tensor           # [LocalOp.N] bool
    stateless_home: bool
    moesi: bool
    name: str


_DEVICE_TABLES: Dict[Tuple[str, str], TorchTables] = {}


def device_tables(subset: ProtocolSubset, device) -> TorchTables:
    """The subset's baked tables on ``device`` — built once per
    (subset name, device) and cached, never per step."""
    dev = torch.device(device)
    key = (subset.name, str(dev))
    hit = _DEVICE_TABLES.get(key)
    if hit is not None:
        return hit
    mn = bake_mn(subset)
    base = mn.base

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    rv = np.asarray([MN_REQUEST_VIEW.get(i, 0) for i in range(N_MSG)],
                    np.int32)
    tt = TorchTables(
        loc_new_state=t(base.loc_new_state), loc_request=t(base.loc_request),
        loc_req_dirty=t(base.loc_req_dirty), loc_hit=t(base.loc_hit),
        rem_new_state=t(base.rem_new_state), rem_resp=t(base.rem_resp),
        rem_resp_dirty=t(base.rem_resp_dirty), rem_legal=t(base.rem_legal),
        resp_new_state=t(base.resp_new_state),
        grant_new_home=t(mn.grant_new_home), grant_resp=t(mn.grant_resp),
        grant_wb=t(mn.grant_wb), grant_legal=t(mn.grant_legal),
        grant_view=t(mn.grant_view),
        absorb_new_home=t(mn.absorb_new_home),
        absorb_to_backing=t(mn.absorb_to_backing),
        absorb_to_homebuf=t(mn.absorb_to_homebuf),
        request_view=t(rv), op_ok=t(mn.op_ok),
        stateless_home=bool(mn.stateless_home), moesi=bool(mn.moesi),
        name=mn.name)
    _DEVICE_TABLES[key] = tt
    return tt
