"""Protocol specialization / subsetting (paper §3.4): the metrics layer.

A copy of ``repro.core.specialize`` (pure python over the protocol
tables).  A subset is a mask over message types and local ops, sound only
relative to a workload guarantee (requirement 5); the lattice members
(``FULL_MOESI``, ``ENHANCED_MESI``, ``READ_ONLY``, ``STATELESS``) live in
``core.protocol`` next to the tables they mask and are re-exported here.

* ``reachable_joint_states`` / ``subset_metrics`` — the 2-node
  state/transition counts of the protocol-size table;
* ``reachable_joint_states_mn`` / ``subset_metrics_mn`` — explicit-state
  model checking of the atomic N-node semantics under the subset's
  guarantee, counting quiescent joint states ``(home, sorted remote
  states)`` up to remote permutation symmetry.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

from .messages import MsgType
from .protocol import (ENHANCED_MESI, FULL_MOESI, MN_LOCAL_OPS,  # noqa: F401
                       READ_ONLY, STATELESS, SUBSETS, LocalOp,
                       ProtocolSubset, bake_mn, build_home_table,
                       build_local_table, subset_reachable_views)
from .states import HomeState as H
from .states import RemoteState as R

M = MsgType


def reachable_joint_states(subset: ProtocolSubset) -> FrozenSet[str]:
    """2-node joint states reachable from II under the subset's traffic.

    Small explicit-state model checking over the python reference tables —
    this is the count the paper's specialization argument is about.
    """
    home = build_home_table(subset.tables.moesi)
    if subset.stateless_home:
        # the home never transitions: the only joint 'state' is I*.
        return frozenset({"I*"})

    frontier = [(int(H.I), int(R.I))]
    seen = set(frontier)
    loc = build_local_table()
    while frontier:
        hs, rs = frontier.pop()
        view = {int(R.I): 0, int(R.S): 1, int(R.E): 2, int(R.M): 2}[rs]
        # remote-initiated
        for op in subset.local_ops:
            row = loc[(int(op), rs)]
            req = row.request
            nxt_r = row.new_remote
            if req == int(M.NOP):
                nxt = (hs, int(nxt_r))
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
                continue
            if req not in subset.remote_may_send:
                continue
            key = (req, hs, view)
            if key not in home or not home[key].legal:
                continue
            hrow = home[key]
            # remote's post-response state
            if req == int(M.REQ_READ_SHARED):
                nr = int(R.S)
            elif req in (int(M.REQ_READ_EXCL), int(M.REQ_UPGRADE)):
                nr = int(R.M) if int(op) == LocalOp.STORE else int(R.E)
            else:  # voluntary downgrades
                nr = int(nxt_r)
            # clean/dirty cases for the home
            for nh in {int(hrow.new_home),
                       int(subset.tables.home_clean_case[req, hs, view])}:
                nxt = (nh, nr)
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        # home-initiated
        for msg in (int(M.HOME_DOWNGRADE_S), int(M.HOME_DOWNGRADE_I)):
            if msg not in subset.home_may_send:
                continue
            key = (msg, hs, view)
            if key not in home or not home[key].legal:
                continue
            hrow = home[key]
            nr = {int(M.HOME_DOWNGRADE_S): int(R.S),
                  int(M.HOME_DOWNGRADE_I): int(R.I)}[msg]
            if rs == int(R.I):
                nr = int(R.I)
            for nh in {int(hrow.new_home),
                       int(subset.tables.home_clean_case[msg, hs, view])}:
                nxt = (nh, nr)
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)

    def name(hs, rs):
        return "ISEMO"[hs] + "ISEM"[rs]

    return frozenset(name(h, r) for h, r in seen)


def subset_metrics(subset: ProtocolSubset) -> Dict[str, int]:
    """State/transition counts for the specialization table (EXPERIMENTS)."""
    states = reachable_joint_states(subset)
    return {
        "joint_states": len(states),
        "remote_msg_types": len(subset.remote_may_send),
        "home_msg_types": len(subset.home_may_send),
        "local_ops": len(subset.local_ops),
        "home_tracks_state": 0 if subset.stateless_home else 1,
    }


# ---------------------------------------------------------------------------
# N-remote joint-state counts: the paper's protocol-size table for N nodes.
# ---------------------------------------------------------------------------


def _mn_atomic_successors(subset: ProtocolSubset, hs: int,
                          rs: Tuple[int, ...]) -> List[Tuple[int,
                                                             Tuple[int, ...]]]:
    """Successors of one canonical N-node state under the subset's traffic.

    Atomic semantics, transition for transition the ``MultiNodeRef``
    oracle's (quiescent states only — the engine's transient E before a
    parked STORE completes never survives to quiescence, which is why the
    atomic model writes stores straight to M).  Home-initiated accesses are
    admitted only when every downgrade they demand is in the subset's
    ``home_may_send`` (the requirement-5 closure).
    """
    moesi = subset.tables.moesi
    ops = subset.allowed_ops(n_remotes=max(len(rs), 2))
    out: List[Tuple[int, Tuple[int, ...]]] = []
    n = len(rs)

    def recall_owner(hs: int, rs: List[int], to_shared: bool) -> int:
        own = [j for j in range(n) if rs[j] in (int(R.E), int(R.M))]
        if not own:
            return hs
        j = own[0]
        dirty = rs[j] == int(R.M)
        if dirty and to_shared:
            hs = int(H.O) if moesi else int(H.S)
        rs[j] = int(R.S) if to_shared else int(R.I)
        return hs

    def emit(hs: int, rs: List[int]) -> None:
        out.append((hs, tuple(sorted(rs))))

    # remote-initiated (one representative per distinct current state —
    # canonical states are permutation classes, so that covers every case)
    for i in range(n):
        if i > 0 and rs[i] == rs[i - 1]:
            continue                          # symmetric to i-1
        if int(LocalOp.LOAD) in ops and rs[i] == int(R.I) and \
                int(M.REQ_READ_SHARED) in subset.remote_may_send:
            h2, r2 = hs, list(rs)
            h2 = recall_owner(h2, r2, to_shared=True)
            if h2 == int(H.M):
                h2 = int(H.O) if moesi else int(H.S)
            elif h2 == int(H.E):
                h2 = int(H.S)
            r2[i] = int(R.S)
            emit(h2, r2)
        if int(LocalOp.STORE) in ops:
            h2, r2 = hs, list(rs)
            if r2[i] in (int(R.E), int(R.M)):
                r2[i] = int(R.M)              # silent E->M
            else:
                h2 = recall_owner(h2, r2, to_shared=False)
                for j in range(n):
                    if j != i:
                        r2[j] = int(R.I)
                h2 = int(H.I)
                r2[i] = int(R.M)
            emit(h2, r2)
        if int(LocalOp.EVICT) in ops and rs[i] != int(R.I) and \
                int(M.VOL_DOWNGRADE_I) in subset.remote_may_send:
            h2, r2 = hs, list(rs)
            if r2[i] == int(R.M):
                if moesi and h2 in (int(H.I), int(H.O)):
                    h2 = int(H.M)
            elif h2 == int(H.O) and not any(
                    r2[j] != int(R.I) for j in range(n) if j != i):
                h2 = int(H.M)
            r2[i] = int(R.I)
            emit(h2, r2)

    # home-initiated accesses (gated by the home_may_send closure)
    owner = any(s in (int(R.E), int(R.M)) for s in rs)
    sharers = any(s != int(R.I) for s in rs)
    if not owner or int(M.HOME_DOWNGRADE_S) in subset.home_may_send:
        h2, r2 = hs, list(rs)
        h2 = recall_owner(h2, r2, to_shared=True)
        emit(h2, r2)                          # home_read
    if not sharers or int(M.HOME_DOWNGRADE_I) in subset.home_may_send:
        h2, r2 = hs, list(rs)
        h2 = recall_owner(h2, r2, to_shared=False)
        r2 = [int(R.I)] * n
        if h2 != int(H.I):
            h2 = int(H.M)
        emit(h2, r2)                          # home_write

    return out


def reachable_joint_states_mn(subset: ProtocolSubset,
                              n_remotes: int) -> FrozenSet[str]:
    """N-node joint states reachable from rest under the subset's traffic.

    States are ``(home state, sorted per-remote states)`` — quiescent
    classes up to remote permutation symmetry, named like ``"I:SSI"``.
    The READ_ONLY subset collapses to the presence-bitmap family
    ``{I:I..I, I:SI..I, ..., I:S..S}`` (n+1 states); STATELESS tracks no
    home state at all and counts as the single ``I*``.
    """
    if subset.stateless_home:
        return frozenset({"I*"})
    start = (int(H.I), tuple([int(R.I)] * n_remotes))
    seen = {start}
    frontier = [start]
    while frontier:
        hs, rs = frontier.pop()
        for nxt in _mn_atomic_successors(subset, hs, rs):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)

    def name(hs, rs):
        return "ISEMO"[hs] + ":" + "".join("ISEM"[s] for s in rs)

    return frozenset(name(h, r) for h, r in seen)


def subset_metrics_mn(subset: ProtocolSubset,
                      n_remotes: int) -> Dict[str, int]:
    """The N-node protocol-size row: joint-state count plus the view-
    vector domain per remote (3 for the full sharer vector, 2 for the
    READ_ONLY presence bitmap, 1 for the stateless home)."""
    views = subset_reachable_views(subset)
    return {
        "n_remotes": n_remotes,
        "joint_states_mn": len(reachable_joint_states_mn(subset,
                                                         n_remotes)),
        "view_domain": 1 if subset.stateless_home else len(views),
        "remote_msg_types": len(subset.remote_may_send),
        "home_msg_types": len(subset.home_may_send),
        "home_tracks_state": 0 if subset.stateless_home else 1,
    }
