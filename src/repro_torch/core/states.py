"""ECI protocol states and the joint-state lattice (paper Fig. 1).

The paper abstracts the ThunderX-1's native MOESI home-based directory protocol
into an "enhanced MESI" envelope:

* The HOME node (the owner of a line's backing store — on Enzian the FPGA for
  FPGA-attached DRAM; here, the shard owning a block of a sharded array) may be
  in one of ``I, S, E, M`` plus a *hidden* ``O`` (dirty-and-shared) state that
  must be indistinguishable from ``S`` to the remote (requirement 4).
* The REMOTE node (the consumer caching the line) implements the 4-state
  protocol of Fig. 1(b): ``I, S, E, M`` with merged views ``*S`` / ``*I``.

Joint states are ordered by the "distance of the data from its at-rest
position" (Fig. 1a).  Transitions may only move up (upgrades) or down
(downgrades) this lattice — never sideways (requirement 1) — with the single
MOESI concession of transition 10 (``MI -> SS/IS``).
"""
from __future__ import annotations

import enum
from typing import Dict, FrozenSet, List, Tuple


class HomeState(enum.IntEnum):
    """Stable states of the home node (directory side)."""

    I = 0  # not cached at home; backing store (DRAM / backing array) is current
    S = 1  # home holds a clean shared copy
    E = 2  # home holds the only copy, clean
    M = 3  # home holds the only copy, dirty
    O = 4  # HIDDEN: home holds a dirty copy while remote holds S (req. 4)


class RemoteState(enum.IntEnum):
    """Stable states of the remote caching agent (Fig. 1b)."""

    I = 0
    S = 1
    E = 2
    M = 3


# What the home can actually *know* about the remote.  The upgrade E->M is
# silent (recommendation 1), so the home's directory can only track I/S/EM.
class RemoteView(enum.IntEnum):
    I = 0
    S = 1
    EM = 2  # remote holds E or M; indistinguishable until a downgrade replies


#: Valid joint (home, remote) stable states, named as in Fig. 1(c).
#: The hidden-O joint state (O, S) is presented to the remote as SS.
JOINT_STATES: FrozenSet[Tuple[HomeState, RemoteState]] = frozenset(
    {
        (HomeState.M, RemoteState.I),  # MI
        (HomeState.O, RemoteState.S),  # hidden-O, appears as SS
        (HomeState.E, RemoteState.I),  # EI
        (HomeState.S, RemoteState.I),  # SI
        (HomeState.S, RemoteState.S),  # SS
        (HomeState.I, RemoteState.S),  # IS
        (HomeState.I, RemoteState.E),  # IE
        (HomeState.I, RemoteState.M),  # IM
        (HomeState.I, RemoteState.I),  # II
    }
)


def joint_name(h: HomeState, r: RemoteState) -> str:
    base = "ISEMO"[{0: 0, 1: 1, 2: 2, 3: 3, 4: 4}[int(h)]]
    return f"{base}{'ISEM'[int(r)]}"


#: Distance-from-rest rank of each joint state (Fig. 1a).  Higher = data
#: further from its at-rest position.  States in the same shaded rectangle of
#: Fig. 1(a) (related only by local/dotted links) share observational class
#: but still have a defined rank for transition legality.
JOINT_RANK: Dict[Tuple[HomeState, RemoteState], int] = {
    (HomeState.I, RemoteState.I): 0,  # II — at rest
    (HomeState.S, RemoteState.I): 1,  # SI — clean copy at home
    (HomeState.E, RemoteState.I): 1,  # EI — local-only difference from SI
    (HomeState.M, RemoteState.I): 2,  # MI — dirty at home
    (HomeState.S, RemoteState.S): 3,  # SS — shared both sides
    (HomeState.O, RemoteState.S): 3,  # hidden-O: indistinguishable from SS
    (HomeState.I, RemoteState.S): 4,  # IS — only remote holds (clean, shared)
    (HomeState.I, RemoteState.E): 5,  # IE — only remote holds, exclusive clean
    (HomeState.I, RemoteState.M): 6,  # IM — only remote holds, dirty
}


#: Observational-equivalence classes as seen FROM THE REMOTE (req. 6/7): the
#: remote must not be able to distinguish these home states.
REMOTE_INDISTINGUISHABLE: List[FrozenSet[Tuple[HomeState, RemoteState]]] = [
    # remote holds S: home may be I, S or hidden-O — all look like "*S"
    frozenset({(HomeState.I, RemoteState.S), (HomeState.S, RemoteState.S),
               (HomeState.O, RemoteState.S)}),
    # remote holds I: home may be I, S, E or M — all look like "*I"
    frozenset({(HomeState.I, RemoteState.I), (HomeState.S, RemoteState.I),
               (HomeState.E, RemoteState.I), (HomeState.M, RemoteState.I)}),
]

#: Observational classes as seen FROM THE HOME.  The home cannot distinguish
#: IM from IE (the E->M upgrade is silent).
HOME_INDISTINGUISHABLE: List[FrozenSet[Tuple[HomeState, RemoteState]]] = [
    frozenset({(HomeState.I, RemoteState.E), (HomeState.I, RemoteState.M)}),
]


def remote_merged_view(h: HomeState, r: RemoteState) -> str:
    """The remote's merged view of a joint state (Fig. 1b): *S, *I, IE, IM."""
    if r == RemoteState.S:
        return "*S"
    if r == RemoteState.I:
        return "*I"
    return joint_name(HomeState.I, r)  # IE / IM — home must be I


def is_upgrade(src: Tuple[HomeState, RemoteState],
               dst: Tuple[HomeState, RemoteState]) -> bool:
    return JOINT_RANK[dst] > JOINT_RANK[src]


def is_downgrade(src: Tuple[HomeState, RemoteState],
                 dst: Tuple[HomeState, RemoteState]) -> bool:
    return JOINT_RANK[dst] < JOINT_RANK[src]
