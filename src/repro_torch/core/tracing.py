"""Trace capture + online NFA protocol checking (paper §4.1).

A framework-free copy of ``repro.core.tracing``: the same ring, specs,
offline checker and powerset compiler, over the port's
``core.messages`` (a ``TraceBuffer`` holds each word as its uint64 value,
a Python int, as the reference's does).

The ECI toolkit checks formal protocol specs against captured traces, both
offline (Wireshark plugin over EWF traces) and online (NFA specs compiled
onto the FPGA, checked at the full 240 Gb/s line rate).  Here:

* ``TraceBuffer`` — a ring of packed EWF words (``core.messages.pack``)
  with JSON export (the paper's serialization format);
* ``NFASpec`` — protocol-property specs as nondeterministic finite automata
  over the message alphabet, written in a tiny declarative language;
* ``check_trace`` — runs a spec over a per-line projection of a trace and
  reports violations (the "machine check with very little information"
  becomes a precise counterexample).

Specs provided (used by the test-suite and the protocol benchmarks):
``SPEC_REQ_RESP`` (every request gets exactly one response before the next
request on that line), ``SPEC_READONLY`` (read-only subsets never carry
upgrade/dirty traffic), ``SPEC_SINGLE_WRITER`` (no second exclusive grant
without an intervening downgrade).
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict, deque
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np

from .messages import (EWF_VERSION, Message, MsgType, pack, pack_v1,
                       to_json, unpack, unpack_v1, word_tensor, word_value)


class TraceBuffer:
    """Ring buffer of packed EWF words (host-side).

    ``ewf_version`` selects the decode layout: new traces are recorded and
    decoded in the current (v2, 6-bit-node) format; pass ``ewf_version=1``
    to decode an archived 2-bit-era trace loaded into ``words``.

    The ring is a ``deque(maxlen=capacity)``: a full buffer drops the
    OLDEST word in O(1).  (The original list-based ring popped index 0 on
    every record past capacity — O(n) per record, quadratic over a full
    2^16-word capture.)  ``words`` stays the public read surface: a list
    in record order, oldest first, exactly as before; assigning to it
    replaces the buffered words (the archived-trace replay path).
    """

    def __init__(self, capacity: int = 1 << 16,
                 ewf_version: int = EWF_VERSION):
        assert ewf_version in (1, 2), f"unknown EWF version {ewf_version}"
        self.capacity = capacity
        self.ewf_version = ewf_version
        self._ring: deque = deque(maxlen=capacity)

    @property
    def words(self) -> List[int]:
        return list(self._ring)

    @words.setter
    def words(self, ws: Iterable[int]) -> None:
        self._ring = deque(ws, maxlen=self.capacity)

    def record(self, msg_type: int, vc: int, has_payload: bool, dirty: bool,
               node: int, line: int, txn: int) -> None:
        packer = pack if self.ewf_version == EWF_VERSION else pack_v1
        w = word_value(packer(msg_type, vc, has_payload, dirty, node, line,
                              txn))
        self._ring.append(w)      # deque(maxlen) drops the oldest in O(1)

    def record_name_line(self, name: str, line: int) -> None:
        """Convenience for (msg_name, line) traces from the reference model."""
        self.record(int(MsgType[name]), 0, False, False, 0, line, 0)

    def messages(self) -> List[Message]:
        """The words decoded in one pass, as Messages of Python values."""
        if not self._ring:
            return []
        decode = unpack if self.ewf_version == EWF_VERSION else unpack_v1
        cols = [f.tolist() for f in decode(word_tensor(list(self._ring)))]
        return [Message(*row) for row in zip(*cols)]

    def to_json(self) -> str:
        return json.dumps([to_json(m) for m in self.messages()])

    @staticmethod
    def from_pairs(pairs: Iterable[Tuple[str, int]]) -> "TraceBuffer":
        tb = TraceBuffer()
        for name, line in pairs:
            tb.record_name_line(name, line)
        return tb

    @staticmethod
    def from_words(words, capacity: Optional[int] = None) -> "TraceBuffer":
        """Wrap already-packed v2 words (e.g. a device-side EWF ring
        exported by ``traffic.observe``) without re-packing."""
        ws = [int(w) for w in np.asarray(words).astype(np.uint64)]
        tb = TraceBuffer(capacity=capacity or max(len(ws), 1))
        tb.words = ws
        return tb


#: Channel-refined symbol suffix: a ``RESP_ACK``/``RESP_DATA_DIRTY`` that
#: travels on the remote->home response VC pair (``CLASS_REMOTE_RESP``, a
#: reply to a home-initiated downgrade) is a DIFFERENT protocol event from
#: the same message type granted on the home-response VCs — specs that must
#: tell them apart write edges on ``"RESP_ACK@hresp"`` etc.  Symbols
#: without an explicit suffixed edge FALL BACK to the plain-name edge, so
#: specs (and archived traces recorded with vc=0) that never distinguish
#: channels behave exactly as before.
HRESP_SUFFIX = "@hresp"

#: VC class of remote->home downgrade replies (transport.CLASS_REMOTE_RESP;
#: literal here to keep core.tracing import-light).
_HRESP_CLASS = 3


def symbol_of(msg_type: int, vc: int = 0) -> str:
    """Trace symbol for a message: the MsgType name, channel-refined with
    ``@hresp`` for downgrade replies (vc class = CLASS_REMOTE_RESP)."""
    name = MsgType(int(msg_type)).name
    if int(vc) // 2 == _HRESP_CLASS and \
            int(msg_type) in (int(MsgType.RESP_ACK),
                              int(MsgType.RESP_DATA_DIRTY)):
        return name + HRESP_SUFFIX
    return name


@dataclasses.dataclass(frozen=True)
class NFASpec:
    """An NFA over message-type names.

    ``transitions``: (state, symbol) -> set of next states; the special
    symbol ``"*"`` matches any message not matched by an explicit edge.
    A trace VIOLATES the spec iff the NFA's state set ever becomes empty
    (no run can explain the observed message).

    Channel-refined symbols (``"RESP_ACK@hresp"``) resolve in order:
    explicit suffixed edge, then the plain-name edge, then ``"*"`` — so a
    spec that never distinguishes channels is unaffected by refinement.
    """

    name: str
    start: FrozenSet[str]
    transitions: Dict[Tuple[str, str], FrozenSet[str]]

    def step(self, states: Set[str], symbol: str) -> Set[str]:
        nxt: Set[str] = set()
        for s in states:
            nxt |= self.edge(s, symbol)
        return nxt

    def edge(self, state: str, symbol: str) -> FrozenSet[str]:
        """Successor set of one (state, symbol), with suffix fallback."""
        key = (state, symbol)
        if key in self.transitions:
            return self.transitions[key]
        if "@" in symbol:
            base = (state, symbol.split("@", 1)[0])
            if base in self.transitions:
                return self.transitions[base]
        return self.transitions.get((state, "*"), frozenset())


def spec(name: str, start: Sequence[str],
         rules: Sequence[Tuple[str, str, Sequence[str]]]) -> NFASpec:
    """The paper's 'simple language' for NFA specs: a rule list
    (state, symbol, next_states)."""
    table: Dict[Tuple[str, str], FrozenSet[str]] = {}
    for s, sym, nxt in rules:
        table[(s, sym)] = frozenset(nxt) | table.get((s, sym), frozenset())
    return NFASpec(name, frozenset(start), table)


#: Every coherence request on a line is answered before the next request on
#: that line (per-line serialization; voluntary downgrades need no answer).
#: The ``wait`` self-loops cover the N-remote engine's per-transaction
#: fan-out: home-initiated downgrades and their ``@hresp`` replies (and
#: other remotes' voluntary downgrades crossing the parked request) are
#: legal INSIDE an open transaction; a reply on the hresp channel may
#: either be an intermediate fan-out reply (stay in ``wait``) or close a
#: home-transaction recall that opened from ``idle`` — the NFA carries
#: both possibilities and only an inexplicable message empties the set.
SPEC_REQ_RESP = spec(
    "req_resp", ["idle"],
    [
        ("idle", "REQ_READ_SHARED", ["wait"]),
        ("idle", "REQ_READ_EXCL", ["wait"]),
        ("idle", "REQ_UPGRADE", ["wait"]),
        ("idle", "HOME_DOWNGRADE_S", ["wait"]),
        ("idle", "HOME_DOWNGRADE_I", ["wait"]),
        ("idle", "VOL_DOWNGRADE_S", ["idle"]),
        ("idle", "VOL_DOWNGRADE_I", ["idle"]),
        ("wait", "RESP_DATA", ["idle"]),
        ("wait", "RESP_DATA_DIRTY", ["idle"]),
        ("wait", "RESP_ACK", ["idle"]),
        ("wait", "RESP_NACK", ["idle"]),
        # -- N-remote fan-out inside an open transaction --
        ("wait", "HOME_DOWNGRADE_S", ["wait"]),
        ("wait", "HOME_DOWNGRADE_I", ["wait"]),
        ("wait", "VOL_DOWNGRADE_S", ["wait"]),
        ("wait", "VOL_DOWNGRADE_I", ["wait"]),
        ("wait", "RESP_ACK" + HRESP_SUFFIX, ["wait", "idle"]),
        ("wait", "RESP_DATA_DIRTY" + HRESP_SUFFIX, ["wait", "idle"]),
    ])

#: Read-only subsets must never carry exclusive/dirty traffic (req. 5).
SPEC_READONLY = spec(
    "readonly", ["ok"],
    [
        ("ok", "REQ_READ_SHARED", ["ok"]),
        ("ok", "VOL_DOWNGRADE_I", ["ok"]),
        ("ok", "RESP_DATA", ["ok"]),
        ("ok", "RESP_ACK", ["ok"]),
        # anything else (upgrades, dirty responses, home downgrades) has no
        # edge -> state set empties -> violation.
    ])

#: Single-writer: after an exclusive grant, no second exclusive grant (or
#: shared grant) may occur before a downgrade of the holder.  On the
#: N-remote engine a request accepted while the line has an exclusive
#: owner goes through an explicit RECALL phase (``r_*`` states): the home
#: must be seen downgrading the owner (or the owner's voluntary downgrade
#: must cross the request) before the grant — a grant straight out of
#: ``excl`` with no intervening downgrade traffic empties the set, which
#: is exactly the double-exclusive-grant bug the spec exists to catch.
SPEC_SINGLE_WRITER = spec(
    "single_writer", ["shared"],
    [
        ("shared", "REQ_READ_SHARED", ["shared"]),
        ("shared", "RESP_DATA", ["shared"]),
        ("shared", "RESP_DATA_DIRTY", ["shared"]),   # MOESI dirty forward
        ("shared", "RESP_NACK", ["shared"]),
        ("shared", "VOL_DOWNGRADE_I", ["shared"]),
        ("shared", "VOL_DOWNGRADE_S", ["shared"]),
        ("shared", "REQ_READ_EXCL", ["granting"]),
        ("shared", "REQ_UPGRADE", ["granting"]),
        # home may invalidate/demote shared copies (transition 8 from IS/SS)
        ("shared", "HOME_DOWNGRADE_S", ["downgrading"]),
        ("shared", "HOME_DOWNGRADE_I", ["downgrading"]),
        ("granting", "RESP_NACK", ["shared"]),
        ("granting", "RESP_DATA", ["excl"]),
        ("granting", "RESP_DATA_DIRTY", ["excl"]),
        ("granting", "RESP_ACK", ["excl"]),
        # fan-out invalidations + replies inside an exclusive grant
        ("granting", "HOME_DOWNGRADE_S", ["granting"]),
        ("granting", "HOME_DOWNGRADE_I", ["granting"]),
        ("granting", "VOL_DOWNGRADE_S", ["granting"]),
        ("granting", "VOL_DOWNGRADE_I", ["granting"]),
        ("granting", "RESP_ACK" + HRESP_SUFFIX, ["granting"]),
        ("granting", "RESP_DATA_DIRTY" + HRESP_SUFFIX, ["granting"]),
        ("excl", "VOL_DOWNGRADE_S", ["shared"]),
        ("excl", "VOL_DOWNGRADE_I", ["shared"]),
        ("excl", "HOME_DOWNGRADE_S", ["downgrading"]),
        ("excl", "HOME_DOWNGRADE_I", ["downgrading"]),
        # a request accepted against an exclusive owner opens a recall
        ("excl", "REQ_READ_SHARED", ["r_shared"]),
        ("excl", "REQ_READ_EXCL", ["r_excl"]),
        ("excl", "REQ_UPGRADE", ["r_up"]),
        ("downgrading", "RESP_ACK", ["shared"]),
        ("downgrading", "RESP_DATA_DIRTY", ["shared"]),
        # multi-sharer home-side recall: k downgrades, k replies — a reply
        # MAY be the last (close to shared) or an intermediate one
        ("downgrading", "HOME_DOWNGRADE_S", ["downgrading"]),
        ("downgrading", "HOME_DOWNGRADE_I", ["downgrading"]),
        ("downgrading", "VOL_DOWNGRADE_S", ["downgrading"]),
        ("downgrading", "VOL_DOWNGRADE_I", ["downgrading"]),
        ("downgrading", "RESP_ACK" + HRESP_SUFFIX,
         ["downgrading", "shared"]),
        ("downgrading", "RESP_DATA_DIRTY" + HRESP_SUFFIX,
         ["downgrading", "shared"]),
        # recall-for-shared-read: owner drops to S (or its voluntary
        # downgrade crosses the request), then the data grant shares the
        # line
        ("r_shared", "HOME_DOWNGRADE_S", ["r_shared"]),
        ("r_shared", "HOME_DOWNGRADE_I", ["r_shared"]),
        ("r_shared", "VOL_DOWNGRADE_S", ["r_shared"]),
        ("r_shared", "VOL_DOWNGRADE_I", ["r_shared"]),
        ("r_shared", "RESP_ACK" + HRESP_SUFFIX, ["r_shared"]),
        ("r_shared", "RESP_DATA_DIRTY" + HRESP_SUFFIX, ["r_shared"]),
        ("r_shared", "RESP_DATA", ["shared"]),
        ("r_shared", "RESP_DATA_DIRTY", ["shared"]),
        # recall-for-exclusive-read: owner invalidated, new owner granted
        ("r_excl", "HOME_DOWNGRADE_S", ["r_excl"]),
        ("r_excl", "HOME_DOWNGRADE_I", ["r_excl"]),
        ("r_excl", "VOL_DOWNGRADE_S", ["r_excl"]),
        ("r_excl", "VOL_DOWNGRADE_I", ["r_excl"]),
        ("r_excl", "RESP_ACK" + HRESP_SUFFIX, ["r_excl"]),
        ("r_excl", "RESP_DATA_DIRTY" + HRESP_SUFFIX, ["r_excl"]),
        ("r_excl", "RESP_DATA", ["excl"]),
        ("r_excl", "RESP_DATA_DIRTY", ["excl"]),
        ("r_excl", "RESP_NACK", ["excl"]),
        # upgrade racing an exclusive owner: doomed, NACKed, owner keeps
        ("r_up", "HOME_DOWNGRADE_S", ["r_up"]),
        ("r_up", "HOME_DOWNGRADE_I", ["r_up"]),
        ("r_up", "VOL_DOWNGRADE_S", ["r_up"]),
        ("r_up", "VOL_DOWNGRADE_I", ["r_up"]),
        ("r_up", "RESP_ACK" + HRESP_SUFFIX, ["r_up"]),
        ("r_up", "RESP_NACK", ["excl"]),
    ])


@dataclasses.dataclass
class Violation:
    spec: str
    line: int
    position: int
    symbol: str
    states_before: FrozenSet[str]

    def __str__(self) -> str:
        return (f"[{self.spec}] line {self.line} pos {self.position}: "
                f"'{self.symbol}' not allowed from {set(self.states_before)}")


def check_trace(nfa: NFASpec, trace: TraceBuffer) -> List[Violation]:
    """Run the spec over each line's message subsequence (per-line
    projection, as coherence is a per-line protocol).  Symbols are
    channel-refined (``symbol_of``): traces recorded with real VC ids —
    the engine's in-scan EWF capture — distinguish downgrade replies from
    grants; name-only traces (``record_name_line``, vc=0) see the plain
    names exactly as before."""
    by_line: Dict[int, List[Tuple[int, str]]] = defaultdict(list)
    for pos, m in enumerate(trace.messages()):
        by_line[int(m.line)].append(
            (pos, symbol_of(int(m.msg_type), int(m.vc))))

    violations: List[Violation] = []
    for line, seq in by_line.items():
        states: Set[str] = set(nfa.start)
        for pos, sym in seq:
            nxt = nfa.step(states, sym)
            if not nxt:
                violations.append(Violation(nfa.name, line, pos, sym,
                                            frozenset(states)))
                states = set(nfa.start)  # resync and keep scanning
            else:
                states = nxt
    return violations


# ---------------------------------------------------------------------------
# Online checking: specs compiled to dense powerset transition tables.
#
# The paper compiles NFA specs onto the FPGA and checks them at the full
# 240 Gb/s line rate (§4.1).  Here the same compilation targets the fused
# ``lax.scan`` of the streaming driver: the per-line nondeterministic
# state SET becomes an int32 bitmask, and one dense table maps
# (mask, symbol) -> mask, so an engine step folds the automaton with one
# gather per event site — ``traffic.observe`` runs it inside the scan with
# no host sync.  A mask of 0 is a violation (no run explains the message).
# ---------------------------------------------------------------------------

#: Online symbol universe: MsgType ids 0..15 plain, 16..31 channel-refined
#: (``id - 16`` on the hresp class — see ``symbol_of``).
N_SYMBOLS = 32


def symbol_id(msg_type: int, hresp: bool = False) -> int:
    """Dense symbol id of a (msg_type, on-hresp-channel?) event."""
    return int(msg_type) + (16 if hresp else 0)


def symbol_id_name(sym: int) -> str:
    """Inverse of ``symbol_id`` for counterexample reporting."""
    return symbol_of(sym % 16, _HRESP_CLASS * 2 if sym >= 16 else 0)


#: Symbols that can fire MORE THAN ONCE on one line within one engine step
#: (fan-out downgrades delivered to k remotes at once, their k replies,
#: concurrent voluntary downgrades).  The online checker applies each
#: distinct symbol once per (site, step), so compiled specs must be
#: IDEMPOTENT on these — ``compile_spec`` verifies it over every
#: reachable mask and refuses the spec otherwise.
REPEATABLE_SYMBOLS = (
    symbol_id(int(MsgType.HOME_DOWNGRADE_S)),
    symbol_id(int(MsgType.HOME_DOWNGRADE_I)),
    symbol_id(int(MsgType.VOL_DOWNGRADE_S)),
    symbol_id(int(MsgType.VOL_DOWNGRADE_I)),
    symbol_id(int(MsgType.RESP_ACK), hresp=True),
    symbol_id(int(MsgType.RESP_DATA_DIRTY), hresp=True),
)


@dataclasses.dataclass(frozen=True)
class CompiledSpec:
    """A spec lowered to a dense powerset transition table.

    ``table[mask, sym]`` is the successor bitmask; 0 = violation (the
    checker resyncs to ``start_mask``, mirroring ``check_trace``).
    """

    name: str
    states: Tuple[str, ...]          # bit i of a mask = states[i]
    start_mask: int
    table: np.ndarray                # [2^S, N_SYMBOLS] int32

    def mask_states(self, mask: int) -> FrozenSet[str]:
        return frozenset(s for i, s in enumerate(self.states)
                         if mask >> i & 1)


def compile_spec(nfa: NFASpec, max_states: int = 14) -> CompiledSpec:
    """Lower ``nfa`` to a dense powerset table over the online alphabet."""
    states = sorted({s for s, _ in nfa.transitions}
                    | {t for ts in nfa.transitions.values() for t in ts}
                    | set(nfa.start))
    S = len(states)
    assert S <= max_states, \
        f"spec '{nfa.name}': {S} states > {max_states} (table is 2^S rows)"
    bit = {s: 1 << i for i, s in enumerate(states)}

    # per-state successor masks over the dense alphabet
    succ = np.zeros((S, N_SYMBOLS), np.int32)
    for i, s in enumerate(states):
        for sym in range(N_SYMBOLS):
            m = 0
            for t in nfa.edge(s, symbol_id_name(sym)):
                m |= bit[t]
            succ[i, sym] = m

    table = np.zeros((1 << S, N_SYMBOLS), np.int32)
    for mask in range(1, 1 << S):
        acc = np.zeros((N_SYMBOLS,), np.int32)
        m = mask
        while m:
            i = (m & -m).bit_length() - 1
            acc |= succ[i]
            m &= m - 1
        table[mask] = acc

    start_mask = 0
    for s in nfa.start:
        start_mask |= bit[s]

    # idempotence on repeatable symbols, over every reachable mask — the
    # checker collapses same-step repetitions of these to one application.
    reachable, frontier = {start_mask}, [start_mask]
    while frontier:
        m = frontier.pop()
        for sym in range(N_SYMBOLS):
            n = int(table[m, sym]) or start_mask   # violation resync
            if n not in reachable:
                reachable.add(n)
                frontier.append(n)
    for m in reachable:
        for sym in REPEATABLE_SYMBOLS:
            once = int(table[m, sym])
            if once and int(table[once, sym]) != once:
                raise ValueError(
                    f"spec '{nfa.name}' not idempotent on repeatable "
                    f"symbol {symbol_id_name(sym)} from "
                    f"{sorted(states[i] for i in range(S) if m >> i & 1)}")
    return CompiledSpec(nfa.name, tuple(states), start_mask, table)


#: The shipped specs by name — the online checker's menu
#: (``traffic.observe`` compiles from here; names key the jit cache).
SPECS: Dict[str, NFASpec] = {
    "req_resp": SPEC_REQ_RESP,
    "readonly": SPEC_READONLY,
    "single_writer": SPEC_SINGLE_WRITER,
}
