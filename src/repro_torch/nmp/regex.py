"""Regex -> DFA compiler for the regex-filter operator (paper §5.6).

A copy of ``repro.nmp.regex``, which is numpy only: the port keeps its own
so that it never imports ``repro``.  ``tests/test_torch_nmp.py`` holds the
two compilers' tables equal.

The paper integrates an open-source FPGA regex engine (one char/cycle,
fully pipelined) into the memory controller to implement ``REGEXP_LIKE``
filtering.  On TPU the natural equivalent is a table-driven DFA: compile the
pattern once on the host (Thompson NFA -> subset-construction DFA over the
byte alphabet), then run it as a vectorized table walk — one gather per
character per row, fully parallel over rows, which is exactly the
one-cycle-per-character, many-engines-in-parallel structure of the paper's
operator (48 parallel engines there; the row dimension here).

Supported syntax: literals, ``.``, ``\\d \\w \\s`` escapes, ``[...]``/``[^...]``
classes with ranges, grouping ``(...)``, alternation ``|``, and the
quantifiers ``* + ?``.  Matching is *search* semantics (pattern may match
anywhere), as SQL ``REGEXP_LIKE`` requires.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

EPS = -1  # epsilon edge label


@dataclasses.dataclass
class _NFA:
    start: int
    accept: int
    # edges: state -> list of (label, dst); label is EPS or a byte-set id
    edges: Dict[int, List[Tuple[int, int]]]
    # byte-set table: set id -> frozenset of byte values
    sets: List[FrozenSet[int]]


class _Parser:
    """Recursive-descent regex parser building a Thompson NFA."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.n_states = 0
        self.edges: Dict[int, List[Tuple[int, int]]] = {}
        self.sets: List[FrozenSet[int]] = []

    def _new(self) -> int:
        s = self.n_states
        self.n_states += 1
        self.edges[s] = []
        return s

    def _edge(self, src: int, label: int, dst: int) -> None:
        self.edges[src].append((label, dst))

    def _setid(self, byteset: Set[int]) -> int:
        fs = frozenset(byteset)
        self.sets.append(fs)
        return len(self.sets) - 1

    # fragment = (start, accept)
    def parse(self) -> _NFA:
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected '{self.p[self.i]}' at {self.i}")
        return _NFA(frag[0], frag[1], self.edges, self.sets)

    def _alt(self):
        frags = [self._concat()]
        while self.i < len(self.p) and self.p[self.i] == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self._new(), self._new()
        for fs, fa in frags:
            self._edge(s, EPS, fs)
            self._edge(fa, EPS, a)
        return s, a

    def _concat(self):
        frags = []
        while self.i < len(self.p) and self.p[self.i] not in "|)":
            frags.append(self._quant())
        if not frags:
            s = self._new()
            return s, s
        cur = frags[0]
        for nxt in frags[1:]:
            self._edge(cur[1], EPS, nxt[0])
            cur = (cur[0], nxt[1])
        return cur

    def _quant(self):
        frag = self._atom()
        while self.i < len(self.p) and self.p[self.i] in "*+?":
            op = self.p[self.i]
            self.i += 1
            s, a = self._new(), self._new()
            fs, fa = frag
            self._edge(s, EPS, fs)
            if op in "*?":
                self._edge(s, EPS, a)
            self._edge(fa, EPS, a)
            if op in "*+":
                self._edge(fa, EPS, fs)
            frag = (s, a)
        return frag

    _ESCAPES = {
        "d": set(range(ord("0"), ord("9") + 1)),
        "w": (set(range(ord("a"), ord("z") + 1))
              | set(range(ord("A"), ord("Z") + 1))
              | set(range(ord("0"), ord("9") + 1)) | {ord("_")}),
        "s": {ord(c) for c in " \t\n\r\f\v"},
        "n": {ord("\n")}, "t": {ord("\t")}, "r": {ord("\r")},
    }

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            frag = self._alt()
            if self.i >= len(self.p) or self.p[self.i] != ")":
                raise ValueError("unbalanced parenthesis")
            self.i += 1
            return frag
        if c == "[":
            return self._charclass()
        if c == ".":
            self.i += 1
            # byte 0 is the pad terminator of our fixed-width string
            # fields — never matchable (also excluded from [^...]).
            return self._leaf(set(range(1, 256)) - {ord("\n")})
        if c == "\\":
            self.i += 1
            e = self.p[self.i]
            self.i += 1
            if e in self._ESCAPES:
                return self._leaf(set(self._ESCAPES[e]))
            return self._leaf({ord(e)})
        if c in "*+?|)":
            raise ValueError(f"misplaced '{c}' at {self.i}")
        self.i += 1
        return self._leaf({ord(c)})

    def _leaf(self, byteset: Set[int]):
        s, a = self._new(), self._new()
        self._edge(s, self._setid(byteset), a)
        return s, a

    def _charclass(self):
        self.i += 1  # consume [
        neg = self.p[self.i] == "^"
        if neg:
            self.i += 1
        bs: Set[int] = set()
        while self.p[self.i] != "]":
            if self.p[self.i] == "\\":
                self.i += 1
                e = self.p[self.i]
                self.i += 1
                bs |= self._ESCAPES.get(e, {ord(e)})
                continue
            lo = ord(self.p[self.i])
            self.i += 1
            if (self.p[self.i] == "-" and self.p[self.i + 1] != "]"):
                self.i += 1
                hi = ord(self.p[self.i])
                self.i += 1
                bs |= set(range(lo, hi + 1))
            else:
                bs.add(lo)
        self.i += 1  # consume ]
        if neg:
            bs = set(range(1, 256)) - bs   # NUL = pad, never matchable
        return self._leaf(bs)


@dataclasses.dataclass(frozen=True)
class DFA:
    """Dense DFA: transitions [n_states, 256] int32, accept [n_states] bool.

    State 0 is the start state.  Accept states are made ABSORBING so that
    search semantics ("matches anywhere") falls out of a plain left-to-right
    table walk — exactly what the vectorized runner and the Pallas kernel
    execute.
    """

    transitions: np.ndarray
    accept: np.ndarray
    pattern: str

    @property
    def n_states(self) -> int:
        return self.transitions.shape[0]


def compile_regex(pattern: str, max_states: int = 256) -> DFA:
    """Compile ``pattern`` (search semantics) into a dense DFA."""
    nfa = _Parser(pattern).parse()

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for label, dst in nfa.edges[s]:
                if label == EPS and dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        return frozenset(seen)

    start = eclose(frozenset({nfa.start}))
    # search semantics: the start set is sticky (an implicit leading .*) —
    # every step unions the start closure back in (unless already accepted).
    dfa_states: Dict[FrozenSet[int], int] = {start: 0}
    order: List[FrozenSet[int]] = [start]
    rows: List[np.ndarray] = []
    accept: List[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        acc = nfa.accept in cur
        accept.append(acc)
        row = np.zeros((256,), np.int32)
        if acc:
            # absorbing accept state
            rows.append(np.full((256,), dfa_states[cur], np.int32))
            continue
        for byte in range(256):
            nxt: Set[int] = set()
            for s in cur:
                for label, dst in nfa.edges[s]:
                    if label != EPS and byte in nfa.sets[label]:
                        nxt.add(dst)
            tgt = eclose(frozenset(nxt)) | start  # sticky start (search)
            tgt = frozenset(tgt)
            if nfa.accept in tgt:
                # collapse: any accepting set behaves identically (absorbing)
                tgt = frozenset({nfa.accept})
            if tgt not in dfa_states:
                if len(order) >= max_states:
                    raise ValueError(
                        f"DFA for '{pattern}' exceeds {max_states} states")
                dfa_states[tgt] = len(order)
                order.append(tgt)
            row[byte] = dfa_states[tgt]
        rows.append(row)

    return DFA(np.stack(rows), np.asarray(accept, bool), pattern)
