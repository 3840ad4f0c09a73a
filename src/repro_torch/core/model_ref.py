"""Atomic two-node reference model of the ECI protocol (python oracle).

A copy of ``repro.core.model_ref``: pure Python, kept in the port so
that it carries its own oracle on a machine without JAX.

This is the *functional specification*: a home node and a remote caching
agent over a line space, with every transaction executed atomically (no
in-flight messages).  The vectorized engines must be
observationally equivalent to this model once all its messages retire —
``tests/test_protocol.py`` checks this by bisimulation over random op
programs (hypothesis).

The model also *asserts the coherence invariants on every step*:

* single-writer: remote in M/E  =>  home holds no readable copy (home I);
* value coherence: every readable copy (home buf, remote cache, backing
  store when no dirty copy exists) agrees with the last written value;
* requirement 4: the remote-visible result of any op never depends on
  whether the home is internally in S vs hidden-O.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .messages import MsgType
from .states import HomeState as H
from .states import RemoteState as R


class TwoNodeRef:
    """Reference model.  Values are arbitrary python objects (ints in tests)."""

    def __init__(self, n_lines: int, moesi: bool = True,
                 init: Optional[List[int]] = None):
        self.n = n_lines
        self.moesi = moesi
        self.backing: List[int] = list(init) if init else [0] * n_lines
        self.home_state = [H.I] * n_lines
        self.home_buf: List[Optional[int]] = [None] * n_lines
        self.remote_state = [R.I] * n_lines
        self.remote_cache: List[Optional[int]] = [None] * n_lines
        #: ground truth for invariant checking
        self._truth: List[int] = list(self.backing)
        #: message trace (for the NFA checker / EWF tests)
        self.trace: List[Tuple[str, int]] = []

    # -- helpers ----------------------------------------------------------

    def _t(self, msg: MsgType, line: int) -> None:
        self.trace.append((msg.name, line))

    def _home_value(self, line: int) -> int:
        """The value the home would serve (its copy if cached, else backing)."""
        if self.home_state[line] in (H.S, H.E, H.M, H.O):
            assert self.home_buf[line] is not None
            return self.home_buf[line]
        return self.backing[line]

    def _home_drop(self, line: int) -> None:
        """Home silently drops/writes-back its copy before granting E."""
        if self.home_state[line] in (H.M, H.O):
            self.backing[line] = self.home_buf[line]  # invisible writeback
        self.home_state[line] = H.I
        self.home_buf[line] = None

    # -- remote-initiated transactions ------------------------------------

    def remote_load(self, line: int) -> int:
        """LOAD at the remote.  Transition 1 on miss."""
        rs = self.remote_state[line]
        if rs in (R.S, R.E, R.M):
            return self.remote_cache[line]
        # miss: REQ_READ_SHARED -> home
        self._t(MsgType.REQ_READ_SHARED, line)
        hs = self.home_state[line]
        val = self._home_value(line)
        if hs == H.M:
            if self.moesi:
                self.home_state[line] = H.O      # transition 10, hidden O
            else:
                self.backing[line] = self.home_buf[line]
                self.home_state[line] = H.S
        elif hs == H.E:
            self.home_state[line] = H.S
        self._t(MsgType.RESP_DATA, line)
        self.remote_state[line] = R.S
        self.remote_cache[line] = val
        self._check(line)
        return val

    def remote_store(self, line: int, value: int) -> None:
        """STORE at the remote.  Transitions 2/3 on non-exclusive states."""
        rs = self.remote_state[line]
        if rs == R.M:
            self.remote_cache[line] = value
        elif rs == R.E:
            # recommendation 1: silent E->M upgrade.
            self.remote_state[line] = R.M
            self.remote_cache[line] = value
        elif rs == R.S:
            self._t(MsgType.REQ_UPGRADE, line)
            self._home_drop(line)
            self._t(MsgType.RESP_ACK, line)
            self.remote_state[line] = R.M        # granted E, silent ->M
            self.remote_cache[line] = value
        else:  # R.I
            self._t(MsgType.REQ_READ_EXCL, line)
            hs = self.home_state[line]
            if hs == H.M and self.moesi:
                val = self.home_buf[line]
                self.home_state[line] = H.I
                self.home_buf[line] = None
                self._t(MsgType.RESP_DATA_DIRTY, line)
                self.remote_state[line] = R.M    # ownership transferred
            else:
                val = self._home_value(line)
                self._home_drop(line)
                self._t(MsgType.RESP_DATA, line)
                self.remote_state[line] = R.M    # granted E, silent ->M
            del val  # the store overwrites the fetched line
            self.remote_cache[line] = value
        self._truth[line] = value
        self._check(line)

    def remote_evict(self, line: int) -> None:
        """Voluntary downgrade to I (transitions 4, 5, 6).  No reply."""
        rs = self.remote_state[line]
        if rs == R.I:
            return
        dirty = rs == R.M
        self._t(MsgType.VOL_DOWNGRADE_I, line)
        if dirty:
            if self.moesi and self.home_state[line] in (H.I, H.O):
                # home absorbs the dirty line (MI)
                self.home_buf[line] = self.remote_cache[line]
                self.home_state[line] = H.M
            else:
                self.backing[line] = self.remote_cache[line]
        else:
            if self.home_state[line] == H.O:
                self.home_state[line] = H.M      # sole dirty owner now
        self.remote_state[line] = R.I
        self.remote_cache[line] = None
        self._check(line)

    def remote_demote(self, line: int) -> None:
        """Voluntary downgrade to S (transition 7).  No reply."""
        rs = self.remote_state[line]
        if rs not in (R.E, R.M):
            return
        dirty = rs == R.M
        self._t(MsgType.VOL_DOWNGRADE_S, line)
        if dirty:
            if self.moesi:
                self.home_buf[line] = self.remote_cache[line]
                self.home_state[line] = H.O      # hidden O
            else:
                self.backing[line] = self.remote_cache[line]
        self.remote_state[line] = R.S
        self._check(line)

    # -- home-initiated transactions (transitions 8, 9) --------------------

    def home_read(self, line: int) -> int:
        """The home side reads the line (e.g. the owning shard serves an
        operator).  Issues HOME_DOWNGRADE_S if the remote may be dirty."""
        if self.remote_state[line] in (R.E, R.M):
            self._t(MsgType.HOME_DOWNGRADE_S, line)
            if self.remote_state[line] == R.M:
                self._t(MsgType.RESP_DATA_DIRTY, line)
                if self.moesi:
                    self.home_buf[line] = self.remote_cache[line]
                    self.home_state[line] = H.O
                else:
                    self.backing[line] = self.remote_cache[line]
                    self.home_state[line] = H.S
                    self.home_buf[line] = self.backing[line]
            else:
                self._t(MsgType.RESP_ACK, line)
                self.home_state[line] = H.S
                self.home_buf[line] = self.backing[line]
            self.remote_state[line] = R.S
        val = self._home_value(line)
        self._check(line)
        return val

    def home_write(self, line: int, value: int) -> None:
        """The home side writes the line.  Issues HOME_DOWNGRADE_I first."""
        if self.remote_state[line] != R.I:
            self._t(MsgType.HOME_DOWNGRADE_I, line)
            if self.remote_state[line] == R.M:
                self._t(MsgType.RESP_DATA_DIRTY, line)
                if self.moesi:
                    # home absorbs the dirty line without touching RAM.
                    self.home_buf[line] = self.remote_cache[line]
                    self.home_state[line] = H.M
                else:
                    # minimal protocol: write-through to the backing store.
                    self.backing[line] = self.remote_cache[line]
            else:
                self._t(MsgType.RESP_ACK, line)
                if self.home_state[line] == H.S:
                    self.home_state[line] = H.E  # home now has the only copy
                elif self.home_state[line] == H.O:
                    self.home_state[line] = H.M
            self.remote_state[line] = R.I
            self.remote_cache[line] = None
        # write at home: into its buf if cached, else straight to backing.
        if self.home_state[line] in (H.S, H.E, H.M, H.O):
            self.home_buf[line] = value
            self.home_state[line] = H.M
        else:
            self.backing[line] = value
        self._truth[line] = value
        self._check(line)

    # -- invariants --------------------------------------------------------

    def _check(self, line: int) -> None:
        hs, rs = self.home_state[line], self.remote_state[line]
        # joint-state validity
        valid = {
            (H.I, R.I), (H.S, R.I), (H.E, R.I), (H.M, R.I),
            (H.I, R.S), (H.S, R.S), (H.O, R.S),
            (H.I, R.E), (H.I, R.M),
        }
        assert (hs, rs) in valid, f"invalid joint state {hs.name}{rs.name}"
        # single-writer
        if rs in (R.E, R.M):
            assert hs == H.I, "remote exclusive but home holds a copy"
        # value coherence: every readable copy agrees with ground truth
        if rs in (R.S, R.E, R.M):
            assert self.remote_cache[line] == self._truth[line], \
                f"remote cache stale at line {line}"
        if hs in (H.S, H.E, H.M, H.O):
            assert self.home_buf[line] == self._truth[line], \
                f"home buf stale at line {line}"
        # backing store must be current unless a dirty copy exists
        dirty_exists = rs == R.M or hs in (H.M, H.O)
        if not dirty_exists:
            assert self.backing[line] == self._truth[line], \
                f"backing stale at line {line} with no dirty copy"

    def check_all(self) -> None:
        for line in range(self.n):
            self._check(line)
