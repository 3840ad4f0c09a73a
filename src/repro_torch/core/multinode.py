"""N-node NUMA extension: home directory with a sharer VECTOR.

A copy of ``repro.core.multinode``: pure Python, kept in the port so
that ``traffic.counters.validate_run`` replays a run on the card into
this oracle on a machine without JAX.

The paper's formal specification "was a considerable superset of that
required for [ACCI], and covered 4-node NUMA systems" (§4.1).  This module
implements that superset as an atomic reference model — one home node plus
up to R remote caching agents per line (R <= 64 since the EWF v2 node-id
widening, matching ``engine_mn.MAX_REMOTES``) — with

* a sharers bitmask in the directory (classic full-map directory a la
  Censier-Feautrier, which the paper cites as [10]);
* write-invalidate FAN-OUT: an exclusive grant invalidates every other
  sharer (one HOME_DOWNGRADE_I per sharer — the message-count cost of
  scaling that motivates the paper's subsetting argument);
* the same envelope discipline: silent E->M, voluntary downgrades without
  replies, hidden-O dirty forwarding in MOESI mode.

``tests/test_multinode.py`` checks the invariants (single writer ACROSS
remotes, value coherence, sharer-mask accuracy) with hypothesis, and the
message-count scaling benchmark quantifies the fan-out cost the 2-node
subset avoids.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from .messages import MAX_NODE, MsgType
from .protocol import SUBSETS, LocalOp, ProtocolSubset
from .states import HomeState as H
from .states import RemoteState as R


def home_of(line, n_homes: int):
    """Address-interleaved home assignment: ``line % n_homes``.

    The canonical directory-fabric interleaving (BlackParrot/BedRock,
    classic full-map NUMA directories): consecutive lines round-robin
    across homes, so any contiguous working set spreads evenly.  Works on
    python ints and on numpy/JAX integer arrays alike — the engine and the
    oracle share this one routing function.
    """
    return line % n_homes


#: sentinel distinguishing "no expected value" from an op returning None.
_NO_VALUE = object()


class MultiNodeRef:
    """Atomic reference model: 1 home + ``n_remotes`` caching agents.

    SUBSET-AWARE: pass ``subset`` (a ``ProtocolSubset`` or its name) to
    run the oracle under a §3.4 lattice member.  The oracle then ENFORCES
    the workload guarantee (ops outside the subset raise — the guarantee
    is the application's obligation, and a replayed trace that violates it
    must fail loudly, not silently diverge) and models the specialized
    home: a ``stateless_home`` subset keeps no per-line state, so
    home-side writes are only legal while no remote caches the line.
    The protocol mode (MESI/MOESI) follows the subset's base tables.

    MULTI-HOME AWARE: with ``n_homes > 1`` the oracle ALSO runs one shard
    sub-oracle per home (holding the lines ``home_of`` interleaves there)
    in lockstep with the flat model, asserting message-sequence, return-
    value and per-line state agreement after every op — the executable
    proof that sharding the home plane by address is semantics-invariant,
    which is what the multi-home engine's bisimulation tests lean on.
    """

    def __init__(self, n_lines: int, n_remotes: int = 3, moesi: bool = True,
                 subset: Optional[Union[str, ProtocolSubset]] = None,
                 n_homes: int = 1):
        assert 1 <= n_remotes <= MAX_NODE + 1, \
            "EWF v2 carries 6-bit node ids"
        assert n_homes >= 1, n_homes
        self.n = n_lines
        self.r = n_remotes
        if subset is not None and isinstance(subset, str):
            subset = SUBSETS[subset]
        self.subset = subset
        if subset is not None:
            moesi = subset.tables.moesi
        self.moesi = moesi
        self.backing = [0] * n_lines
        self.home_state = [H.I] * n_lines
        self.home_buf: List[Optional[int]] = [None] * n_lines
        # per-remote state/cache
        self.remote_state = [[R.I] * n_lines for _ in range(n_remotes)]
        self.remote_cache: List[List[Optional[int]]] = [
            [None] * n_lines for _ in range(n_remotes)]
        self._truth = [0] * n_lines
        self.trace: List[Tuple[str, int, int]] = []  # (msg, node, line)
        #: MULTI-HOME mode (``n_homes > 1``): one shard sub-oracle per
        #: home, holding exactly the lines ``home_of`` maps there, run in
        #: LOCKSTEP with the flat model — every public op replays on the
        #: owning shard and the mirror asserts message-for-message and
        #: state-for-state agreement, so a passing run IS an executable
        #: proof that address interleaving is semantics-invariant.
        self.n_homes = n_homes
        self._shards: Optional[List["MultiNodeRef"]] = None
        if n_homes > 1:
            self._shards = [
                MultiNodeRef(len(range(h, n_lines, n_homes)),
                             n_remotes=n_remotes, moesi=moesi,
                             subset=subset)
                for h in range(n_homes)]

    # -- helpers -----------------------------------------------------------

    def _t(self, msg: MsgType, node: int, line: int) -> None:
        self.trace.append((msg.name, node, line))

    def sharers(self, line: int) -> List[int]:
        return [i for i in range(self.r)
                if self.remote_state[i][line] != R.I]

    def owner(self, line: int) -> Optional[int]:
        for i in range(self.r):
            if self.remote_state[i][line] in (R.E, R.M):
                return i
        return None

    def _home_value(self, line: int) -> int:
        if self.home_state[line] != H.I:
            return self.home_buf[line]
        return self.backing[line]

    def _recall_owner(self, line: int, to_shared: bool) -> None:
        """Home-initiated downgrade of the exclusive owner (if any)."""
        o = self.owner(line)
        if o is None:
            return
        msg = MsgType.HOME_DOWNGRADE_S if to_shared else \
            MsgType.HOME_DOWNGRADE_I
        self._t(msg, o, line)
        dirty = self.remote_state[o][line] == R.M
        if dirty:
            self._t(MsgType.RESP_DATA_DIRTY, o, line)
            if self.moesi and to_shared:
                self.home_buf[line] = self.remote_cache[o][line]
                self.home_state[line] = H.O
            else:
                self.backing[line] = self.remote_cache[o][line]
                if to_shared:
                    self.home_state[line] = H.S
                    self.home_buf[line] = self.backing[line]
        else:
            self._t(MsgType.RESP_ACK, o, line)
        self.remote_state[o][line] = R.S if to_shared else R.I
        if not to_shared:
            self.remote_cache[o][line] = None

    def _invalidate_sharers(self, line: int, keep: Optional[int]) -> int:
        """Fan-out invalidation: one message per sharer (the 4-node cost).
        Returns the number of invalidations sent."""
        sent = 0
        for i in range(self.r):
            if i == keep or self.remote_state[i][line] == R.I:
                continue
            self._t(MsgType.HOME_DOWNGRADE_I, i, line)
            if self.remote_state[i][line] == R.M:
                self._t(MsgType.RESP_DATA_DIRTY, i, line)
                self.backing[line] = self.remote_cache[i][line]
            else:
                self._t(MsgType.RESP_ACK, i, line)
            self.remote_state[i][line] = R.I
            self.remote_cache[i][line] = None
            sent += 1
        return sent

    def _guard_op(self, op: int) -> None:
        """Enforce the subset's workload guarantee (requirement 5's other
        half: the home may drop machinery only because THIS never fires)."""
        if self.subset is not None and \
                op not in self.subset.allowed_ops(self.r):
            raise AssertionError(
                f"op {op} outside subset '{self.subset.name}' guarantee")

    # -- the lockstep shard mirror -------------------------------------------

    def _mirror(self, line: int, mark: int, fn, expect=_NO_VALUE) -> None:
        """Replay the op that just ran on the flat model onto the owning
        home's shard sub-oracle and assert full agreement.

        ``mark`` is the flat trace length BEFORE the op; ``fn(shard,
        local_line)`` applies the same op shard-side.  The shard's new
        messages (translated back to global line ids) must equal the flat
        model's, its return value must match ``expect``, and the line's
        entire state (directory + every remote) must coincide."""
        if not self._shards:
            return
        h = home_of(line, self.n_homes)
        loc = line // self.n_homes
        shard = self._shards[h]
        smark = len(shard.trace)
        got = fn(shard, loc)
        if expect is not _NO_VALUE:
            assert got == expect, (
                f"home shard {h} returned {got!r} on line {line}, "
                f"flat model returned {expect!r}")
        sent = [(m, n, l * self.n_homes + h)
                for m, n, l in shard.trace[smark:]]
        assert sent == self.trace[mark:], (
            f"home shard {h} message sequence diverged on line {line}: "
            f"shard {sent} vs flat {self.trace[mark:]}")
        self._assert_shard_line(shard, h, line)

    def _assert_shard_line(self, shard: "MultiNodeRef", h: int,
                           line: int) -> None:
        loc = line // self.n_homes
        ctx = f"home shard {h}, line {line}"
        assert shard.home_state[loc] == self.home_state[line], ctx
        assert shard.home_buf[loc] == self.home_buf[line], ctx
        assert shard.backing[loc] == self.backing[line], ctx
        assert shard._truth[loc] == self._truth[line], ctx
        for i in range(self.r):
            assert shard.remote_state[i][loc] == \
                self.remote_state[i][line], f"{ctx}, remote {i}"
            assert shard.remote_cache[i][loc] == \
                self.remote_cache[i][line], f"{ctx}, remote {i}"

    def per_home_messages(self) -> Dict[int, int]:
        """Message count by owning home — the load-balance view of the
        trace (address interleaving spreads a contiguous working set)."""
        out = {h: 0 for h in range(self.n_homes)}
        for _, _, line in self.trace:
            out[home_of(line, self.n_homes)] += 1
        return out

    # -- remote-initiated transactions ---------------------------------------

    def load(self, node: int, line: int) -> int:
        mark = len(self.trace)
        val = self._load(node, line)
        self._mirror(line, mark, lambda s, loc: s.load(node, loc),
                     expect=val)
        return val

    def store(self, node: int, line: int, value) -> None:
        mark = len(self.trace)
        self._store(node, line, value)
        self._mirror(line, mark, lambda s, loc: s.store(node, loc, value))

    def evict(self, node: int, line: int) -> None:
        mark = len(self.trace)
        self._evict(node, line)
        self._mirror(line, mark, lambda s, loc: s.evict(node, loc))

    def home_read(self, line: int) -> int:
        mark = len(self.trace)
        val = self._home_read(line)
        self._mirror(line, mark, lambda s, loc: s.home_read(loc),
                     expect=val)
        return val

    def home_write(self, line: int, value) -> None:
        mark = len(self.trace)
        self._home_write(line, value)
        self._mirror(line, mark, lambda s, loc: s.home_write(loc, value))

    def _load(self, node: int, line: int) -> int:
        self._guard_op(int(LocalOp.LOAD))
        rs = self.remote_state[node][line]
        if rs != R.I:
            return self.remote_cache[node][line]
        self._t(MsgType.REQ_READ_SHARED, node, line)
        # an exclusive owner elsewhere must be demoted first (transition 9).
        self._recall_owner(line, to_shared=True)
        hs = self.home_state[line]
        val = self._home_value(line)
        if hs == H.M:
            if self.moesi:
                self.home_state[line] = H.O           # transition 10
            else:
                self.backing[line] = self.home_buf[line]
                self.home_state[line] = H.S
        elif hs == H.E:
            self.home_state[line] = H.S
        self._t(MsgType.RESP_DATA, node, line)
        self.remote_state[node][line] = R.S
        self.remote_cache[node][line] = val
        self._check(line)
        return val

    def _store(self, node: int, line: int, value) -> None:
        self._guard_op(int(LocalOp.STORE))
        rs = self.remote_state[node][line]
        if rs in (R.E, R.M):
            self.remote_state[node][line] = R.M       # silent E->M
            self.remote_cache[node][line] = value
        else:
            msg = (MsgType.REQ_UPGRADE if rs == R.S
                   else MsgType.REQ_READ_EXCL)
            self._t(msg, node, line)
            # fan-out: invalidate every other sharer + recall any owner.
            self._recall_owner(line, to_shared=False)
            self._invalidate_sharers(line, keep=node)
            val = self._home_value(line)
            if self.home_state[line] in (H.M, H.O):
                self.backing[line] = self.home_buf[line]
            self.home_state[line] = H.I
            self.home_buf[line] = None
            self._t(MsgType.RESP_ACK if rs == R.S else MsgType.RESP_DATA,
                    node, line)
            del val
            self.remote_state[node][line] = R.M
            self.remote_cache[node][line] = value
        self._truth[line] = value
        self._check(line)

    def _evict(self, node: int, line: int) -> None:
        self._guard_op(int(LocalOp.EVICT))
        rs = self.remote_state[node][line]
        if rs == R.I:
            return
        self._t(MsgType.VOL_DOWNGRADE_I, node, line)
        if rs == R.M:
            if self.moesi and self.home_state[line] in (H.I, H.O):
                self.home_buf[line] = self.remote_cache[node][line]
                self.home_state[line] = H.M
            else:
                self.backing[line] = self.remote_cache[node][line]
        elif self.home_state[line] == H.O and not self.sharers_other(
                line, node):
            self.home_state[line] = H.M
        self.remote_state[node][line] = R.I
        self.remote_cache[node][line] = None
        self._check(line)

    def sharers_other(self, line: int, node: int) -> List[int]:
        return [i for i in self.sharers(line) if i != node]

    # -- home-initiated ------------------------------------------------------

    def _home_read(self, line: int) -> int:
        self._recall_owner(line, to_shared=True)
        val = self._home_value(line)
        self._check(line)
        return val

    def _home_write(self, line: int, value) -> None:
        if self.subset is not None and self.subset.stateless_home:
            # a stateless home tracks no sharers, so it cannot invalidate
            # them — writing while a remote caches the line would be
            # silent incoherence.  Legal only on uncached lines.
            assert not self.sharers(line), \
                "stateless home cannot invalidate cached lines"
            self.backing[line] = value
            self._truth[line] = value
            self._check(line)
            return
        self._recall_owner(line, to_shared=False)
        self._invalidate_sharers(line, keep=None)
        if self.home_state[line] != H.I:
            self.home_buf[line] = value
            self.home_state[line] = H.M
        else:
            self.backing[line] = value
        self._truth[line] = value
        self._check(line)

    # -- invariants ----------------------------------------------------------

    def _check(self, line: int) -> None:
        owners = [i for i in range(self.r)
                  if self.remote_state[i][line] in (R.E, R.M)]
        sharers = self.sharers(line)
        # single writer ACROSS remotes; owner excludes any other sharer.
        assert len(owners) <= 1, f"two owners on line {line}"
        if owners:
            assert sharers == owners, "owner coexists with sharers"
            assert self.home_state[line] == H.I
        # hidden O only while sharers exist
        if self.home_state[line] == H.O:
            assert sharers, "hidden O without sharers"
        # value coherence
        for i in sharers:
            assert self.remote_cache[i][line] == self._truth[line], \
                f"remote {i} stale on line {line}"
        if self.home_state[line] != H.I:
            assert self.home_buf[line] == self._truth[line]
        dirty = any(self.remote_state[i][line] == R.M for i in range(self.r)) \
            or self.home_state[line] in (H.M, H.O)
        if not dirty:
            assert self.backing[line] == self._truth[line]

    def check_all(self) -> None:
        for line in range(self.n):
            self._check(line)
        if self._shards:
            for shard in self._shards:
                shard.check_all()
            for line in range(self.n):
                self._assert_shard_line(
                    self._shards[home_of(line, self.n_homes)],
                    home_of(line, self.n_homes), line)

    def invalidation_messages(self) -> int:
        """Count of fan-out invalidations in the trace — the scaling cost
        the paper's 2-node subsetting avoids."""
        return sum(1 for m, _, _ in self.trace
                   if m == "HOME_DOWNGRADE_I")
