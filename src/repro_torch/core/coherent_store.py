"""CoherentStore: the application-facing API over the ECI stack.

The port of ``repro.core.coherent_store``.  The paper's use case (§5):
the FPGA acts as a *smart memory controller* — the home for a region of
memory — and the CPU reads through its ordinary cache hierarchy; results
of expensive operators land in the consumer's cache and are reused
(Fig. 8).  The store holds

* a **backing region** of ``n_blocks x block`` elements whose home is
  the store;
* one **consumer agent** with a real cache (``n_remotes == 1``, the
  two-node ``core.engine.Engine``, STATELESS home included), or up to 64
  of them kept coherent by the sharer-vector directory (the N-remote
  ``core.engine_mn.EngineMN``); ``read``/``write``/``evict`` then take a
  ``node``;
* an optional **operator** at the home: a read of a block no consumer
  caches and no operator run or write has defined yet computes
  ``operator(block)`` there, once.

The op and value vectors are built on the host with numpy, checked
against the subset's guarantee there (``check_workload``) and copied to
the store's device once per call; each call drains the engine to
quiescence in a host loop (``run_ops``, or a step loop for the home-side
accesses) that reads one flag a round.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .engine import Engine
from .engine_mn import EngineMN
from .messages import MsgType
from .protocol import FULL_MOESI, LocalOp, ProtocolSubset
from .states import RemoteState


class CoherentStore:
    """Block store with coherent consumer-side caches (see the module
    doc).  ``device`` defaults to ``"cuda"``; with no GPU present that
    raises — pass ``device="cpu"`` for the plain path.  Values come back
    as tensors on the store's device."""

    def __init__(self, backing, subset: ProtocolSubset = FULL_MOESI,
                 operator: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None,
                 max_rounds: int = 64, n_remotes: int = 1, device=None):
        self.device = resolve_device(device)
        backing = torch.as_tensor(backing).to(self.device)
        if backing.dim() != 2:
            raise ValueError("backing must be [n_blocks, block]")
        self.subset = subset
        self.n_remotes = n_remotes
        if n_remotes == 1:
            self.engine = Engine(backing, moesi=subset.tables.moesi,
                                 stateless=subset.stateless_home,
                                 device=self.device)
        else:
            # the N-remote engine runs every lattice member, stateless
            # included: the subset's guarantee (no stores, home writes only
            # to uncached lines — see ``home_write``) leaves nothing to
            # invalidate.
            self.engine = EngineMN(backing, n_remotes, subset=subset,
                                   device=self.device)
        self.state = self.engine.init()
        self.n_blocks, self.block = backing.shape
        self.dtype = backing.dtype
        self.operator = operator
        self.max_rounds = max_rounds
        #: interconnect accounting for the paper-figure benchmarks
        self.ops_issued = 0
        #: materialized-generation bit per line: True once the operator's
        #: result (or an explicit write) defines the block's content, so
        #: an evicted virtual block is not fed back through the operator.
        self._materialized = np.zeros(self.n_blocks, bool)

    # -- internal ----------------------------------------------------------

    def _op_vec(self, block_ids: np.ndarray, op: int, node: int
                ) -> np.ndarray:
        """The per-line op vector ([L] or [R, L] int8) for ``block_ids``."""
        if not 0 <= node < self.n_remotes:
            raise ValueError(f"node {node} out of range for "
                             f"n_remotes={self.n_remotes}")
        if self.n_remotes == 1:
            opv = np.zeros(self.n_blocks, np.int8)
            opv[block_ids] = op
        else:
            opv = np.zeros((self.n_remotes, self.n_blocks), np.int8)
            opv[node, block_ids] = op
        return opv

    def _mask(self, block_ids: np.ndarray) -> torch.Tensor:
        """[L] bool on the store's device, set at ``block_ids``."""
        out = torch.zeros(self.n_blocks, dtype=torch.bool,
                          device=self.device)
        out[torch.as_tensor(block_ids, device=self.device)] = True
        return out

    def _val_vec(self, block_ids: np.ndarray, values,
                 node: Optional[int] = None) -> torch.Tensor:
        """Zeros with ``values`` at ``block_ids``, on the store's device:
        ``[L, B]``, or ``[R, L, B]`` with them in row ``node``."""
        ids = torch.as_tensor(block_ids, device=self.device)
        lead = () if node is None else (self.n_remotes,)
        out = torch.zeros(lead + (self.n_blocks, self.block),
                          dtype=self.dtype, device=self.device)
        out[(ids,) if node is None else (node, ids)] = \
            torch.as_tensor(values).to(self.device, self.dtype)
        return out

    def _run_ops(self, opv: np.ndarray, val=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Submit an op vector; run until every op retires.  Returns
        per-line (done, vals) reduced over remotes."""
        # one vectorized pass over the whole op plane; with several remotes
        # the check also rejects ops outside the N-remote envelope.
        if not self.subset.check_workload(opv, n_remotes=self.n_remotes):
            raise ValueError(
                f"op program outside subset '{self.subset.name}' guarantee")
        if val is None:
            val = torch.zeros(opv.shape + (self.block,), dtype=self.dtype,
                              device=self.device)
        st, done, vals, _, still_busy = self.engine.run_ops(
            self.state, torch.from_numpy(opv).to(self.device), val,
            self.max_rounds)
        self.state = st
        if still_busy:
            # raise instead of returning partial results — a silent zero
            # block is indistinguishable from real data.
            raise RuntimeError(
                f"coherent ops did not retire within max_rounds="
                f"{self.max_rounds}; raise max_rounds for deep fan-out/"
                f"contention schedules")
        return done, vals

    def _drain(self, round_fn, what: str) -> None:
        """Run ``round_fn(st) -> (st, still_busy)`` until quiet; raise if
        the budget runs out."""
        st = self.state
        for _ in range(self.max_rounds):
            st, busy = round_fn(st)
            if not busy:
                break
        else:
            self.state = st
            raise RuntimeError(
                f"{what} did not retire within max_rounds="
                f"{self.max_rounds}; raise max_rounds for deep fan-out/"
                f"contention schedules")
        self.state = st

    # -- public API --------------------------------------------------------

    def read(self, block_ids, node: int = 0) -> torch.Tensor:
        """Coherent read of blocks; hits the consumer cache when possible.
        With an operator attached, a block read for the first time is
        ``operator(backing[i])``, computed at the home."""
        block_ids = np.atleast_1d(np.asarray(block_ids))
        if self.operator is not None:
            self._materialize(block_ids)
        opv = self._op_vec(block_ids, int(LocalOp.LOAD), node)
        self.ops_issued += len(block_ids)
        _, vals = self._run_ops(opv)
        return vals[torch.as_tensor(block_ids, device=self.device)]

    def write(self, block_ids, values, node: int = 0) -> None:
        """Coherent write (write-invalidate upgrade at the consumer); with
        several remotes one invalidation per other sharer."""
        block_ids = np.atleast_1d(np.asarray(block_ids))
        opv = self._op_vec(block_ids, int(LocalOp.STORE), node)
        vv = self._val_vec(block_ids, values,
                           None if self.n_remotes == 1 else node)
        self.ops_issued += len(block_ids)
        self._run_ops(opv, vv)
        # an explicit write defines the block's content: the operator must
        # not re-run over it after an evict.
        self._materialized[block_ids] = True

    def evict(self, block_ids, node: int = 0) -> None:
        block_ids = np.atleast_1d(np.asarray(block_ids))
        self._run_ops(self._op_vec(block_ids, int(LocalOp.EVICT), node))

    def home_read(self, block_ids) -> torch.Tensor:
        """Home-side read (forces writeback/demote of dirty consumer
        lines)."""
        block_ids = np.atleast_1d(np.asarray(block_ids))
        want = self._mask(block_ids)
        vals = torch.zeros((self.n_blocks, self.block), dtype=self.dtype,
                           device=self.device)

        def round_fn(st):
            nonlocal want, vals
            st, out = self.engine.step(st, want_read=want)
            want = torch.zeros_like(want)
            vals = torch.where(out.hread_done[:, None], out.hread_val, vals)
            return st, not self.engine.quiescent(st)

        self._drain(round_fn, "home_read")
        return vals[torch.as_tensor(block_ids, device=self.device)]

    def home_write(self, block_ids, values) -> None:
        """Home-side write (invalidates consumer copies first).  A
        STATELESS home tracks no sharers and cannot invalidate, so a
        write to a line some consumer caches is refused."""
        block_ids = np.atleast_1d(np.asarray(block_ids))
        if self.subset.stateless_home and \
                self._cached_lines()[block_ids].any():
            raise ValueError(
                "stateless home cannot invalidate consumer-cached "
                "lines; evict them first or use a stateful subset")
        want = self._mask(block_ids)
        vv = self._val_vec(block_ids, values)

        def round_fn(st):
            nonlocal want
            st, _ = self.engine.step(st, want_write=want, wval=vv)
            want = torch.zeros_like(want)
            return st, not self.engine.quiescent(st)

        self._drain(round_fn, "home_write")
        self._materialized[block_ids] = True

    def _materialize(self, block_ids: np.ndarray) -> None:
        """Run the operator at the home for blocks no consumer caches and
        no operator run or explicit write has defined yet; its source and
        result both move through the coherent home-side accesses."""
        cached = self._cached_lines()
        todo = [int(b) for b in block_ids
                if not cached[b] and not self._materialized[b]]
        if not todo:
            return
        src = self.home_read(todo)
        self.home_write(todo, self.operator(src))

    # -- accounting --------------------------------------------------------

    def _agents(self):
        return self.state.agent if self.n_remotes == 1 else \
            self.state.agents

    def _cached_lines(self) -> np.ndarray:
        """[L] bool — lines held (in any state above I) by ANY consumer."""
        held = self._agents().remote_state.cpu().numpy() != \
            int(RemoteState.I)
        return held if self.n_remotes == 1 else held.any(axis=0)

    @property
    def hits(self) -> int:
        return int(self._agents().hits.sum())

    @property
    def misses(self) -> int:
        return int(self._agents().misses.sum())

    @property
    def interconnect_messages(self) -> Dict[str, int]:
        mc = self.state.msg_count.cpu().numpy()
        return {MsgType(i).name: int(mc[i]) for i in range(16) if mc[i]}

    @property
    def payload_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return int(self.state.payload_msgs) * self.block * itemsize
