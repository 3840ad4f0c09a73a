"""Counters of one traced step: the port's stand-ins for XLA's analyses.

The reference's dry run reads a compiled module's ``cost_analysis()``
(flops, bytes accessed), its ``memory_analysis()`` and the collective
bytes of its HLO.  The port compiles no module.  ``trace_step`` calls the
step once, eagerly, under ``FakeTensorMode`` (tensors with a shape and a
dtype and no storage), on rank 0 of a fake world, and counts op by op
what that rank does:

* **flops**: torch's formulas for matmul-class ops, the registry that
  ``torch.utils.flop_counter.FlopCounterMode`` applies;
* **bytes accessed**: each op's input and output bytes, the rule behind
  XLA's per-op figure; a view (its output aliases an input), a wait on
  a collective and a query that returns no tensor move none;
* **collective bytes** under the reference's five names: the bytes each
  collective writes on this rank (its output, the per-device shard that
  lands on the rank's links: ``analysis.collective_bytes``'s rule), and
  the calls of each;
* **peak memory**: ``torch.distributed._tools.mem_tracker.MemTracker``,
  with the step's arguments tracked as external; the argument and output
  bytes are summed from the rank-local tensors.

Counting is at the level of plain tensors: an op on DTensors is handed
back to DTensor (``NotImplemented``), and the ops it then runs on this
rank's shards are counted; a DTensor op at its global shape never is.
The trace is eager, so every layer and every micro-batch is counted as
it runs.  XLA's ``transcendentals`` and ``generated_code_size_in_bytes``
have no counterpart (an eager trace counts no transcendental apart and
generates no code) and are absent from the port's records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..tree import leaves

#: the reference's collective names (``analysis.collective_bytes``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {
    **dict.fromkeys(("all_gather_into_tensor", "_allgather_base_",
                     "allgather_"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor", "_reduce_scatter_base_",
                     "reduce_scatter_"), "reduce-scatter"),
    **dict.fromkeys(("all_reduce", "allreduce_"), "all-reduce"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_"),
                    "all-to-all"),
    **dict.fromkeys(("send", "recv_"), "collective-permute"),
}
#: ops of the collective namespaces that move no payload.
_NO_PAYLOAD = frozenset(("wait_tensor", "barrier", "monitored_barrier_",
                         "check_for_nan"))
_COMM_NAMESPACES = frozenset(("c10d", "_c10d_functional",
                              "_c10d_functional_autograd"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def local_bytes(tree) -> int:
    """Bytes of the distinct tensors of ``tree`` on this rank (a DTensor's
    local shard)."""
    seen = {id(t): t for t in leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in seen.values())


def _written(func, name: str, args, out) -> list:
    """The tensors a collective writes on this rank: a ``c10d`` op's first
    argument (its output buffers; a send writes none), a functional
    collective's result."""
    if func.namespace == "c10d":
        return [] if name == "send" else _tensors(args[0])
    return _tensors(out)


class OpCounter(TorchDispatchMode):
    """Flops, bytes accessed and collectives of the plain-tensor ops run
    under it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.collective_calls = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        formula = self._flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        name = func._schema.name.split("::")[-1]
        comm = func.namespace in _COMM_NAMESPACES
        if comm and name not in _NO_PAYLOAD:
            if name not in _KIND:
                raise ValueError(f"roofline.count: no HLO name for the "
                                 f"collective {func._schema.name}")
            kind = _KIND[name]
            self.collective_calls[kind] += 1
            self.collective_bytes[kind] += sum(
                _nbytes(t) for t in _written(func, name, args, out))
        # a view, a wait and a query of metadata (no tensor out) move
        # no bytes.
        outs = _tensors(out)
        if outs and not func.is_view and not (comm and name in _NO_PAYLOAD):
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors(list(args))
                + _tensors(list(kwargs.values())) + outs)
        return out


@dataclasses.dataclass
class StepCounts:
    """One traced call of a step on this rank (per device)."""
    flops: int
    bytes_accessed: int
    collective_bytes: Dict[str, int]
    collective_calls: Dict[str, int]
    peak_bytes: int
    argument_bytes: int
    output_bytes: int


def peak_bytes(tracker) -> int:
    """A ``MemTracker``'s peak, summed over its devices."""
    return int(sum(d["Total"] for d in
                   tracker.get_tracker_snapshot("peak").values()))


def trace_step(fn: Callable, make_args: Callable[[], Tuple[Any, ...]]
               ) -> StepCounts:
    """``fn(*make_args())`` once under ``FakeTensorMode``, counted.
    ``make_args`` runs inside the fake mode, so the tensors it makes are
    fake: nothing is allocated and no kernel runs.  Build ``fn`` (its
    process groups, sub-meshes and shardings) before calling this."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    with FakeTensorMode():
        args = make_args()
        tracker = MemTracker()
        tracker.track_external(*[
            t.to_local() if isinstance(t, DTensor) else t
            for t in leaves(list(args)) if isinstance(t, torch.Tensor)])
        counter = OpCounter()
        with tracker, counter:
            out = fn(*args)
        return StepCounts(
            flops=counter.flops, bytes_accessed=counter.bytes_accessed,
            collective_bytes=counter.collective_bytes,
            collective_calls=counter.collective_calls,
            peak_bytes=peak_bytes(tracker),
            argument_bytes=local_bytes(list(args)),
            output_bytes=local_bytes(out))
