"""Sweep fleets: every member of a sweep stepped by ONE loop.

The port of ``repro.traffic.fleet``.  The reference batches a sweep (an
R x W grid, an H in {1, 2, 4} homes sweep) into one ``vmap``ped program
to save a compile per point.  The port has no compile to save; what a
fleet saves on the card is host dispatch: the driver's loop issues each
step's device operations once for all members, on a leading member
axis, where a loop of solo runs would issue them once per member.

What makes the members batchable (``config.FleetConfig`` has the rules):

* **remotes** — every member runs at the fleet's R-max; a narrower
  member pads its workload with NOP columns and its state with idle
  remotes, which are never ready, so arbitration picks the same winners,
  and which drain their NOP streams first, so the active-step accounting
  is untouched;
* **width** — one W-max window; each member's own width caps activation
  and the fresh-slot boundary (``driver._stream_loop``'s ``width_cap``);
* **homes / home_bw** — members ride the engine's flat-layout home
  emulation (``engine_mn.step_folded``'s ``home_group``/``home_bw_t``).

Each member's result is bit-identical to its solo ``run_stream`` at the
fleet's shared step budget (``fleet_steps``).  The loop stops once every
member is quiet (streams consumed, nothing in flight) and adds the steps
it skipped to ``step_no`` and ``counters.steps``, which a quiet state's
steps alone would change: a solo run stops at its own quiescence and
makes the same addition.  ``mesh_devices > 0`` splits the members across
that many CUDA devices, each slice one member-batched loop that stops on
its own; the results come back in member order.

``run_fleet`` returns one ``StreamRun`` per member; its ``state`` is the
member's R-max-padded flat engine state (rows past the member's real
remote count are idle), whose ``step_no`` the members share.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..core.engine_mn import EngineMNState, make_engine_mn_state
from ..device import resolve_device
from ..spans import span
from .config import FleetConfig
from .counters import Counters, RetirementTrace
from .driver import StreamRun, _stream_loop, default_steps
from .workloads import Workload


def fleet_steps(fleet: FleetConfig) -> int:
    """The shared step budget ``run_fleet`` uses — exposed so solo
    comparison runs can pin the SAME budget."""
    if fleet.steps:
        return fleet.steps
    return max(default_steps(s.workload.ops, e.remotes)
               for e, s in fleet.members)


def run_fleet(fleet: FleetConfig, device=None) -> List[StreamRun]:
    """Run every member of the sweep through one member-batched loop on
    ``device`` (default ``"cuda"``; raises without a GPU), or split
    across ``fleet.mesh_devices`` CUDA devices.  Each member's workload
    is materialized at its own ``[T, R_m]`` and checked against its
    protocol subset first."""
    dev = resolve_device(device)
    mesh_n = int(fleet.mesh_devices)
    if mesh_n:
        if dev.type != "cuda":
            raise ValueError(
                f"mesh_devices={mesh_n} splits the fleet across CUDA "
                f"devices; device '{dev}' has none")
        avail = torch.cuda.device_count()
        if mesh_n > avail:
            raise ValueError(f"mesh_devices={mesh_n} but only {avail} "
                             f"CUDA device(s) are visible")
    with span("fleet.prepare"):
        wls = [s.workload.materialize(e.remotes, e.lines)
               for e, s in fleet.members]
    if not mesh_n:
        return _run_members(fleet.members, wls, fleet_steps(fleet), dev)
    slices = [ix for ix in np.array_split(np.arange(len(wls)), mesh_n)
              if len(ix)]

    def run_slice(d, ix):
        torch.cuda.set_device(d)
        return _run_members([fleet.members[i] for i in ix],
                            [wls[i] for i in ix], fleet_steps(fleet),
                            torch.device("cuda", d))

    with ThreadPoolExecutor(len(slices)) as pool:
        parts = list(pool.map(run_slice, range(len(slices)), slices))
    return [run for part in parts for run in part]


def _stack(states: Sequence[EngineMNState]) -> EngineMNState:
    """Member states stacked on a leading axis; ``step_no`` (every member
    starts at 0) stays one shared scalar."""
    def stack(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack(*ys) for ys in zip(*xs)))
        return torch.stack(xs)
    out = stack(*states)
    return out._replace(step_no=states[0].step_no)


def _member(st: EngineMNState, i: int) -> EngineMNState:
    def pick(x):
        if isinstance(x, tuple):
            return type(x)(*(pick(y) for y in x))
        return x if x.dim() == 0 else x[i]
    return pick(st)


def _run_members(members, wls: Sequence[Workload], steps: int,
                 dev: torch.device) -> List[StreamRun]:
    """The fleet on one device, fed each member's ``[T, R_m]`` workload
    arrays (``wls``).  Members' workloads are checked against their
    subsets, padded to R-max with NOP columns and stepped together."""
    with span("fleet.prepare"):
        engines = [e.build(dev) for e, _ in members]
        for eng, (e, _), wl in zip(engines, members, wls):
            if not eng.subset.check_workload(np.asarray(wl.op),
                                             n_remotes=e.remotes):
                raise ValueError(
                    f"fleet member workload outside subset "
                    f"'{eng.subset.name}' guarantee (allowed ops: "
                    f"{sorted(eng.subset.allowed_ops(e.remotes))})")
            if np.asarray(wl.op).shape[1] != e.remotes:
                raise ValueError(f"fleet member workload has "
                                 f"{np.asarray(wl.op).shape[1]} remotes, "
                                 f"engine {e.remotes}")
        for eng in engines[1:]:
            assert torch.equal(eng.delays, engines[0].delays) and \
                torch.equal(eng.credits, engines[0].credits), \
                "fleet members share one delay and credit table"
        R_max = max(e.remotes for e, _ in members)
        W_max = max(s.width for _, s in members)
        T = np.asarray(wls[0].op).shape[0]
        dt = engines[0].init().dir.backing.dtype

        def pad_cols(a):
            a = np.asarray(a)
            out = np.zeros((T, R_max), a.dtype)
            out[:, :a.shape[1]] = a
            return out

        def stacked(field, dtype):
            return torch.as_tensor(np.stack([pad_cols(getattr(w, field))
                                             for w in wls])).to(dtype).to(dev)

        e0, s0 = members[0]
        st = _stack([make_engine_mn_state(
            torch.zeros((e.lines, e.block), dtype=dt, device=dev), R_max,
            packed=e0.packed) for e, _ in members])
        hg = tuple(e.homes for e, _ in members)
        bw = tuple(e.home_bw for e, _ in members)
        emulate = any(h > 1 for h in hg) or any(bw)
        wl_op, wl_line, wl_value = (stacked("op", torch.int8),
                                    stacked("line", torch.int64),
                                    stacked("value", dt))

    with span("fleet.loop", flush=True):
        lp = _stream_loop(
            engines[0], st, wl_op, wl_line, wl_value, steps, W_max,
            collect_trace=s0.collect_trace,
            width_cap=tuple(s.width for _, s in members),
            home_group=hg if emulate else None,
            home_bw_t=bw if emulate else None)

    with span("fleet.readout"):
        completed = lp.completed.cpu().numpy()
        ctr = Counters(*(x.cpu() for x in lp.counters))
        msg_count = lp.state.msg_count.cpu().numpy().astype(np.int64)
        payload = lp.state.payload_msgs.cpu().numpy()
        retire = (lp.retire[..., :-1].transpose(-1, -2).cpu().numpy()
                  if s0.collect_trace else None)
        runs = []
        for i, ((e, s), wl) in enumerate(zip(members, wls)):
            R_m = e.remotes
            # the three per-remote counter planes carry padded rows: slice
            # them off, so the record reads as the solo run's.
            c = Counters(*(x[i] for x in ctr))
            c = c._replace(lat_hist=c.lat_hist[:R_m],
                           max_wait=c.max_wait[:R_m], retired=c.retired[:R_m])
            trace = None
            if s0.collect_trace:
                trace = RetirementTrace(
                    retire_step=retire[i][:, :R_m], op=np.asarray(wl.op),
                    line=np.asarray(wl.line), value=np.asarray(wl.value),
                    n_lines=e.lines)
            runs.append(StreamRun(
                state=_member(lp.state, i), counters=c,
                msg_count=msg_count[i], payload_msgs=int(payload[i]),
                trace=trace, completed=bool(completed[i])))
        return runs
