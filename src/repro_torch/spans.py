"""Spans: where a sweep's time and memory go, phase by phase.

Tracing is off by default and costs nothing then: ``span(name)`` returns
one shared no-op context manager, and nothing is recorded, timed or
allocated.  It is turned on only by a call.  Someone running a sweep
wraps it so::

    from repro_torch import spans
    from repro_torch.traffic import run_fleet

    spans.enable(device=True)     # or enable() for the host clock only
    runs = run_fleet(fleet)
    spans.disable()
    for name, s in spans.summary().items():
        print(name, s["calls"], s["host_s"], s["self_s"], s["device_ms"])
    spans.reset()

With ``enable()`` each span records its name, its parent (a stack per
thread, so the threads of a ``mesh_devices`` fleet keep their own) and
its start and end on the host clock, and is a
``torch.profiler.record_function`` range: in a profiled run the idle gaps
inside a span and outside any operation carry the span's name.

``enable(device=True)`` adds the card's side.  Each span records a CUDA
event on the current stream at its end, and starts at the event that
ended its previous sibling (or at its parent's start), so the phases of
a step tile the stream: work queued between two siblings counts to the
later one.  Events are read after a synchronise at the end of a span
opened with ``flush=True`` (the fleet's step loop), or by ``summary()``;
the loop itself never waits.  A span's device milliseconds are the
stream's time between its two events, which also counts kernels the
profiler fails to record.  The ``fleet.*`` spans also record the bytes
allocated at entry and the allocator's peak inside the span; each resets
the peak statistic, so read a window's peak before tracing.

``summary()`` gives, per span name: ``calls``, ``parent`` (the name of
its first parent, or None), ``host_s``, ``self_s`` (host time less the
children's), ``device_ms`` and ``self_ms`` (None without device mode),
and for ``fleet.*`` spans under device mode ``mem_entry_bytes`` and
``mem_peak_bytes`` of the call with the highest peak.  Records are
folded into these totals as they close (device records once their
events are read); ``reset()`` clears them.

The spans of the fleet path:

================  ==========================================  ==========
span              covers                                      where
================  ==========================================  ==========
kernels.load      building or loading one kernel library      build.py
fleet.prepare     materialising, checking and building the    fleet.py
                  members; their states made and stacked;
                  workloads to the device (two calls a fleet)
fleet.loop        the step loop (``flush=True``)              fleet.py
fleet.readout     copies to the host, the per-member split    fleet.py
driver.window     window fetch, conflict mask, admission,     driver.py
                  the scatters into dense op planes
engine.step       one engine step (the six below)             driver.py
driver.retire     adoption, retirement, the retirement        driver.py
                  trace, sojourn histograms, observation
driver.slide      the window slide                            driver.py
driver.counters   the hardware-style counters                 driver.py
engine.deliver    home wants, phases 1-3 (ticks, replies and  engine_mn
                  voluntary downgrades absorbed)
engine.arbitrate  phase 4                                     engine_mn
engine.fanout     phase 5                                     engine_mn
engine.grant      phase 6                                     engine_mn
engine.respond    phases 7-8 (grants and home downgrades      engine_mn
                  arrive at the remotes)
engine.submit     phase 9 and the step's new state            engine_mn
================  ==========================================  ==========
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import torch

#: the span a disabled tracer hands out, shared by every call.
_OFF = nullcontext()
#: the host clock, in ns (a module attribute so a test can stand in).
_clock = time.perf_counter_ns


class _Device:
    """The card's side of device mode: CUDA events on the current stream
    and the caching allocator's counters of the current device."""

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("spans.enable(device=True) times spans on a "
                               "CUDA device; none is available")

    @staticmethod
    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def synchronize() -> None:
        torch.cuda.synchronize()

    @staticmethod
    def allocated() -> int:
        return torch.cuda.memory_allocated()

    @staticmethod
    def reset_peak() -> None:
        torch.cuda.reset_peak_memory_stats()

    @staticmethod
    def peak() -> int:
        return torch.cuda.max_memory_allocated()


class _Tracer:
    """The process's records: per-name totals, and per thread the stack of
    open spans, the last event recorded and the records whose events are
    not read yet."""

    def __init__(self):
        self.on = False
        self.device: Optional[_Device] = None
        self.lock = threading.Lock()
        self.local = threading.local()
        self.totals: Dict[str, dict] = {}
        self.waiting: List[List["_Span"]] = []   # one list per thread

    def thread(self):
        loc = self.local
        if not hasattr(loc, "stack"):
            loc.stack, loc.last, loc.waiting = [], None, []
            with self.lock:
                self.waiting.append(loc.waiting)
        return loc

    def fold(self, sp: "_Span") -> None:
        host_s = (sp.t1 - sp.t0) / 1e9
        with self.lock:
            tot = self.totals.get(sp.name)
            if tot is None:
                tot = self.totals[sp.name] = {
                    "calls": 0, "parent": sp.parent and sp.parent.name,
                    "host_s": 0.0, "self_s": 0.0, "device_ms": None,
                    "self_ms": None, "mem_entry_bytes": None,
                    "mem_peak_bytes": None}
            tot["calls"] += 1
            tot["host_s"] += host_s
            tot["self_s"] += host_s - sp.child_ns / 1e9
            if sp.ms is not None:
                tot["device_ms"] = (tot["device_ms"] or 0.0) + sp.ms
                tot["self_ms"] = ((tot["self_ms"] or 0.0) + sp.ms
                                  - sp.child_ms)
            if sp.peak is not None and (tot["mem_peak_bytes"] is None or
                                        sp.peak > tot["mem_peak_bytes"]):
                tot["mem_entry_bytes"] = sp.mem0
                tot["mem_peak_bytes"] = sp.peak

    def read_events(self, waiting: List["_Span"]) -> None:
        """Read the events of ``waiting`` (in the order the spans closed,
        so children before parents) and fold the records."""
        for sp in waiting:
            sp.ev1.synchronize()
            sp.ms = sp.ev0.elapsed_time(sp.ev1)
            if sp.parent is not None:
                sp.parent.child_ms += sp.ms
            self.fold(sp)
        waiting.clear()


_T = _Tracer()


class _Span:
    """One open span; its record once closed."""

    __slots__ = ("name", "flush", "parent", "t0", "t1", "child_ns", "fn",
                 "dev", "ev0", "ev1", "ms", "child_ms", "mem0", "peak")

    def __init__(self, name: str, flush: bool):
        self.name, self.flush = name, flush
        self.child_ns, self.child_ms = 0, 0.0
        self.ev0 = self.ev1 = self.ms = self.mem0 = self.peak = None

    def __enter__(self):
        loc = _T.thread()
        self.parent = loc.stack[-1] if loc.stack else None
        self.dev = dev = _T.device
        if dev is not None:
            if self.name.startswith("fleet."):
                dev.reset_peak()
                self.mem0 = dev.allocated()
            # a span opened inside a device-mode parent starts at the
            # thread's last boundary: the parent's start or a sibling's end.
            if self.parent is None or self.parent.dev is None:
                loc.last = dev.event()
            self.ev0 = loc.last
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        loc.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        loc = _T.thread()
        loc.stack.pop()
        self.fn.__exit__(*exc)
        if self.parent is not None:
            self.parent.child_ns += self.t1 - self.t0
        dev = self.dev
        if dev is None:
            _T.fold(self)
            return
        loc.last = self.ev1 = dev.event()
        if self.mem0 is not None:
            self.peak = dev.peak()
        loc.waiting.append(self)
        if self.flush:
            dev.synchronize()
            _T.read_events(loc.waiting)


def span(name: str, flush: bool = False):
    """A context manager that records ``name`` while tracing is on (the
    shared no-op while it is off).  ``flush``: in device mode, the span's
    exit waits for the card and reads this thread's pending events."""
    if not _T.on:
        return _OFF
    return _Span(name, flush)


def enable(device: bool = False) -> None:
    """Turn tracing on: the host clock and profiler ranges, and with
    ``device`` CUDA events and the allocator's counters (raises without a
    CUDA device)."""
    _T.device = _Device() if device else None
    _T.on = True


def disable() -> None:
    """Turn tracing off; the records stay for ``summary()``."""
    _T.on = False


def summary() -> Dict[str, dict]:
    """The totals per span name (see the module's docstring), after
    reading every pending event."""
    with _T.lock:
        lists = list(_T.waiting)
    for waiting in lists:
        _T.read_events(waiting)
    with _T.lock:
        return {k: dict(v) for k, v in _T.totals.items()}


def reset() -> None:
    """Clear the totals and every pending record."""
    with _T.lock:
        _T.totals.clear()
        for waiting in _T.waiting:
            waiting.clear()
