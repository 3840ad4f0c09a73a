"""The port's spans (``repro_torch.spans``): off, a shared no-op that
records nothing and never enters a profiler range; on, names, parents and
self times by hand-made code, a stack per thread, device mode's shared
events and memory figures (a stand-in for the card); and with spans on in
either mode, streams and fleets bit-identical to spans off."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import convert, spans
from repro_torch.traffic import (EngineConfig, FleetConfig, StreamConfig,
                                 WorkloadSpec, run_fleet, run_stream)

STEP_SPANS = ("driver.window", "engine.step", "driver.retire",
              "driver.slide", "driver.counters", "engine.deliver",
              "engine.arbitrate", "engine.fanout", "engine.grant",
              "engine.respond", "engine.submit")


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()
    torch.set_num_threads(n)


class _Event:
    """A CUDA event's stand-in: stamped with the fake card's clock."""

    def __init__(self, card):
        self.t = card.now
        card.events += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Card:
    """``spans._Device``'s stand-in: a clock in ms the test moves, and an
    allocator whose figures the test sets."""

    def __init__(self):
        self.now, self.events, self.syncs = 0.0, 0, 0
        self.allocated_bytes, self.peak_bytes = 0, 0

    def event(self):
        return _Event(self)

    def synchronize(self):
        self.syncs += 1

    def allocated(self):
        return self.allocated_bytes

    def reset_peak(self):
        self.peak_bytes = self.allocated_bytes

    def peak(self):
        return self.peak_bytes


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(spans, "_Device", lambda: c)
    return c


@pytest.fixture
def clock(monkeypatch):
    now = [0]
    monkeypatch.setattr(spans, "_clock", lambda: now[0])
    return now


def test_off_is_one_shared_noop_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("a") is spans.span("b", flush=True)
    with spans.span("a"):
        with spans.span("b"):
            pass
    run_stream(EngineConfig(remotes=2, lines=8).build("cpu"),
               StreamConfig(workload=WorkloadSpec("zipfian", ops=2, seed=1)))
    assert spans.summary() == {}


def test_nesting_parents_and_self_time(clock):
    spans.enable()
    with spans.span("outer"):                # 0 .. 100
        clock[0] = 10
        with spans.span("inner"):            # 10 .. 40
            clock[0] = 40
        clock[0] = 50
        with spans.span("inner"):            # 50 .. 70
            clock[0] = 60
            with spans.span("leaf"):         # 60 .. 65
                clock[0] = 65
            clock[0] = 70
        clock[0] = 100
    s = spans.summary()
    assert set(s) == {"outer", "inner", "leaf"}
    assert (s["outer"]["parent"], s["inner"]["parent"],
            s["leaf"]["parent"]) == (None, "outer", "inner")
    assert (s["outer"]["calls"], s["inner"]["calls"]) == (1, 2)
    assert s["outer"]["host_s"] == pytest.approx(100e-9)
    assert s["outer"]["self_s"] == pytest.approx(50e-9)
    assert s["inner"]["host_s"] == pytest.approx(50e-9)
    assert s["inner"]["self_s"] == pytest.approx(45e-9)
    assert s["leaf"]["self_s"] == pytest.approx(5e-9)
    assert s["outer"]["device_ms"] is None
    assert s["outer"]["mem_peak_bytes"] is None
    spans.reset()
    assert spans.summary() == {}


def test_each_thread_keeps_its_own_stack():
    spans.enable()
    both = threading.Barrier(2, timeout=30)

    def run(tag):
        with spans.span(f"{tag}.outer"):
            both.wait()        # both outers are open before any inner
            with spans.span(f"{tag}.inner"):
                both.wait()

    threads = [threading.Thread(target=run, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    s = spans.summary()
    for tag in "ab":
        assert s[f"{tag}.outer"]["parent"] is None
        assert s[f"{tag}.inner"]["parent"] == f"{tag}.outer"


def test_device_mode_shares_events_and_reads_memory(card, clock):
    spans.enable(device=True)
    card.allocated_bytes = 1000
    with spans.span("fleet.loop", flush=True):   # card 0 .. 10
        with spans.span("phase.a"):              # card 0 .. 3
            card.now = 3.0
            card.peak_bytes = 5000
        card.now = 4.0                           # counts to phase.b
        with spans.span("phase.b"):              # card 3 .. 9
            card.now = 9.0
        card.now = 10.0
    # one event at the loop's start and one at each span's end.
    assert card.events == 4 and card.syncs == 1
    s = spans.summary()
    assert s["phase.a"]["device_ms"] == pytest.approx(3.0)
    assert s["phase.b"]["device_ms"] == pytest.approx(6.0)
    assert s["fleet.loop"]["device_ms"] == pytest.approx(10.0)
    assert s["fleet.loop"]["self_ms"] == pytest.approx(1.0)
    assert s["fleet.loop"]["mem_entry_bytes"] == 1000
    assert s["fleet.loop"]["mem_peak_bytes"] == 5000
    assert s["phase.a"]["mem_peak_bytes"] is None


def test_device_mode_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        spans.enable(device=True)
    assert spans.span("a") is spans.span("b")


def _run_flat(run):
    return {"state": convert.flatten(convert.engine_state_to_numpy(
                run.state)),
            "counters": [np.asarray(x) for x in run.counters],
            "msg_count": run.msg_count, "payload": run.payload_msgs,
            "retire": run.trace.retire_step, "completed": run.completed}


def _assert_same(a, b):
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    for x, y in zip(a["counters"], b["counters"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["msg_count"], b["msg_count"])
    np.testing.assert_array_equal(a["retire"], b["retire"])
    assert (a["payload"], a["completed"]) == (b["payload"], b["completed"])


def _traced(card, mode, fn):
    """``fn()`` with spans off, host mode or device mode (the stand-in
    card), and the summary it left."""
    if mode == "host":
        spans.enable()
    elif mode == "device":
        spans.enable(device=True)
    try:
        out = fn()
    finally:
        spans.disable()
    s = spans.summary()
    spans.reset()
    return out, s


@pytest.mark.parametrize("kw", [{}, {"packed": True}, {"homes": 2}],
                         ids=["dense", "packed", "homes2"])
def test_stream_is_bit_identical_with_spans_on(card, kw):
    eng = EngineConfig(remotes=4, lines=16, **kw).build("cpu")
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=6, seed=5),
                       width=2, collect_trace=True)
    runs = {}
    for mode in ("off", "host", "device"):
        run, s = _traced(card, mode, lambda: run_stream(eng, cfg))
        runs[mode] = _run_flat(run)
        if mode == "off":
            assert s == {}
            continue
        steps = s["engine.step"]["calls"]
        assert steps > 0 and all(s[n]["calls"] == steps for n in STEP_SPANS)
        assert s["engine.arbitrate"]["parent"] == "engine.step"
        assert (s["engine.step"]["device_ms"] is None) == (mode == "host")
    assert runs["off"]["completed"]
    _assert_same(runs["off"], runs["host"])
    _assert_same(runs["off"], runs["device"])


def test_fleet_is_bit_identical_with_spans_on(card):
    fleet = FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=16, packed=p),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=4, seed=s),
                      width=w, collect_trace=True))
        for r, w, s, p in ((2, 1, 1, False), (4, 2, 2, False),
                           (3, 1, 3, False))))
    runs = {}
    for mode in ("off", "host", "device"):
        out, s = _traced(card, mode, lambda: run_fleet(fleet, device="cpu"))
        runs[mode] = [_run_flat(r) for r in out]
        if mode == "off":
            continue
        assert s["fleet.prepare"]["calls"] == 2
        assert s["fleet.loop"]["calls"] == s["fleet.readout"]["calls"] == 1
        assert s["engine.step"]["parent"] == "fleet.loop"
        assert s["driver.window"]["calls"] == s["engine.step"]["calls"]
        assert (s["fleet.loop"]["mem_peak_bytes"] is None) == \
            (mode == "host")
    for mode in ("host", "device"):
        for a, b in zip(runs["off"], runs[mode]):
            _assert_same(a, b)
