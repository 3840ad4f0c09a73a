"""The four metrics read from the program's spans, on hand-made span
summaries; the profiler's mirrored range records dropped from the device
records before the breakdown; and, on the card (marked ``gpu``), the
device-mode spans of a tiny fleet against one pair of CUDA events around
its step loop."""
import json

import pytest
import torch

from eci_bench import harness, program_spans, tinycells, trace

GiB = 2 ** 30


def _span(calls, host_s=0.0, device_ms=None, entry=None, peak=None):
    return {"calls": calls, "parent": None, "host_s": host_s,
            "self_s": host_s, "device_ms": device_ms, "self_ms": device_ms,
            "mem_entry_bytes": entry, "mem_peak_bytes": peak}


FLEET = {"engine.step": _span(48, device_ms=48 * 35.0),
         "driver.window": _span(48, device_ms=48 * 1.5),
         "driver.retire": _span(48, device_ms=48 * 2.0),
         "driver.slide": _span(48, device_ms=48 * 0.25),
         "driver.counters": _span(48, device_ms=48 * 0.75),
         "fleet.loop": _span(1, device_ms=2000.0, entry=14 * GiB,
                             peak=54 * GiB)}
WARMUP = {"up_s": 10.0, "setup_s": 15.0, "spans": {
    "kernels.load": _span(1, 0.25), "fleet.prepare": _span(2, 1.5),
    "fleet.loop": _span(1, 2.0), "fleet.readout": _span(1, 0.5)}}


def _read(name, ctx):
    return harness._metric(harness.HERE.parent, name).read(ctx)


def test_metrics_read_the_span_summaries():
    ctx = {"spans": {"steps": 48, "fleet": FLEET, "warmup": WARMUP}}
    assert _read("engine_ms_per_step", ctx) == pytest.approx(35.0)
    assert _read("driver_ms_per_step", ctx) == pytest.approx(4.5)
    assert _read("loop_scratch_gib", ctx) == pytest.approx(40.0)
    assert _read("warmup_fleet_s", ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("ctx", [
    {"spans": None},
    {"spans": {"steps": 48, "fleet": {}, "warmup": {"spans": {}}}},
    {"spans": {"steps": 48, "fleet": {k: _span(v["calls"])
                                      for k, v in FLEET.items()},
               "warmup": {"spans": {"fleet.loop": _span(1, 2.0)}}}},
], ids=["no_spans", "empty", "host_only"])
def test_metrics_without_their_spans_read_nothing(ctx):
    for name in ("engine_ms_per_step", "driver_ms_per_step",
                 "loop_scratch_gib", "warmup_fleet_s"):
        assert _read(name, ctx) is None


def test_off_the_card_nothing_is_measured(monkeypatch):
    def refuse(*a):
        raise AssertionError("measured without a profile")
    monkeypatch.setattr(program_spans, "measure", refuse)
    ctx = {"cell": None, "budget": 1}
    assert program_spans.read(ctx) is None and ctx["spans"] is None


def test_mirrored_range_records_are_dropped_before_the_breakdown():
    dev = [("engine.step", 0.0, 30.0),                # a range's mirror
           ("elementwise_kernel<where>", 0.0, 10.0),
           ("void arb_winner_kernel(...)", 20.0, 30.0)]
    host = [("engine.step", 0.0, 40.0), ("aten::where", 1.0, 9.0)]
    kept = program_spans.program_device_records(dev, {"engine.step"})
    assert kept == dev[1:]
    assert trace._busy(kept) == 20.0 / 1e6
    assert trace._tally(kept, {"arb_winner": 1})["ops"] == 2
    # the gap between the two kernels lies in the span, outside any op.
    assert trace.breakdown(kept, host)["idle_gaps"] == [
        ["engine.step", 10.0 / 1e6]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_spans_tile_the_step_loop(cuda, tmp_path, monkeypatch):
    from repro_torch import spans
    from repro_torch.traffic import fleet as fleet_mod
    root = tinycells.tiny_root(tmp_path)
    cell = harness.Cell(json.loads((root / "BENCHMARK.json").read_text()),
                        "tiny", root)
    loop, pair = fleet_mod._stream_loop, []

    def timed_loop(*a, **k):
        pair.append(torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = loop(*a, **k)
        pair.append(torch.cuda.Event(enable_timing=True))
        pair[1].record()
        return out

    monkeypatch.setattr(fleet_mod, "_stream_loop", timed_loop)
    fleet = cell.fleet(list(range(cell.M)), steps=48)
    fleet_mod.run_fleet(fleet, device=cuda)           # warm
    pair.clear()
    spans.reset()
    spans.enable(device=True)
    try:
        fleet_mod.run_fleet(fleet, device=cuda)
    finally:
        spans.disable()
    s = spans.summary()
    spans.reset()
    torch.cuda.synchronize()
    want = pair[0].elapsed_time(pair[1])
    got = sum(s[n]["device_ms"] for n in (
        "driver.window", "engine.step", "driver.retire", "driver.slide",
        "driver.counters"))
    assert s["engine.step"]["calls"] == 48
    assert abs(got - want) <= 0.1 * want, (got, want)
    phases = sum(v["device_ms"] for k, v in s.items()
                 if k.startswith("engine.") and k != "engine.step")
    assert abs(phases - s["engine.step"]["device_ms"]) <= \
        0.1 * s["engine.step"]["device_ms"]
