"""Fleet runner: host seconds of the set-up's warm-up fleet, from its
``fleet.prepare`` span's start to its ``fleet.readout`` span's end (the
three spans tile ``run_fleet``), run as the set-up runs it in a fresh
process."""
from eci_bench import program_spans

SPANS = ("fleet.prepare", "fleet.loop", "fleet.readout")


def read(ctx):
    figs = program_spans.read(ctx)
    if figs is None:
        return None
    spans = figs["warmup"]["spans"]
    if not all(s in spans for s in SPANS):
        return None
    return sum(spans[s]["host_s"] for s in SPANS)
