"""Driver loop: device time of one fleet step outside the engine, in ms,
from the program's ``driver.window``, ``driver.retire``, ``driver.slide``
and ``driver.counters`` spans (CUDA events) over a fleet of the
profile's length."""
from eci_bench import program_spans

SPANS = ("driver.window", "driver.retire", "driver.slide",
         "driver.counters")


def read(ctx):
    figs = program_spans.read(ctx)
    if figs is None:
        return None
    parts = [program_spans.per_step(figs["fleet"], s, "device_ms")
             for s in SPANS]
    return None if None in parts else sum(parts)
