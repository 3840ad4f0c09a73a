"""Engine step: device time of one fleet step, in ms, from the program's
``engine.step`` span (CUDA events around each ``step_folded`` call, so
the kernels the profiler drops count) over a fleet of the profile's
length."""
from eci_bench import program_spans


def read(ctx):
    figs = program_spans.read(ctx)
    if figs is None:
        return None
    return program_spans.per_step(figs["fleet"], "engine.step", "device_ms")
