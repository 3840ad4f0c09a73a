"""Driver loop: memory the step loop allocates beyond what it starts
with (the stacked states and workloads), in GiB: the allocator's peak
inside the program's ``fleet.loop`` span less the bytes allocated at its
entry."""
from eci_bench import program_spans


def read(ctx):
    figs = program_spans.read(ctx)
    loop = None if figs is None else figs["fleet"].get("fleet.loop")
    if loop is None or loop["mem_peak_bytes"] is None:
        return None
    return (loop["mem_peak_bytes"] - loop["mem_entry_bytes"]) / 2 ** 30
