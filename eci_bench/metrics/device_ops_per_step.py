"""Engine step: device operations of one fleet step, from the profiler's
device records (each step kernel at the program's launch count)."""


def read(ctx):
    prof = ctx.get("profile")
    return None if prof is None else prof["ops_per_step"]
