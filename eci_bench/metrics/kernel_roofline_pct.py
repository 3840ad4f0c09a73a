"""Step kernels: the least time of the kernel records the trace kept over
their summed device time.  A kernel's records each count at the mean
bound of its launches in one step (``roofline.step_launches``)."""
from eci_bench import roofline


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    per: dict = {}
    for name, nbytes, nops in ctx["launches"]:
        n, s = per.get(name, (0, 0.0))
        per[name] = (n + 1, s + roofline.bound_s((name, nbytes, nops)))
    bound, took = 0.0, 0.0
    for name, (records, us) in prof["kernel_records"].items():
        if name in per and records:
            n, s = per[name]
            bound += records * s / n
            took += us * 1e-6
    return 100.0 * bound / took if took > 0 else None
