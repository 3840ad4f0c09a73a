"""Device: the share of a fleet step's wall time in which no device
operation runs (union of the device records against the host clock, both
over the same profiled runs)."""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or prof["wall_ms_per_step"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_ms_per_step"]
                    / prof["wall_ms_per_step"])
