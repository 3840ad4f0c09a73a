"""Engine step: device busy time of one fleet step, in ms."""


def read(ctx):
    prof = ctx.get("profile")
    return None if prof is None else prof["device_ms_per_step"]
