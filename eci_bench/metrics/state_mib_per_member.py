"""Engine state: bytes of one member's state tensors, in MiB."""


def read(ctx):
    n = ctx.get("state_bytes_per_member")
    return None if not n else n / 2 ** 20
