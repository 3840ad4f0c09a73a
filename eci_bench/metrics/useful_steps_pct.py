"""Driver loop: the steps up to each fleet's last retirement (its slowest
member's) over the step budget, summed over the window's fleets, from the
program's retirement traces."""


def read(ctx):
    last = ctx.get("last_retire")
    if not last:
        return None
    return 100.0 * sum(last) / (ctx["budget"] * len(last))
