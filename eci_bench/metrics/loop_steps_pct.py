"""Driver loop: the steps one fleet of the cell's members runs, over the
step budget, in %, from the program's ``engine.step`` span (one call a
step).  The fleet runs the whole budget with host-mode spans, on the card
in a traced run and on the CPU elsewhere.  A loop that steps every step
of the budget reads 100; one that stops once every member is quiet reads
its share."""
import importlib.util

import torch


def read(ctx):
    cell = ctx.get("cell")
    if cell is None or \
            importlib.util.find_spec("repro_torch.spans") is None:
        return None
    from repro_torch import spans
    from repro_torch.traffic import run_fleet
    budget = ctx["budget"]
    dev = torch.device("cpu" if ctx.get("profile") is None else "cuda")
    spans.reset()
    spans.enable()
    try:
        run_fleet(cell.fleet(list(range(cell.M)), steps=budget), device=dev)
    finally:
        spans.disable()
    step = spans.summary().get("engine.step")
    spans.reset()
    if not step or not step["calls"]:
        return None
    return 100.0 * step["calls"] / budget
