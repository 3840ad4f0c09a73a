"""``loop_steps_pct`` on the CPU, on the tiny cell: 100 for a fleet whose
budget ends before its members go quiet, under 100 for one that drains;
nothing without a cell."""
import json

import pytest

from eci_bench import harness, tinycells


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tinycells.tiny_root(tmp_path_factory.mktemp("tiny"))
    return harness.Cell(json.loads((root / "BENCHMARK.json").read_text()),
                        "tiny", root)


def _read(ctx):
    return harness._metric(harness.HERE.parent, "loop_steps_pct").read(ctx)


@pytest.mark.parametrize("budget", [2, 0], ids=["short", "drains"])
def test_loop_steps_pct_reads_the_steps_run(cell, budget):
    got = _read({"cell": cell, "budget": budget or cell.steps})
    if budget:
        assert got == 100.0
    else:
        assert 0 < got < 100


def test_loop_steps_pct_without_a_cell_reads_nothing():
    assert _read({"budget": 176}) is None
