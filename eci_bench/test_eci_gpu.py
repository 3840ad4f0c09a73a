"""On the card (marked ``gpu``; skipped without one): each cell's run is
correct and its control is not, at the cell's own size."""
import time

import pytest
import torch

from eci_bench import check, control, harness


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.load_benchmark()["workloads"]])
def test_cell_is_correct_and_its_control_is_not(cuda, workload):
    out = harness.run(workload, 2 ** 31 + 77, 0, False, cuda,
                      time.perf_counter())
    assert out["correct"], out["check"]
    got = control.readings(workload, 2 ** 31 + 78, False, cuda)["control"]
    assert not check.verdict(got)
