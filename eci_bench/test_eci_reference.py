"""The plain reference against the program on the CPU: the frozen
generators at the cells' shapes, the step budget, and whole fleets,
dense and packed, record for record."""
import numpy as np
import pytest
import torch

from eci_bench import check, harness
from eci_bench.reference import engine as ref_engine
from eci_bench.reference import workloads as ref_workloads
from repro_torch.core import directory_mn as dmn
from repro_torch.traffic import (EngineConfig, FleetConfig, StreamConfig,
                                 WorkloadSpec, fleet_steps, run_fleet)

BIG_SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 63 + 5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_zipfian_copy_matches_program_at_cell_shape(seed):
    bench = harness.load_benchmark()
    cell = harness.Cell(bench, bench["workloads"][0]["name"])
    got = ref_workloads.stream(cell.mix["generator"], seed, cell.ops,
                               cell.R, cell.L, cell.params)
    want = WorkloadSpec(cell.mix["generator"], ops=cell.ops, seed=seed,
                        params=cell.params).materialize(cell.R, cell.L)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ref_workloads.GENERATORS))
def test_every_generator_copy_matches_program(name):
    got = ref_workloads.stream(name, 99, 16, 8, 64, {})
    want = WorkloadSpec(name, ops=16, seed=99).materialize(8, 64)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_budget_matches_program():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.steps == fleet_steps(cell.fleet([1, 2]))


def test_member_seeds_fresh_per_fleet_and_fixed_by_seed():
    a = harness.member_seeds(2 ** 31 + 3, 0, 32)
    assert a == harness.member_seeds(2 ** 31 + 3, 0, 32)
    assert len(set(a)) == 32
    assert not set(a) & set(harness.member_seeds(2 ** 31 + 3, 1, 32))
    assert harness.member_seeds(-5, 0, 4) != harness.member_seeds(5, 0, 4)


def _fleet(R, L, B, W, packed, seeds, ops):
    return FleetConfig(members=tuple(
        (EngineConfig(remotes=R, lines=L, block=B, subset="full_moesi",
                      packed=packed),
         StreamConfig(workload=WorkloadSpec(
             "zipfian", ops=ops, seed=s,
             params={"alpha": 1.2, "store_frac": 0.3}),
             width=W, collect_trace=True)) for s in seeds))


@pytest.mark.parametrize("R, L, W, packed", [
    (8, 32, 4, False),
    (8, 32, 4, True),
    (33, 16, 2, True),
    (3, 8, 1, False),
    (3, 8, 1, True),
])
def test_reference_matches_program_fleet(R, L, W, packed):
    B, ops, seeds = 4, 4, (3, 2 ** 31 + 1, 17)
    runs = run_fleet(_fleet(R, L, B, W, packed, seeds, ops), device="cpu")
    got = harness.program_records(runs, R)
    streams = [ref_workloads.stream("zipfian", s, ops, R, L,
                                    {"alpha": 1.2, "store_frac": 0.3})
               for s in seeds]
    op, line, value = (np.stack(x) for x in zip(*streams))
    res = ref_engine.run_fleet(op, line, value, [W] * 3, L, B,
                               ref_engine.default_steps(ops, R))
    want = [check.record(check.member(res.state, i),
                         check.member(res.counters, i),
                         res.state.msg_count[i], res.state.payload_msgs[i],
                         res.retire[i].numpy(), res.completed[i], R)
            for i in range(3)]
    assert check.compare(got, want) == dict.fromkeys(check.LIMITS, 0)
    assert all(r["completed"][0] for r in want)


@pytest.mark.parametrize("R", [1, 8, 32, 33, 64])
def test_unpack_inverts_program_packing(R):
    g = torch.Generator().manual_seed(R)
    pres = torch.rand((R, 40), generator=g) < 0.4
    excl = pres & (torch.rand((R, 40), generator=g) < 0.5)
    words = torch.stack([dmn.pack_mask(pres), dmn.pack_mask(excl)])
    assert torch.equal(check.unpack(words[0], R), pres)
    view = check.dense_view(words, R)
    assert torch.equal(view, torch.where(excl, 2, torch.where(pres, 1, 0))
                       .to(torch.int8))
    pend = check.dense_pending(words.flip(0) & ~words, R)
    assert set(pend.unique().tolist()) <= {0, 6, 7}


def test_checksum_sees_one_word():
    x = torch.rand((4, 16, 8))
    y = x.clone()
    y[2, 11, 5] += 1.0
    a, b = check.checksum(x), check.checksum(y)
    assert torch.equal(a[[0, 1, 3]], b[[0, 1, 3]]) and a[2] != b[2]
