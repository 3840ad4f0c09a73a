"""The comparison that decides ``correct``, driven through a whole run of
a tiny cell on the CPU: a sound run passes; the control (the reference
with stores granted without invalidating the other copies, put in the
program's place) and each fault the cell can have, planted in the
program, fail it.  A fleet runs on one chip, so it has no exchange
between chips to leave out."""
import time

import numpy as np
import pytest
import torch

from eci_bench import check, harness, tinycells
from eci_bench.reference import engine as ref_engine
from eci_bench.reference import workloads as ref_workloads
import repro_torch.traffic as traffic
from repro_torch.kernels import coherency_step as K
from repro_torch.traffic import driver


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=[False, True], ids=["dense", "packed"])
def root(request, tmp_path):
    return tinycells.tiny_root(tmp_path, packed=request.param)


def _run(root, seed=2 ** 31 + 9):
    return harness.run("tiny", seed, 0, False, "cpu", time.perf_counter(),
                       root=root)


def test_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"]
    assert list(out)[-1] == "check"
    assert out["failed"] == 0 and out["attempted"] == 4 * 8 * 4


def test_control_is_not_correct(root, monkeypatch):
    """The reference under the broken guarantee, in the program's place:
    every compared member differs."""
    real = traffic.run_fleet

    def control(fleet, device=None):
        runs = real(fleet, device=device)      # the shapes of the answers
        e, s = fleet.members[0]
        streams = [ref_workloads.stream(s.workload.name, m.workload.seed,
                                        s.workload.ops, e.remotes, e.lines,
                                        dict(s.workload.params))
                   for _, m in fleet.members]
        op, line, value = (np.stack(x) for x in zip(*streams))
        res = ref_engine.run_fleet(op, line, value, [s.width] * len(runs),
                                   e.lines, e.block, fleet.steps,
                                   control="no_invalidate")
        return [r._replace(
            state=check.member(res.state, i),
            counters=check.member(res.counters, i),
            msg_count=res.state.msg_count[i].numpy(),
            payload_msgs=int(res.state.payload_msgs[i]),
            trace=r.trace._replace(retire_step=res.retire[i].numpy()),
            completed=bool(res.completed[i])) for i, r in enumerate(runs)]

    monkeypatch.setattr(traffic, "run_fleet", control)
    out = _run(root)
    assert not out["correct"]
    assert out["check"]["state_mismatch"]["value"] == 3


def test_step_that_returns_its_state_unchanged(root, monkeypatch):
    real = driver.step_folded

    def frozen(tables, st, *a, **kw):
        res = real(tables, st, *a, **kw)
        return (st,) + tuple(res[1:])
    monkeypatch.setattr(driver, "step_folded", frozen)
    assert not _run(root)["correct"]


def test_half_the_fleet_left_out(root, monkeypatch):
    """The first half of the members run; the rest are reported as their
    copies."""
    real = traffic.run_fleet

    def half(fleet, device=None):
        n = (len(fleet.members) + 1) // 2
        runs = real(type(fleet)(members=fleet.members[:n],
                                steps=fleet.steps), device=device)
        return runs + runs[:len(fleet.members) - n]
    monkeypatch.setattr(traffic, "run_fleet", half)
    out = _run(root)
    assert not out["correct"]


def test_a_message_count_altered_where_it_is_made(root, monkeypatch):
    real = K.count_fold

    def off_by_one(mask, msg, pay, base=None, grouped=False):
        counts, p = real(mask, msg, pay, base=base, grouped=grouped)
        return counts + (torch.arange(16) == 8).to(counts.dtype), p
    monkeypatch.setattr(K, "count_fold", off_by_one)
    out = _run(root)
    assert not out["correct"]
    assert out["check"]["messages_mismatch"]["value"] > 0


def test_a_retirement_altered_where_it_is_made(root, monkeypatch):
    real = traffic.run_fleet

    def late(fleet, device=None):
        runs = real(fleet, device=device)
        ret = runs[0].trace.retire_step.copy()
        ret[0, 0] += 1
        runs[0] = runs[0]._replace(trace=runs[0].trace._replace(
            retire_step=ret))
        return runs
    monkeypatch.setattr(traffic, "run_fleet", late)
    out = _run(root)
    assert out["check"]["retirement_mismatch"]["value"] == 1
