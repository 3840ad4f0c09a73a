"""The step kernels' bounds: PERF.md's table of kernels at the measured
shapes, and the launches of one fleet step as the program makes them."""
import pytest
import torch

from eci_bench import roofline as rf
from repro_torch.kernels import coherency_step as K
from repro_torch.traffic import (EngineConfig, FleetConfig, StreamConfig,
                                 WorkloadSpec, run_fleet)

R, L, P = 64, 4096, 65


@pytest.mark.parametrize("launch, us", [
    (rf.credit_rank(R * L), 0.470),
    (rf.arb_winner(P, L), 0.089),
    (rf.count_fold(R * L), 0.235),
    (rf.count_fold(R * L, groups=4), 0.939),
    (rf.lat_hist(R, L), 0.392),
    (rf.packed_any(L, 2), 0.011),
    (rf.packed_any(L, 2, planes=4), 0.040),
    (rf.packed_fanout(L, 2), 0.049),
])
def test_bounds_at_measured_shapes(launch, us):
    assert round(rf.bound_s(launch) * 1e6, 3) == us


def _spied(monkeypatch, packed):
    seen = []

    def spy(name, shape_of):
        real = getattr(K, name)

        def wrapped(*args, **kw):
            seen.append(shape_of(*args, **kw))
            return real(*args, **kw)
        monkeypatch.setattr(K, name, wrapped)

    spy("credit_rank", lambda a, c: rf.credit_rank(a.numel()))
    spy("arb_winner", lambda r, p: rf.arb_winner(
        r.shape[-2], r.shape[-1], r.numel() // (r.shape[-2] * r.shape[-1])))
    spy("count_fold", lambda m, *a, base=None, grouped=False: rf.count_fold(
        m.numel() // m.shape[0] if grouped else m.numel(),
        m.shape[0] if grouped else 1))
    spy("lat_hist", lambda lat, ret: rf.lat_hist(*lat.shape))
    spy("packed_any", lambda *ps: rf.packed_any(
        ps[0].numel() // ps[0].shape[-1], ps[0].shape[-1], len(ps)))
    spy("packed_fanout", lambda pres, *a: rf.packed_fanout(
        pres.numel() // pres.shape[-1], pres.shape[-1],
        len(a) == 6 and a[5] is not None))
    return seen


@pytest.mark.parametrize("packed", [False, True])
def test_step_launches_are_the_programs(monkeypatch, packed):
    M, r, lines = 3, 40, 16
    fleet = FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=lines, block=2, packed=packed),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=2, seed=s),
                      width=2, collect_trace=True)) for s in range(M)),
        steps=1)
    seen = _spied(monkeypatch, packed)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_fleet(fleet, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert sorted(seen) == sorted(rf.step_launches(M, r, lines, packed))
