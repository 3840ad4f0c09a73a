"""The port on the card: each CUDA kernel against its plain version, and
the card's streaming run and model forward against the CPU's — bit for
bit for the integer kernels, allclose at the tolerances of
``tests/test_kernels.py`` for attention and the RG-LRU scan.

Every test here needs a CUDA device and ``nvcc``; it carries the ``gpu``
marker and skips elsewhere.  The file imports nothing of JAX or of
``repro``, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \
        tests/test_torch_gpu.py
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core import pushdown as PD  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import coherency_step as K  # noqa: E402
from repro_torch.kernels import models as MK  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.kernels import nmp as NK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nmp import kvstore as nkv  # noqa: E402
from repro_torch.nmp.dfa import dfa_tables  # noqa: E402
from repro_torch.nmp.regex import compile_regex  # noqa: E402
from repro_torch.nmp.select import make_table  # noqa: E402
from repro_torch.traffic import (AdmissionConfig,  # noqa: E402
                                 ArrivalSpec, EngineConfig, FleetConfig,
                                 ObserveConfig, StreamConfig, WorkloadSpec,
                                 fleet_steps, run_fleet, run_stream,
                                 validate_run)

pytestmark = pytest.mark.gpu

SEED = 99


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _engine_steps(fn):
    """``fn()`` and the engine steps its loop ran: the calls of the
    ``engine.step`` span (the loop stops once the run is quiet)."""
    spans.reset()
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    ran = spans.summary()["engine.step"]["calls"]
    spans.reset()
    return out, ran


def _bools(rng, shape, p):
    return torch.as_tensor(rng.random(shape) < p)


@pytest.mark.parametrize("shape", [(16,), (8, 16), (4, 8, 16), (3, 33),
                                   (1, 1), (64, 4096), (5, 4097), (64, 4095),
                                   (2, 64, 4096), (3, 9000)])
def test_credit_rank_kernel(cuda, shape):
    rng = np.random.default_rng(SEED)
    a = _bools(rng, shape, 0.4)
    c = _bools(rng, shape, 0.3) & ~a
    got = K.credit_rank(a.to(cuda), c.to(cuda)).cpu()
    assert torch.equal(got, ref.credit_rank_ref(a, c))


@pytest.mark.parametrize("shape,a_off,c_off", [
    ((64, 4096), 1, 1),     # an odd byte offset, shared by both planes
    ((7, 100), 3, 3),
    ((64, 4096), 1, 2),     # no common alignment: one lane at a time
    ((5, 4097), 15, 15)])
def test_credit_rank_kernel_unaligned(cuda, shape, a_off, c_off):
    """Contiguous views that start past a 16-byte edge (``buf[1:]`` of a
    flat buffer, reshaped)."""
    rng = np.random.default_rng(SEED + a_off)
    a = _bools(rng, shape, 0.4)
    c = _bools(rng, shape, 0.3) & ~a
    n = a.numel()
    a_v = torch.zeros(n + a_off, dtype=torch.bool,
                      device=cuda)[a_off:].view(shape)
    c_v = torch.zeros(n + c_off, dtype=torch.bool,
                      device=cuda)[c_off:].view(shape)
    a_v.copy_(a)
    c_v.copy_(c)
    got = K.credit_rank(a_v, c_v).cpu()
    assert torch.equal(got, ref.credit_rank_ref(a, c))


@pytest.mark.parametrize("P,L,lead,rr_span,p_ready", [
    (3, 16, (), 1, 0.3), (65, 32, (), 1, 0.3), (5, 8, (4,), 1, 0.3),
    (65, 1, (), 1, 0.3), (65, 4096, (), 1, 0.3),
    (65, 4097, (), 1, 0.3),            # L not a multiple of 4: byte loads
    (7, 1, (2,), 1, 0.3),
    (65, 4096, (4,), 1, 0.3),          # the multi-home fold's lead
    (65, 4096, (), 40, 0.3),           # rr negative and >= P
    (65, 4097, (4,), 40, 1.0),         # all ready
    (65, 4096, (2,), 40, 0.0),         # none ready
    (3, 33, (), 1000, 0.5)])
def test_arb_winner_kernel(cuda, P, L, lead, rr_span, p_ready):
    rng = np.random.default_rng(SEED + P + L)
    r = _bools(rng, lead + (P, L), p_ready)
    if 0 < p_ready < 1:
        r[..., :3] = False            # nobody ready: the fill-value ties
    lo = 0 if rr_span == 1 else -rr_span * P
    rr = torch.as_tensor(rng.integers(lo, rr_span * P, lead + (L,))
                         .astype(np.int32))
    got = K.arb_winner(r.to(cuda), rr.to(cuda)).cpu()
    assert torch.equal(got, ref.arb_winner_ref(r, rr))


def _codes(rng, shape):
    """int8 codes of every kind: 0..15, negative, past 15, and the
    HOME_TXN sentinel 100 at every 7th lane."""
    g = torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8))
    keep = torch.as_tensor(rng.random(shape) < 0.6)
    g = torch.where(keep, torch.as_tensor(
        rng.integers(0, 16, shape).astype(np.int8)), g)
    g.view(-1)[::7] = 100
    return g


def _base(rng):
    return (torch.as_tensor(rng.integers(0, 2 ** 20, 16).astype(np.int32)),
            torch.tensor(int(rng.integers(0, 2 ** 20)), dtype=torch.int32))


# one CTA takes up to kFoldThreads 16-lane groups: sizes on both sides of
# 2048, 4096 and 8192 lanes; past the most CTAs a launch takes (each
# thread then loops), and past 15 groups a thread (its byte counters
# flush).
@pytest.mark.parametrize("all_false", [False, True])
@pytest.mark.parametrize("shape", [(8, 16), (5, 7), (33,), (64, 4096),
                                   (4096,), (2048,), (2049,), (4097,),
                                   (8192,), (8193,), (2048, 4096),
                                   (5000, 8192)])
def test_count_fold_kernel(cuda, shape, all_false):
    rng = np.random.default_rng(SEED)
    m = _bools(rng, shape, 0.0 if all_false else 0.5)
    g = _codes(rng, shape)
    p = _bools(rng, shape, 0.5)
    gc, gp = K.count_fold(m.to(cuda), g.to(cuda), p.to(cuda))
    wc, wp = ref.count_fold_ref(m, g, p)
    assert torch.equal(gc.cpu(), wc) and torch.equal(gp.cpu(), wp)
    base = _base(rng)
    gc, gp = K.count_fold(m.to(cuda), g.to(cuda), p.to(cuda),
                          base=tuple(b.to(cuda) for b in base))
    wc, wp = ref.count_fold_ref(m, g, p, base=base)
    assert torch.equal(gc.cpu(), wc) and torch.equal(gp.cpu(), wp)


@pytest.mark.parametrize("n,offs", [
    (4096, (1, 1, 1)),      # one CTA's worth, 15 lanes of head: two CTAs
    (64 * 4096, (5, 5, 5)),
    (4099, (0, 3, 0)),      # no common alignment: one lane at a time
    (100, (15, 15, 15))])
def test_count_fold_kernel_unaligned(cuda, n, offs):
    """Contiguous views with a storage offset, and a length that is not
    a multiple of 16."""
    rng = np.random.default_rng(SEED + n)
    m, g, p = _bools(rng, n, 0.5), _codes(rng, n), _bools(rng, n, 0.5)
    views = []
    for t, off in zip((m, g, p), offs):
        v = torch.zeros(n + off, dtype=t.dtype, device=cuda)[off:]
        v.copy_(t)
        views.append(v)
    base = _base(rng)
    gc, gp = K.count_fold(*views, base=tuple(b.to(cuda) for b in base))
    wc, wp = ref.count_fold_ref(m, g, p, base=base)
    assert torch.equal(gc.cpu(), wc) and torch.equal(gp.cpu(), wp)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("G,n", [(1, 64 * 4096), (3, 4096), (3, 33),
                                 (12, 64 * 4096), (12, 2049)])
def test_count_fold_grouped_kernel(cuda, G, n, with_base):
    """The grouped form, one launch for G groups, against its twin; G=1
    is the ungrouped call's launch, bit for bit."""
    rng = np.random.default_rng(SEED + G + n)
    m, g, p = _bools(rng, (G, n), 0.3), _codes(rng, (G, n)), \
        _bools(rng, (G, n), 0.5)
    base = None
    if with_base:
        bases = [_base(rng) for _ in range(G)]
        base = (torch.stack([b[0] for b in bases]),
                torch.stack([b[1] for b in bases]))
    K.reset_launches()
    gc, gp = K.count_fold(m.to(cuda), g.to(cuda), p.to(cuda),
                          base=None if base is None else
                          tuple(b.to(cuda) for b in base), grouped=True)
    assert K.launches["count_fold"] == 1
    wc, wp = ref.count_fold_ref(m, g, p, base, grouped=True)
    assert gc.shape == (G, 16) and gp.shape == (G,)
    assert torch.equal(gc.cpu(), wc) and torch.equal(gp.cpu(), wp)
    if G == 1:
        uc, up = K.count_fold(m[0].to(cuda), g[0].to(cuda), p[0].to(cuda),
                              base=None if base is None else
                              (base[0][0].to(cuda), base[1][0].to(cuda)))
        assert torch.equal(uc.cpu(), gc[0].cpu())
        assert torch.equal(up.cpu(), gp[0].cpu())


def _small_fleet(packed=False):
    return FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=16, block=4, homes=h, home_bw=bw,
                      packed=packed),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=8, seed=sd),
                      width=w, collect_trace=True))
        for r, w, h, bw, sd in ((2, 1, 1, 0, 1), (8, 2, 2, 1, 2),
                                (5, 3, 4, 0, 3))))


@pytest.mark.parametrize("packed", [False, True])
def test_fleet_card_equals_cpu(cuda, packed):
    """A small fleet on the card (the kernels, the grouped fold among
    them) equals the same fleet on the CPU, member by member, and each
    member its solo run on the card."""
    fleet = _small_fleet(packed)
    K.reset_launches()
    gpu, ran = _engine_steps(lambda: run_fleet(fleet, device=cuda))
    steps = fleet_steps(fleet)
    assert K.launches["count_fold"] == 5 * ran and ran <= steps
    cpu = run_fleet(fleet, device="cpu")
    for (e, s), a, b in zip(fleet.members, gpu, cpu):
        assert a.completed and b.completed
        np.testing.assert_array_equal(a.msg_count, b.msg_count)
        np.testing.assert_array_equal(a.trace.retire_step,
                                      b.trace.retire_step)
        for x, y in zip(a.counters, b.counters):
            assert torch.equal(x.cpu(), y.cpu())
        solo = run_stream(e.build(cuda), StreamConfig(
            workload=s.workload, width=s.width, steps=steps,
            collect_trace=True))
        np.testing.assert_array_equal(solo.msg_count, a.msg_count)
        validate_run(a, n_homes=e.homes)


def test_fleet_loop_makes_no_host_sync(cuda):
    members = _small_fleet().members
    counts = []
    for steps in (2, 5, 15):    # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_fleet(FleetConfig(members=members, steps=steps),
                          device=cuda)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    assert counts[2] > 0 and counts[1] == counts[2]


@pytest.mark.parametrize("packed", [False, True])
def test_fleet_loop_stops_near_quiescence_without_a_sync(cuda, monkeypatch,
                                                         packed):
    """From its second step on, the loop runs under CUDA's sync debug
    mode "error", so a blocking read of the quiet flag raises; it stops
    within 4 steps of the step after which every member is quiet (the CPU
    loop reads each flag as it is made and stops right there), and its
    members equal the CPU's."""
    from repro_torch.traffic import driver
    from repro_torch.traffic import fleet as fleet_mod
    fleet = _small_fleet(packed)
    real = driver.step_folded
    calls = []

    def strict(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            torch.cuda.set_sync_debug_mode("error")
        return real(*a, **kw)

    run_fleet(fleet, device=cuda)       # builds the cached constants
    loop = driver._stream_loop

    def checked(*a, **kw):
        try:
            return loop(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(driver, "step_folded", strict)
    monkeypatch.setattr(fleet_mod, "_stream_loop", checked)
    gpu = run_fleet(fleet, device=cuda)
    monkeypatch.undo()
    cpu, quiet = _engine_steps(lambda: run_fleet(fleet, device="cpu"))
    assert quiet < fleet_steps(fleet)
    assert quiet <= len(calls) <= quiet + 4, (len(calls), quiet)
    for a, b in zip(gpu, cpu):
        np.testing.assert_array_equal(a.msg_count, b.msg_count)
        np.testing.assert_array_equal(a.trace.retire_step,
                                      b.trace.retire_step)
        for x, y in zip(a.counters, b.counters):
            assert torch.equal(x.cpu(), y.cpu())


def test_fleet_mesh_devices_equals_one_device(cuda):
    """Members split across two CUDA devices equal the one-device fleet."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: one card cannot split a fleet")
    members = _small_fleet().members
    one = run_fleet(FleetConfig(members=members), device=cuda)
    two = run_fleet(FleetConfig(members=members, mesh_devices=2),
                    device=cuda)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a.msg_count, b.msg_count)
        for x, y in zip(a.counters, b.counters):
            assert torch.equal(x.cpu(), y.cpu())


def test_fleet_mesh_devices_past_the_visible_count(cuda):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} CUDA device"):
        run_fleet(FleetConfig(members=_small_fleet().members[:1],
                              mesh_devices=n + 1), device=cuda)


def test_count_fold_kernel_back_to_back(cuda):
    """1,000 launches in a row, each folding into the last one's totals,
    alternating a multi-CTA plane and a one-CTA plane: a ticket that did
    not reset would show in the totals."""
    rng = np.random.default_rng(SEED + 1)
    planes = []
    for shape in ((64, 4096), (4096,)):
        planes.append((_bools(rng, shape, 0.05), _codes(rng, shape),
                       _bools(rng, shape, 0.5)))
    deltas = [ref.count_fold_ref(*pl) for pl in planes]
    on_card = [tuple(t.to(cuda) for t in pl) for pl in planes]
    c = torch.zeros(16, dtype=torch.int32, device=cuda)
    pay = torch.zeros((), dtype=torch.int32, device=cuda)
    outs = []
    for i in range(1000):
        c, pay = K.count_fold(*on_card[i % 2], base=(c, pay))
        outs.append(torch.cat([c, pay[None]]))
    got = torch.stack(outs).cpu()
    step = [torch.cat([d[0], d[1][None]]) for d in deltas]
    want = torch.cumsum(torch.stack([step[i % 2] for i in range(1000)]),
                        dim=0, dtype=torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,L", [(4, 16), (3, 7), (1, 1), (64, 4096)])
def test_lat_hist_kernel(cuda, R, L):
    rng = np.random.default_rng(SEED)
    lat = torch.as_tensor(rng.integers(-4, 600, (R, L)).astype(np.int32))
    ret = _bools(rng, (R, L), 0.5)
    got = K.lat_hist(lat.to(cuda), ret.to(cuda)).cpu()
    assert torch.equal(got, ref.lat_hist_ref(lat, ret, K.LAT_EDGES))


@pytest.mark.parametrize("R,L,r_off,l_off", [
    (5, 4099, 0, 0),        # L % 16 != 0: every row starts elsewhere
    (3, 100, 1, 1),         # offsets 1 B and 4 B: 15 lanes, then 16 at a time
    (64, 4096, 1, 2),       # 1 B and 8 B: no common alignment
    (4, 1000, 12, 4)])      # 12 B and 16 B: 4 lanes, then 16 at a time
def test_lat_hist_kernel_unaligned(cuda, R, L, r_off, l_off):
    """Rows whose start is not 16-byte aligned: a ragged L, and contiguous
    views with a storage offset."""
    rng = np.random.default_rng(SEED + L)
    lat = torch.as_tensor(rng.integers(-4, 600, (R, L)).astype(np.int32))
    ret = _bools(rng, (R, L), 0.5)
    lat_v = torch.zeros(R * L + l_off, dtype=torch.int32,
                        device=cuda)[l_off:].view(R, L)
    ret_v = torch.zeros(R * L + r_off, dtype=torch.bool,
                        device=cuda)[r_off:].view(R, L)
    lat_v.copy_(lat)
    ret_v.copy_(ret)
    got = K.lat_hist(lat_v, ret_v).cpu()
    assert torch.equal(got, ref.lat_hist_ref(lat, ret, K.LAT_EDGES))


@pytest.mark.parametrize("value,b", [(-7, 0), (0, 0), (3, 2), (255, 8),
                                     (256, 9), (2 ** 31 - 1, 9)])
def test_lat_hist_kernel_one_bin(cuda, value, b):
    """Every lane retired, into one bin: the counts reach L per row."""
    lat = torch.full((64, 4096), value, dtype=torch.int32, device=cuda)
    ret = torch.ones((64, 4096), dtype=torch.bool, device=cuda)
    got = K.lat_hist(lat, ret).cpu()
    want = torch.zeros((64, len(K.LAT_EDGES) + 1), dtype=torch.int32)
    want[:, b] = 4096
    assert torch.equal(got, want)
    assert torch.equal(got, ref.lat_hist_ref(lat, ret, K.LAT_EDGES).cpu())


def _words(rng, shape):
    w = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
    w = np.where(rng.random(shape) < 0.5, w, 0).astype(np.int32)
    edge = [-2 ** 31, -1, 0, 1]          # bit 31, all ones, none, bit 0
    flat = w.reshape(-1)
    flat[:len(edge)] = edge[:flat.size]
    return torch.as_tensor(w)


@pytest.mark.parametrize("shape", [(16, 1), (8, 2), (3, 16, 2), (64, 3),
                                   (2, 2048, 2), (4096, 1), (1, 1)])
def test_packed_any_kernel(cuda, shape):
    w = _words(np.random.default_rng(SEED), shape)
    got = K.packed_any(w.to(cuda)).cpu()
    assert torch.equal(got, ref.packed_any_ref(w))


@pytest.mark.parametrize("lead,L,W", [((), 16, 1), ((), 8, 2),
                                      ((2,), 2048, 2), ((2,), 7, 3),
                                      ((), 1, 1)])
def test_packed_fanout_kernel(cuda, lead, L, W):
    rng = np.random.default_rng(SEED + L)
    pres = _words(rng, lead + (L, W))
    excl = pres & _words(rng, lead + (L, W))
    node = rng.integers(0, 32 * W, lead + (L,)).astype(np.int32)
    edge = [0, 31, 32 * W - 1, 32 * (W - 1)]
    node.reshape(-1)[:len(edge)] = edge[:node.size]
    node = torch.as_tensor(node)
    sh = _bools(rng, lead + (L,), 0.5)
    ex = _bools(rng, lead + (L,), 0.5) & ~sh
    got = K.packed_fanout(pres.to(cuda), excl.to(cuda), node.to(cuda),
                          sh.to(cuda), ex.to(cuda))
    for g, w in zip(got, ref.packed_fanout_ref(pres, excl, node, sh, ex)):
        assert torch.equal(g.cpu(), w)


def _mask_words(rng, lead, R, L, p):
    """``[*lead, L, W]`` packed words of a random ``[*lead, R, L]`` mask."""
    from repro_torch.core.directory_mn import pack_mask
    return pack_mask(_bools(rng, lead + (R, L), p))


#: the multi-plane ``packed_any`` cases: (R, lines), and how the planes
#: lie — as planes of their own, as slices ``[:, p]`` of two ``[H, 2,
#: L/H, W]`` arrays (the step's view and pending mask), or one word past
#: an 8-byte boundary (no paired loads).
ANY_PLANE_CASES = {"W=1 (R=8)": (8, 40, "own"),
                   "ragged W=2 (R=33)": (33, 40, "own"),
                   "bit 31": (64, 40, "own"),
                   "[2, 2, 2048, 2] slices": (64, 2048, "slices"),
                   "one word off 8 bytes": (64, 300, "offset")}


def _any_planes_on_card(rng, case, n, cuda):
    R, L, lay = ANY_PLANE_CASES[case]
    lead = (2,) if lay == "slices" else ()
    planes = []
    for _ in range(n + n % 2 if lay == "slices" else n):
        if case == "bit 31":
            w = torch.zeros((L, 2), dtype=torch.int32)
            w[_bools(rng, (L,), 0.2), 0] = -2 ** 31
        else:
            w = _mask_words(rng, lead, R, L, 0.01)
        planes.append(w)
    if lay == "own":
        return [w.to(cuda) for w in planes]
    if lay == "offset":
        out = []
        for w in planes:
            flat = torch.zeros(w.numel() + 1, dtype=torch.int32, device=cuda)
            out.append(flat[1:].view(w.shape).copy_(w))
        return out
    arrs = [torch.stack(planes[i:i + 2], dim=-3).to(cuda)
            for i in range(0, len(planes), 2)]
    return [a[:, p] for a in arrs for p in (0, 1)][:n]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(ANY_PLANE_CASES))
def test_packed_any_kernel_planes(cuda, case, n):
    """One launch over the OR of 1-4 planes, each read where it lies,
    equals the plain twin (and, per plane, the one-plane kernel)."""
    planes = _any_planes_on_card(np.random.default_rng(SEED + n), case, n,
                                 cuda)
    if case.endswith("slices"):
        assert not any(p.is_contiguous() for p in planes)
    want = ref.packed_any_ref(*[p.cpu() for p in planes])
    K.reset_launches()
    got = K.packed_any(*planes).cpu()
    assert K.launches["packed_any"] == 1
    assert torch.equal(got, want)
    per_plane = [K.packed_any(p).cpu() for p in planes]
    assert torch.equal(torch.stack(per_plane).any(0), want)


@pytest.mark.parametrize("lead,L,W", [((), 16, 1), ((), 8, 2),
                                      ((2,), 2048, 2), ((2,), 7, 3),
                                      ((), 1, 1)])
def test_packed_fanout_kernel_home_flags(cuda, lead, L, W):
    """The fan-out kernel on the planes of a packed ``[*lead, 2, L, W]``
    view, read where they lie, with and without the home flags (home
    lanes, remote lanes and both request flags), equals the plain
    twin."""
    rng = np.random.default_rng(SEED + 7 * L + W)
    pres = _words(rng, lead + (L, W))
    excl = pres & _words(rng, lead + (L, W))
    view = torch.stack([pres, excl], dim=-3).to(cuda)
    node = rng.integers(0, 32 * W, lead + (L,)).astype(np.int32)
    edge = [0, 31, 32 * W - 1, 32 * (W - 1)]
    node.reshape(-1)[:len(edge)] = edge[:node.size]
    node = torch.as_tensor(node)
    sh, ex = _bools(rng, lead + (L,), 0.5), _bools(rng, lead + (L,), 0.5)
    home = _bools(rng, lead + (L,), 0.4)
    hr = home & _bools(rng, lead + (L,), 0.6)
    hw = home & _bools(rng, lead + (L,), 0.6)
    for flags in ((), (hr, hw)):
        got = K.packed_fanout(view[..., 0, :, :], view[..., 1, :, :],
                              node.to(cuda), sh.to(cuda), ex.to(cuda),
                              *(f.to(cuda) for f in flags))
        want = ref.packed_fanout_ref(pres, excl, node, sh, ex, *flags)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_packed_kernels_refuse_planes_not_dense(cuda):
    """A word plane whose last two dims are not dense, or whose leading
    dims do not collapse into one axis, is refused; so are planes of two
    shapes, more than four planes, and one home flag without the other."""
    w = torch.zeros((4, 8, 2), dtype=torch.int32, device=cuda)
    b = torch.zeros((4, 8), dtype=torch.bool, device=cuda)
    node = b.to(torch.int32)
    lead = torch.zeros((4, 4, 8, 2), dtype=torch.int32, device=cuda)
    for bad in (w[..., :1], w[:, ::2], lead[::2, :2]):
        with pytest.raises(ValueError, match="word plane"):
            K.packed_any(bad)
        with pytest.raises(ValueError, match="word plane"):
            K.packed_any(bad.contiguous(), bad)
    with pytest.raises(ValueError, match="word plane"):
        K.packed_fanout(w[..., :1], w[..., :1], node, b, b)
    with pytest.raises(ValueError):
        K.packed_any(w, w[:2])
    with pytest.raises(ValueError):
        K.packed_any(*[w] * 5)
    with pytest.raises(ValueError):
        K.packed_fanout(w, w, node, b, b, home_write=b)
    with pytest.raises(TypeError):
        K.packed_fanout(w, w, node, b, b, b.to(torch.int8), b)


def test_packed_kernels_refuse_planes_past_32_bit_index(cuda):
    """Planes whose words the kernels' 32-bit index cannot reach are
    refused before any launch, with the limit named: here 2^31 output
    words from one broadcast [2, 1] block, which takes no memory."""
    w = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    big = w.expand(2 ** 30, 2, 1)
    lines = torch.zeros((1, 1), dtype=torch.bool, device=cuda)
    lines = lines.expand(2 ** 30, 2)
    node = w.view(1, 2).expand(2 ** 30, 2)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="2\\^31"):
        K.packed_any(big)
    with pytest.raises(ValueError, match="2\\^31"):
        K.packed_fanout(big, big, node, lines, lines)
    assert dict(K.launches) == before


def test_kernels_refuse_wrong_inputs(cuda):
    b = torch.zeros((4, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        K.credit_rank(b.to(torch.int8), b)
    with pytest.raises(ValueError):
        K.credit_rank(b.t(), b.t())           # not contiguous
    with pytest.raises(ValueError):
        K.arb_winner(b, torch.zeros(7, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K.count_fold(b, b.to(torch.int8).cpu(), b)
    i32 = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):            # base shapes
        K.count_fold(b, b.to(torch.int8), b, base=(i32[:8], i32[0]))
    with pytest.raises(TypeError):             # base dtype
        K.count_fold(b, b.to(torch.int8), b,
                     base=(i32.to(torch.int64), i32[0]))
    w = torch.zeros((4, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        K.packed_any(w.to(torch.int64))
    with pytest.raises(ValueError):
        K.packed_any(w.transpose(0, 1))        # not contiguous
    with pytest.raises(ValueError):
        K.packed_fanout(w, w, b[:, :7].to(torch.int32), b[:, :7], b[:, :7])


@pytest.mark.parametrize("moesi", [True, False])
def test_stream_card_equals_cpu(cuda, moesi):
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=24, seed=4),
                       width=2, collect_trace=True)
    K.reset_launches()
    gpu = run_stream(EngineConfig(remotes=8, lines=16, block=4,
                                  moesi=moesi).build(cuda), cfg)
    # the dense path launches the four dense kernels, not the packed two.
    assert all(K.launches[n] > 0 for n in ("credit_rank", "arb_winner",
                                           "count_fold", "lat_hist"))
    assert K.launches["packed_any"] == K.launches["packed_fanout"] == 0
    cpu = run_stream(EngineConfig(remotes=8, lines=16, block=4,
                                  moesi=moesi).build("cpu"), cfg)
    np.testing.assert_array_equal(gpu.msg_count, cpu.msg_count)
    assert gpu.payload_msgs == cpu.payload_msgs
    np.testing.assert_array_equal(gpu.trace.retire_step,
                                  cpu.trace.retire_step)
    for a, b in zip(gpu.counters, cpu.counters):
        assert torch.equal(a, b)
    validate_run(gpu, moesi=moesi)


@pytest.mark.parametrize("kw", [
    dict(remotes=33, homes=2, packed=True, moesi=False),
    dict(remotes=64, homes=2, packed=True),
    dict(remotes=8, homes=2, home_bw=1),
    dict(remotes=8, shared_credits=True, credits=4)],
    ids=["packed_r33_h2", "packed_r64_h2", "h2_home_bw1", "shared"])
def test_option_stream_card_equals_cpu(cuda, kw):
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=16, seed=4),
                       width=2, collect_trace=True)
    K.reset_launches()
    gpu = run_stream(EngineConfig(lines=16, block=4, **kw).build(cuda), cfg)
    if kw.get("packed"):
        assert K.launches["packed_any"] > 0
        assert K.launches["packed_fanout"] > 0
    cpu = run_stream(EngineConfig(lines=16, block=4, **kw).build("cpu"), cfg)
    np.testing.assert_array_equal(gpu.msg_count, cpu.msg_count)
    assert gpu.payload_msgs == cpu.payload_msgs
    np.testing.assert_array_equal(gpu.trace.retire_step,
                                  cpu.trace.retire_step)
    for a, b in zip(gpu.counters, cpu.counters):
        assert torch.equal(a, b)
    validate_run(gpu, moesi=kw.get("moesi", True),
                 n_homes=kw.get("homes", 1))


def test_step_loop_makes_no_host_sync(cuda):
    eng = EngineConfig(remotes=8, lines=64, block=4).build(cuda)
    counts = []
    for steps in (2, 5, 15):    # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=16), width=2,
                    steps=steps, collect_trace=True))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    assert counts[2] > 0 and counts[1] == counts[2]


def test_packed_two_home_step_loop_makes_no_host_sync(cuda):
    eng = EngineConfig(remotes=64, lines=64, block=4, homes=2,
                       packed=True, home_bw=2).build(cuda)
    counts = []
    for steps in (2, 5, 15):    # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=16), width=2,
                    steps=steps, collect_trace=True))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    assert counts[2] > 0 and counts[1] == counts[2]


def _same_open_and_observed(gpu, cpu):
    """Card and CPU runs equal: counters, messages, trace, the open loop's
    histograms and backlog, and the observability digest."""
    np.testing.assert_array_equal(gpu.msg_count, cpu.msg_count)
    np.testing.assert_array_equal(gpu.trace.retire_step,
                                  cpu.trace.retire_step)
    for a, b in zip(gpu.counters, cpu.counters):
        assert torch.equal(a, b)
    for f in ("sojourn_hist", "admit_wait_hist"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))
    assert gpu.backlog == cpu.backlog and gpu.completed == cpu.completed
    assert (gpu.obs is None) == (cpu.obs is None)
    if gpu.obs is not None:
        assert gpu.obs.metrics() == cpu.obs.metrics()
        np.testing.assert_array_equal(gpu.obs.words, cpu.obs.words)


OPEN_CASES = {
    "poisson_cap": (dict(remotes=8), dict(
        arrivals=ArrivalSpec("poisson", rate=0.1, seed=1),
        admission=AdmissionConfig(16, 2))),
    "bursty_w2": (dict(remotes=8), dict(
        arrivals=ArrivalSpec("bursty", rate=0.2, seed=2), width=2)),
    "packed_h2_cap": (dict(remotes=33, homes=2, packed=True, moesi=False),
                      dict(arrivals=ArrivalSpec("poisson", rate=0.1,
                                                seed=1),
                           admission=AdmissionConfig(16, 2))),
    "observed_inject": (dict(remotes=8), dict(observe=ObserveConfig(
        specs=("req_resp", "single_writer", "readonly"),
        inject=(40, 3, 1)))),
    "observed_h2_open": (dict(remotes=8, homes=2), dict(
        observe=ObserveConfig(capacity=64, port=8),
        arrivals=ArrivalSpec("poisson", rate=0.1, seed=3),
        admission=AdmissionConfig(8, 1))),
}


@pytest.mark.parametrize("case", list(OPEN_CASES))
def test_open_loop_and_observed_card_equals_cpu(cuda, case):
    kw, skw = OPEN_CASES[case]
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=12, seed=4),
                       collect_trace=True, **skw)
    K.reset_launches()
    gpu, ran = _engine_steps(lambda: run_stream(
        EngineConfig(lines=16, block=4, **kw).build(cuda), cfg))
    assert K.launches["count_fold"] == 5 * ran
    assert ran <= int(gpu.counters.steps)
    cpu = run_stream(EngineConfig(lines=16, block=4, **kw).build("cpu"),
                     cfg)
    _same_open_and_observed(gpu, cpu)
    validate_run(gpu, moesi=kw.get("moesi", True),
                 n_homes=kw.get("homes", 1))


@pytest.mark.parametrize("skw", [
    dict(arrivals=ArrivalSpec("at_step0"), admission=AdmissionConfig(8, 2)),
    dict(observe=ObserveConfig())], ids=["open_loop_cap", "observed"])
def test_open_loop_and_observed_loops_make_no_host_sync(cuda, skw):
    eng = EngineConfig(remotes=8, lines=64, block=4).build(cuda)
    counts = []
    for steps in (2, 5, 15):    # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=16), width=2,
                    steps=steps, collect_trace=True, **skw))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    assert counts[2] > 0 and counts[1] == counts[2]


# -- the near-memory kernels -------------------------------------------------

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("n,w,block,sel,x", [
    (1024, 32, 256, 0.1, 0.0), (1024, 32, 256, 1.0, 0.0),
    (1024, 32, 256, 0.0, 0.0), (640, 6, 64, 0.5, 0.0),
    (4096, 32, 1024, 0.3, 0.0), (512, 8, 32, 0.3, float("-inf")),
    (256, 2, 256, 0.5, 0.0)])
def test_select_scan_kernel(cuda, n, w, block, sel, x):
    t = make_table(SEED + n, n, w, sel, device="cpu")
    if w > 4:
        t[::3, 3] = -0.0                 # bits are copied, not summed
        t[::5, 4] = float("nan")
    t[:block, :2] = torch.tensor([1.0, 0.0])          # an all-match block
    got = NK.select_scan(t.to(cuda), x, 1.0, block)
    want = ref.select_scan_ref(t, x, 1.0, block)
    assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("n", [1000, 77, 256])
def test_ops_select_ragged_minus_inf(cuda, n):
    t = make_table(SEED, n, 32, 0.4, device="cpu")
    got = ops.select(t.to(cuda), float("-inf"), 1.0)
    want = ops.select(t, float("-inf"), 1.0)
    assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
    assert torch.equal(got[1].cpu(), want[1])


def _strings(rng, n, width, alphabet=b"xyzab01"):
    arr = rng.choice(np.frombuffer(alphabet, np.uint8), (n, width))
    arr[rng.random(n) < 0.3, width // 2:] = 0
    return torch.as_tensor(arr.astype(np.uint8))


@pytest.mark.parametrize("pattern,n,width", [
    ("xyzzy", 1000, 62), ("a(b|x)+0", 4096, 24), ("[0-9]+", 5, 1),
    ("(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)", 3000, 40), ("a*", 64, 8),
    ("xyzzy", 300, 200)])
@pytest.mark.parametrize("aligned", [True, False])
def test_regex_dfa_kernel(cuda, pattern, n, width, aligned):
    dfa = compile_regex(pattern)
    if pattern.startswith("(a|b)*"):
        assert dfa.n_states > 64         # the table read through the L1
    s = _strings(np.random.default_rng(SEED), n, width)
    trans, accept = dfa_tables(dfa, "cpu")
    # unaligned: a view one byte into its storage, so no 16-byte loads
    flat = torch.zeros(n * width + 1, dtype=torch.uint8, device=cuda)
    on_card = flat[int(not aligned):][:n * width].view(n, width)
    on_card.copy_(s)
    want = ref.regex_dfa_ref(trans, accept, s)
    got = NK.regex_dfa(trans.to(cuda), accept.to(cuda), on_card)
    assert torch.equal(got.cpu(), want)
    # in place: the field of a wider table, at row strides 128 (the TMA
    # path) and 130 (cp.async), at byte offsets 0, 1 and 8 of the row,
    # the table itself one byte into its storage when not aligned.
    for stride in (128, 130, max(width + 8, 256)):
        for offset in (0, 1, 8):
            if width + offset > stride:
                continue
            store = torch.zeros(n * stride + 1, dtype=torch.uint8,
                                device=cuda)
            table = store[int(not aligned):][:n * stride].view(n, stride)
            field = table[:, offset:offset + width]
            field.copy_(s)
            got = NK.regex_dfa(trans.to(cuda), accept.to(cuda), field)
            assert torch.equal(got.cpu(), want), (stride, offset)


@pytest.mark.parametrize("n_states", [20, 64, 100])
def test_regex_dfa_kernel_table_without_absorbing_states(cuda, n_states):
    rng = np.random.default_rng(n_states)
    trans = torch.as_tensor(rng.integers(0, n_states, (n_states, 256))
                            .astype(np.int32))
    trans[3] = 3                        # one absorbing state
    accept = torch.as_tensor(rng.random(n_states) < 0.5)
    s = torch.as_tensor(rng.integers(0, 256, (2000, 17)).astype(np.uint8))
    got = NK.regex_dfa(trans.to(cuda), accept.to(cuda), s.to(cuda))
    assert torch.equal(got.cpu(), ref.regex_dfa_ref(trans, accept, s))


@pytest.mark.parametrize("n,key_hi,n_buckets,max_chain", [
    (3000, 500, 7, 600), (5000, 10 ** 9, 64, 8), (300, 2 ** 32, 1, 400),
    (4096, 2 ** 32, 4096, 0), (1000, 50, 16, 3)])
def test_hash_probe_kernel(cuda, n, key_hi, n_buckets, max_chain):
    rng = np.random.default_rng(n)
    keys = (2 ** 32 - rng.integers(1, key_hi, n, dtype=np.uint64)
            ).astype(np.uint32)                 # near 2^32, duplicates
    kv = nkv.build_kvs(keys, np.ones((n, 1), np.float32), n_buckets,
                       device="cpu")
    q = torch.cat([kv.keys[::2], kv.keys[:333] ^ 0x5A5A])
    want = ref.hash_probe_ref(kv.heads, kv.keys, kv.nxt, q, max_chain)
    keys, nxt = nkv.chains_to(kv.keys, kv.nxt, cuda)
    assert nkv.records(keys, nxt) is not None
    for k, nx in ((keys, nxt), (keys.contiguous(), nxt.contiguous())):
        got = NK.hash_probe(kv.heads.to(cuda), k, nx, q.to(cuda), max_chain)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_nmp_kernels_refuse_wrong_inputs(cuda):
    t = torch.zeros((256, 8), device=cuda)
    with pytest.raises(TypeError, match="float64"):
        NK.select_scan(t.to(torch.float64), 0.0, 1.0)
    with pytest.raises(TypeError, match="int64"):
        NK.select_scan(t.to(torch.int64), 0.0, 1.0)
    with pytest.raises(ValueError):
        NK.select_scan(t, 0.0, 1.0, block_rows=100)
    with pytest.raises(ValueError):
        NK.select_scan(torch.zeros((8, 256), device=cuda).t(), 0.0, 1.0)
    trans = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    acc = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        NK.regex_dfa(trans, acc, t.to(torch.int32))
    with pytest.raises(ValueError):
        NK.regex_dfa(trans[:, :100].contiguous(), acc,
                     t.to(torch.uint8))
    with pytest.raises(ValueError):                 # rows not contiguous
        NK.regex_dfa(trans, acc, t.to(torch.uint8).t())
    with pytest.raises(ValueError):                 # rows overlap
        NK.regex_dfa(trans, acc, t.to(torch.uint8)[:1].expand(4, 8))
    i = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        NK.hash_probe(i, i.to(torch.int64), i, i, 4)
    with pytest.raises(ValueError):
        NK.hash_probe(i[:0], i, i, i, 4)
    i16 = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):      # strided, but no records layout
        NK.hash_probe(i, i16[::2], i16[::2], i, 4)
    with pytest.raises(ValueError):      # records not 8-byte aligned
        NK.hash_probe(i, i16[1:-1:2], i16[2::2], i, 4)


def _device_ops(fn, calls=5):
    """The distinct device operations (kernels, memsets, copies) that
    ``calls`` calls of ``fn`` run, each at most once a call, from the
    profiler's CUDA trace (which may drop records of a kernel launched
    through ctypes, never add them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert all(ev.count <= calls for ev in on_card)
    return [ev.key for ev in on_card]


def test_nmp_kernels_one_device_operation_per_call(cuda):
    """``regex_dfa`` writes its answer itself, on a contiguous field and
    in place; ``hash_probe`` on the records layout launches as it lies
    (two arrays cost an interleave more)."""
    dfa = compile_regex("xyzzy")
    trans, accept = dfa_tables(dfa, cuda)
    table = _strings(np.random.default_rng(5), 4096, 128).to(cuda)
    for strings in (table[:, 8:70], table[:, 8:70].contiguous()):
        ops = _device_ops(lambda: NK.regex_dfa(trans, accept, strings))
        assert len(ops) == 1 and "regex_dfa" in ops[0]
    kv = nkv.build_kvs(np.arange(1, 5000, dtype=np.uint32),
                       np.ones((4999, 1), np.float32), 256, device=cuda)
    keys, nxt = kv.keys.contiguous(), kv.nxt.contiguous()
    ops = _device_ops(lambda: NK.hash_probe(kv.heads, kv.keys, kv.nxt,
                                            keys, 40))
    assert len(ops) == 1 and "hash_probe" in ops[0]
    ops = _device_ops(lambda: NK.hash_probe(kv.heads, keys, nxt, keys, 40))
    assert len(ops) == 2 and any("hash_probe" in k for k in ops)


OPS_ODD_LAYOUTS = ["select, strided table", "regex_match, rows not "
                   "contiguous", "probe, strided columns",
                   "attention, bf16 off a 16-byte boundary"]


@pytest.mark.parametrize("case", OPS_ODD_LAYOUTS)
def test_ops_take_odd_layouts_on_card(cuda, case):
    """Each ``ops`` entry point takes on the card a layout its wrapper
    refuses (the wrapper still does, called directly), and its answer
    equals the plain twin's on the same values."""
    entry = case.split(",")[0]
    if entry == "select":
        wide = make_table(SEED, 512, 16, 0.3, device="cpu")
        t = wide.to(cuda)[:, ::2]
        with pytest.raises(ValueError):
            NK.select_scan(t, 0.0, 1.0)
        got, want = ops.select(t, 0.0, 1.0), ops.select(t.cpu(), 0.0, 1.0)
        assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
        assert torch.equal(got[1].cpu(), want[1])
    elif entry == "regex_match":
        dfa = compile_regex("xyzzy")
        trans, accept = dfa_tables(dfa, "cpu")
        s = _strings(np.random.default_rng(SEED), 3000, 62, b"xyz")
        field = s.t().contiguous().to(cuda).t()       # column-major rows
        assert field.stride(1) != 1
        with pytest.raises(ValueError):
            NK.regex_dfa(trans.to(cuda), accept.to(cuda), field)
        got = ops.regex_match(trans.to(cuda), accept.to(cuda), field)
        assert torch.equal(got.cpu(), ref.regex_dfa_ref(trans, accept, s))
    elif entry == "probe":
        rng = np.random.default_rng(SEED)
        keys = rng.integers(1, 2 ** 32, 5000, dtype=np.uint64)
        kv = nkv.build_kvs(keys.astype(np.uint32), np.ones((5000, 1),
                                                            np.float32),
                           256, device="cpu")
        q = torch.cat([kv.keys[::3], kv.keys[:100] ^ 0x5A5A])
        three = torch.stack([kv.keys, kv.nxt, kv.nxt], 1).to(cuda)
        k, nx = three[:, 0], three[:, 1]
        with pytest.raises(ValueError):
            NK.hash_probe(kv.heads.to(cuda), k, nx, q.to(cuda), 40)
        got = ops.probe(kv.heads.to(cuda), k, nx, q.to(cuda), max_chain=40)
        want = ref.hash_probe_ref(kv.heads, kv.keys, kv.nxt, q, 40)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    else:
        g = torch.Generator(device="cpu").manual_seed(SEED)
        shape = (2, 4, 256, 64)
        q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16)
                   .to(cuda) for _ in range(3))
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
        odd = flat[1:].view(shape).copy_(q)
        with pytest.raises(ValueError, match="16-byte"):
            MK.flash_attention(odd, k, v)
        got = ops.attention(odd, k, v).float()
        want = ref.flash_attention_ref(q, k, v).float()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


def test_ops_launch_their_kernel_once(cuda):
    t = make_table(SEED, 1000, 32, 0.3, device=cuda)
    dfa = compile_regex("ab")
    trans, accept = dfa_tables(dfa, cuda)
    kv = nkv.build_kvs(np.arange(1, 500, dtype=np.uint32),
                       np.ones((499, 1), np.float32), 64, device=cuda)
    for name, call in (
            ("select_scan", lambda: ops.select(t, 0.0, 1.0)),
            ("regex_dfa", lambda: ops.regex_match(
                trans, accept, t[:, :8].to(torch.uint8).contiguous())),
            ("hash_probe", lambda: ops.probe(kv.heads, kv.keys, kv.nxt,
                                             kv.keys[:300], max_chain=9))):
        NK.reset_launches()
        call()
        assert NK.launches == {k: int(k == name) for k in NK.launches}


def test_pushdown_card_equals_cpu(cuda):
    """Each pushdown entry point on the card equals the CPU's, and
    launches its kernel once per call."""
    t = make_table(SEED, 3000, 32, 0.2, device="cpu")
    NK.reset_launches()
    got = PD.pushdown_select([cuda], 3000, t.to(cuda), float("-inf"), 1.0)
    assert NK.launches == {"select_scan": 1, "regex_dfa": 0,
                           "hash_probe": 0}
    want = PD.pushdown_select(["cpu"], 3000, t, float("-inf"), 1.0)
    assert torch.equal(_bits(got.rows.cpu()), _bits(want.rows))
    assert torch.equal(got.counts.cpu(), want.counts)

    s = _strings(np.random.default_rng(1), 3000, 40, b"xyzzy ")
    table = torch.cat([torch.arange(3000)[:, None] % 256,
                       s.to(torch.int64)], 1).to(torch.int32)
    dfa = compile_regex("xyzzy")
    NK.reset_launches()
    got = PD.pushdown_regex(None, 500, dfa, table.to(cuda), 1, 41)
    assert NK.launches["regex_dfa"] == 1
    want = PD.pushdown_regex(["cpu"], 500, dfa, table, 1, 41)
    assert torch.equal(got.rows.cpu(), want.rows)
    assert torch.equal(got.counts.cpu(), want.counts)

    keys = np.arange(1, 20001, dtype=np.uint32)
    vals = np.random.default_rng(2).standard_normal((20000, 4)).astype(
        np.float32)
    q = np.random.default_rng(3).integers(1, 22500, 5000).astype(np.uint32)
    NK.reset_launches()
    got = PD.pushdown_lookup([cuda], PD.build_sharded_kvs(
        keys, vals, 1024, 1, device=cuda), q, 40)
    assert NK.launches["hash_probe"] == 1
    want = PD.pushdown_lookup(["cpu"], PD.build_sharded_kvs(
        keys, vals, 1024, 1, device="cpu"), q, 40)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g.cpu()), _bits(w))


def test_build_kvs_card_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 3000, 10000).astype(np.uint32)
    vals = np.ones((10000, 2), np.float32)
    for a, b in zip(nkv.build_kvs(keys, vals, 256, device=cuda),
                    nkv.build_kvs(keys, vals, 256, device="cpu")):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(PD.build_sharded_kvs(keys, vals, 256, 4, device=cuda),
                    PD.build_sharded_kvs(keys, vals, 256, 4, device="cpu")):
        assert a == b if isinstance(a, int) else torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
@pytest.mark.parametrize("w,block", [(32, 256), (7, 64), (8, 32)])
def test_select_scan_kernel_dtypes(cuda, dtype, w, block):
    """Every table dtype the reference's tests and ``make_table`` give;
    the bounds round to the table's dtype (0.3 is 0.30078125 in bf16), so
    rows at 0.3 and just above it tell a typed compare from an fp32 one."""
    rng = np.random.default_rng(SEED + w)
    n = 4 * block
    if dtype == torch.int32:
        t = torch.as_tensor(rng.integers(-5, 6, (n, w)).astype(np.int32))
        x, y = 0.7, 2.2                  # int32(0.7) = 0, int32(2.2) = 2
    else:
        t = torch.as_tensor(rng.standard_normal((n, w)).astype(np.float32))
        t[::4, 0] = 0.3
        t[1::4, 0] = 0.30078125
        t[2::4, 1] = 0.99
        t = t.to(dtype)
        x, y = 0.3, 1.0
    got = NK.select_scan(t.to(cuda), x, y, block)
    want = ref.select_scan_ref(t, x, y, block)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.uint8),
                       want[0].view(torch.uint8))


def test_pushdown_select_bf16_card_equals_cpu(cuda):
    t = make_table(SEED, 2000, 16, 0.3, torch.bfloat16, device="cpu")
    got = PD.pushdown_select([cuda], 0, t.to(cuda), 0.3, 1.0)
    want = PD.pushdown_select(["cpu"], 0, t, 0.3, 1.0)
    assert got.rows.shape == (1, 2000, 16)
    assert torch.equal(got.rows.cpu().view(torch.int16),
                       want.rows.view(torch.int16))
    assert torch.equal(got.counts.cpu(), want.counts)


def test_pushdown_regex_saturating_cast_on_card(cuda):
    """A float string field saturates on the card as on the CPU."""
    t = torch.full((256, 8), 97.0)
    t[:, 1:6] = torch.tensor([ord(c) for c in "xyzzy"], dtype=torch.float32)
    t[::2, 1] = 376.0              # wraps to 'x' (120) if not saturated
    t[1::4, 7] = float("nan")
    dfa = compile_regex("xyzzy")
    got = PD.pushdown_regex([cuda], 0, dfa, t.to(cuda), 0, 8)
    want = PD.pushdown_regex(["cpu"], 0, dfa, t, 0, 8)
    assert int(got.counts[0]) == int(want.counts[0]) == 128
    assert torch.equal(got.rows.cpu().view(torch.int32),
                       want.rows.view(torch.int32))


# -- the model substrate's kernels -------------------------------------------

#: ``tests/test_kernels.py``'s cases (B, Hq, Hkv, Sq, Sk, D, causal, window,
#: softcap), head dim 256 with MQA and a window, as recurrentgemma's, and
#: the edges of the tensor-core kernel's tiles (128 queries, 64 keys):
#: every head dim, ragged lengths, a window shorter than a tile, rows
#: that see no key.
ATTN_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, None),
    (1, 4, 1, 32, 64, 16, True, None, None),
    (1, 2, 2, 64, 64, 32, True, 16, None),
    (1, 2, 2, 64, 64, 32, True, None, 30.0),
    (1, 2, 2, 64, 64, 32, False, None, None),
    (1, 3, 3, 1, 64, 32, True, None, None),
    (1, 4, 1, 256, 256, 256, True, 100, None),
    (2, 2, 1, 192, 320, 64, True, 128, 50.0),
    (1, 2, 2, 130, 130, 128, True, None, None),
    (1, 2, 2, 64, 64, 32, False, 0, None),     # the last row sees no key
    (1, 2, 1, 128, 64, 64, True, 16, None),    # Sq > Sk: 64 dead rows
    (2, 16, 1, 320, 320, 256, True, 100, 30.0),
    (1, 4, 2, 1, 300, 128, True, None, None),
    (1, 2, 2, 200, 200, 16, False, 50, None),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _normal(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           ).to(dtype)


def _attention_want(q, k, v, causal, window, cap):
    """The plain version, with the kernels' dead-row rule (the Pallas
    kernel's): a row whose every key is masked is 0, where the dense
    softmax spreads it evenly."""
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    Sq, Sk = q.shape[2], k.shape[2]
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= (qi - kj) < window
    want[:, :, ~keep.any(-1)] = 0
    return want


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, case, dtype):
    B, Hq, Hkv, Sq, Sk, D, causal, window, cap = case
    rng = np.random.default_rng(SEED + Sq + D)
    q = _normal(rng, (B, Hq, Sq, D), dtype).to(cuda)
    k = _normal(rng, (B, Hkv, Sk, D), dtype).to(cuda)
    v = _normal(rng, (B, Hkv, Sk, D), dtype).to(cuda)
    MK.reset_launches()
    got = MK.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    assert MK.launches["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = _attention_want(q, k, v, causal, window, cap)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,runs,not_runs", [
    (torch.bfloat16, "models_flash_attention_tc", "models_flash_attention"),
    (torch.float32, "models_flash_attention", "models_flash_attention_tc")])
def test_flash_attention_kernel_by_dtype(cuda, dtype, runs, not_runs):
    """bf16 runs the tensor-core kernel and fp32 the CUDA-core one, both
    counted as ``flash_attention``: the wrapper's count per C entry point
    names the kernel that ran, and the output agrees with the plain
    version at the dtype's tolerance."""
    q = torch.randn((1, 4, 256, 128), device=cuda).to(dtype)
    k = torch.randn((1, 1, 256, 128), device=cuda).to(dtype)
    MK.reset_launches()
    got = MK.flash_attention(q, k, k, window=100)
    torch.cuda.synchronize()
    assert MK.symbol_launches[runs] == 1, MK.symbol_launches
    assert MK.symbol_launches[not_runs] == 0, MK.symbol_launches
    assert MK.launches["flash_attention"] == 1
    want = _attention_want(q, k, k, True, 100, None)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,D", [(2, 64, 32), (1, 128, 64), (3, 32, 16),
                                   (2, 100, 40), (4, 2048, 256),
                                   (1, 33, 7),       # odd D
                                   (2, 5, 64),       # S below one chunk
                                   (2, 300, 128),    # S past super-chunks
                                   (3, 70, 66)])     # D past 64-channel CTAs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel(cuda, B, S, D, dtype):
    rng = np.random.default_rng(SEED + S)
    x = _normal(rng, (B, S, D), dtype).to(cuda)
    a = torch.sigmoid(_normal(rng, (B, S, D), torch.float32)).to(dtype)
    MK.reset_launches()
    got = MK.rglru_scan(x, a.to(cuda))
    assert MK.launches["rglru_scan"] == 1
    want = ref.rglru_scan_ref(x, a.to(cuda))
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("near", ["one", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_extreme_decay(cuda, near, dtype):
    """Long memory (a near 1: the chunks' carries dominate) and none (a
    near 0) over S=2048."""
    rng = np.random.default_rng(SEED)
    x = _normal(rng, (2, 2048, 128), dtype).to(cuda)
    u = rng.random((2, 2048, 128)).astype(np.float32)
    a = torch.as_tensor(1 - 2e-3 * u if near == "one" else 1e-2 * u)
    a = a.to(dtype).to(cuda)
    got = MK.rglru_scan(x, a)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), ref.rglru_scan_ref(x, a).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_unaligned(cuda, dtype):
    """x one element past a pair's alignment: channels one at a time."""
    rng = np.random.default_rng(SEED)
    flat = _normal(rng, (2 * 300 * 64 + 1,), dtype).to(cuda)
    x = flat[1:].view(2, 300, 64)
    a = torch.sigmoid(_normal(rng, (2, 300, 64), torch.float32)).to(dtype)
    got = MK.rglru_scan(x, a.to(cuda))
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(
        got.float(), ref.rglru_scan_ref(x, a.to(cuda)).float(), atol=tol,
        rtol=tol)


#: the training path's plain twins, card against CPU in fp32: values at
#: the kernels' fp32 tolerances, gradients at the CPU tests'
#: (``tests/test_torch_train.py``).
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _grads_on(device, fn, inputs, ct):
    """(fn's output on ``device``, the gradients of <out, ct> in the
    inputs), both back on the CPU."""
    xs = [t.detach().to(device).requires_grad_(True) for t in inputs]
    out = fn(*xs)
    (out * ct.to(device)).sum().backward()
    return out.detach().cpu(), [t.grad.cpu() for t in xs]


@pytest.mark.parametrize("S", [1000, 4096])
def test_chunked_rglru_twin_on_card_equals_cpu(cuda, S):
    rng = np.random.default_rng(SEED + S)
    x = _normal(rng, (2, S, 64), torch.float32)
    a = torch.as_tensor((1e-4 + 0.9998 * rng.random((2, S, 64))).astype(
        np.float32))
    a[:, ::7, :8] = 0.0                       # the state wiped
    ct = _normal(rng, (2, S, 64), torch.float32)
    want, gw = _grads_on("cpu", ref.rglru_scan_ref, (x, a), ct)
    got, gg = _grads_on(cuda, ref.rglru_scan_ref, (x, a), ct)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)
    for g, w in zip(gg, gw):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("kv_length", [None, 100])
def test_chunked_attention_grads_on_card_equal_cpu(cuda, kv_length):
    """Each query block recomputed in the backward, on the card as on the
    CPU (TF32 off, as the training checks run)."""
    rng = np.random.default_rng(SEED)
    q, k, v, ct = (_normal(rng, s, torch.float32) for s in (
        (2, 4, 128, 32), (2, 2, 128, 32), (2, 2, 128, 32), (2, 4, 128, 32)))
    kw = dict(window=48, softcap=30.0, kv_length=kv_length, chunk_q=32,
              chunk_k=64)

    def attn(q, k, v):
        return ref.chunked_attention(q, k, v, **kw)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, gw = _grads_on("cpu", attn, (q, k, v), ct)
        got, gg = _grads_on(cuda, attn, (q, k, v), ct)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    for g, w in zip(gg, gw):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_chunked_attention_saves_no_tile_on_card(cuda):
    """At B=1, 4 query heads over 2 kv heads, S=4096, D=64, fp32 the
    backward keeps at most 32 MB (every tile kept: 895.3 MB)."""
    q, k, v = (torch.randn(s, device=cuda, requires_grad=True) for s in (
        (1, 4, 4096, 64), (1, 2, 4096, 64), (1, 2, 4096, 64)))
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ref.chunked_attention(q, k, v)
    assert 0 < sum(seen) <= 32e6, sum(seen)
    out.sum().backward()
    assert all(bool(t.grad.isfinite().all()) for t in (q, k, v))


def test_model_kernels_refuse_wrong_inputs(cuda):
    q = torch.zeros((1, 2, 64, 32), device=cuda)
    with pytest.raises(TypeError):
        MK.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        MK.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        MK.flash_attention(q, q[:, :1], q)             # v shape differs
    with pytest.raises(ValueError):
        MK.flash_attention(q, q[:, :, :, :16].contiguous(), q[..., :16])
    with pytest.raises(ValueError):
        MK.flash_attention(q[..., :24].contiguous(),
                           q[..., :24].contiguous(), q[..., :24].contiguous())
    with pytest.raises(ValueError):
        MK.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                           q.transpose(2, 3))
    with pytest.raises(ValueError):
        MK.flash_attention(q, q.cpu(), q)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(q.shape)            # 2 bytes past a 16-byte edge
    with pytest.raises(ValueError, match="16-byte"):
        MK.flash_attention(odd, q.bfloat16(), q.bfloat16())
    x = torch.zeros((2, 16, 8), device=cuda)
    with pytest.raises(TypeError):
        MK.rglru_scan(x.half(), x.half())
    with pytest.raises(ValueError):
        MK.rglru_scan(x, x[:, :8])
    with pytest.raises(ValueError):
        MK.rglru_scan(x.transpose(1, 2), x.transpose(1, 2))


def _to(tree, dev):
    """A copy of a tree of dicts, lists and tuples of tensors on dev."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-9b", "granite-34b",
                                  "nemotron-4-340b", "chameleon-34b",
                                  "recurrentgemma-9b", "granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b", "rwkv6-3b",
                                  "whisper-small"])
def test_model_card_equals_cpu(cuda, arch):
    """A smoke config's forward and decode on the card (kernels) equal the
    CPU's (plain versions) on the same parameters, with one
    ``flash_attention`` per attention block (the encoder's and the cross
    blocks among them) and one ``rglru_scan`` per recurrent block in a
    forward."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_p = T.init_params(cfg, generator=gen, device="cpu")
    card_p = _to(cpu_p, cuda)
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
    frames = cross_c = cross_g = None
    if cfg.encoder is not None:
        frames = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    MK.reset_launches()
    got = T.forward(card_p, cfg, toks.to(cuda),
                    frames=None if frames is None else frames.to(cuda))
    kinds = T.layer_kinds(cfg)
    n_attn = sum(k in ("ga", "la") for k in kinds)
    if cfg.encoder is not None:
        n_attn += cfg.encoder.n_layers + cfg.n_superlayers
    assert MK.launches == {"flash_attention": n_attn,
                           "rglru_scan": kinds.count("rg")}
    want = T.forward(cpu_p, cfg, toks, frames=frames)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    if cfg.encoder is not None:
        cross_c = T.cross_kv(cpu_p, cfg, T.encode(cpu_p, cfg, frames))
        cross_g = _to(cross_c, cuda)
    st_g = T.init_decode_state(cfg, 2, 12, cuda)
    st_c = T.init_decode_state(cfg, 2, 12, "cpu")
    for t in range(12):
        lg_g, st_g = T.decode_step(card_p, cfg, toks[:, t].to(cuda), t, st_g,
                                   cross=cross_g)
        lg_c, st_c = T.decode_step(cpu_p, cfg, toks[:, t], t, st_c,
                                   cross=cross_c)
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=2e-4, rtol=2e-4)


def test_moe_dispatch_positions_card_equals_cpu(cuda):
    """Slot positions bit for bit on the card at a full-width prefill's
    T * k = 65,536 slots over 32 experts, and the block deterministic:
    two calls give the same bits."""
    from repro_torch.models import moe as tmoe
    rng = np.random.default_rng(SEED)
    flat_e = torch.as_tensor(np.minimum(rng.geometric(0.08, 65_536) - 1, 31))
    want = tmoe.dispatch_positions(flat_e, 32, 2560)
    got = tmoe.dispatch_positions(flat_e.to(cuda), 32, 2560)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = tmoe.moe_params(torch.Generator(device=cuda).manual_seed(1), cfg,
                        torch.bfloat16, cuda)
    x = torch.randn((4, 64, cfg.d_model), device=cuda).bfloat16()
    a, _ = tmoe.moe_block(p, cfg, x)
    b, _ = tmoe.moe_block(p, cfg, x)
    assert torch.equal(a, b)


# -- the two-node engine, the coherent store and int8 serving ---------------

@pytest.mark.parametrize("moesi,stateless", [(True, False), (False, False),
                                             (False, True)])
def test_two_node_step_card_equals_cpu(cuda, moesi, stateless):
    """30 steps of a random program with home wants, every state leaf and
    output equal to the CPU's, with 3 ``credit_rank`` and 4 ``count_fold``
    launches a step and no other kernel."""
    from repro_torch.convert import flatten
    from repro_torch.core.engine import Engine
    L, B, steps = 64, 4, 30
    rng = np.random.default_rng(SEED)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    eng_g = Engine(backing, moesi=moesi, stateless=stateless, device=cuda)
    eng_c = Engine(backing, moesi=moesi, stateless=stateless, device="cpu")
    sg, sc = eng_g.init(), eng_c.init()
    K.reset_launches()
    for t in range(steps):
        op = np.zeros(L, np.int8)
        if t < 20:
            op[rng.choice(L, 8, replace=False)] = rng.choice(
                [1] if stateless else [1, 2, 3, 4], 8)
        val = rng.normal(size=(L, B)).astype(np.float32)
        wr = (rng.random(L) < 0.1) & (t < 20)
        ww = (rng.random(L) < 0.1) & (t < 20) & (not stateless)
        wv = rng.normal(size=(L, B)).astype(np.float32)
        args = [torch.as_tensor(a) for a in (op, val, wr, ww, wv)]
        sg, og = eng_g.step(sg, *[a.to(cuda) for a in args])
        sc, oc = eng_c.step(sc, *args)
        for tree_g, tree_c in ((sg, sc), (og, oc)):
            fg, fc = flatten(tree_g), flatten(tree_c)
            for k in fc:
                np.testing.assert_array_equal(fg[k], fc[k],
                                              err_msg=f"step {t}: {k}")
    assert {k: v for k, v in K.launches.items() if v} == \
        {"credit_rank": 3 * steps, "count_fold": 4 * steps}


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("name", ["full_moesi", "enhanced_mesi", "read_only",
                                  "stateless"])
def test_coherent_store_card_equals_cpu(cuda, name, R):
    from repro_torch.convert import flatten
    from repro_torch.core import SUBSETS, CoherentStore
    L, B = 64, 4
    rng = np.random.default_rng(SEED + R)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    stores = [CoherentStore(backing, SUBSETS[name], n_remotes=R,
                            operator=lambda b: b * 3.0, device=d)
              for d in (cuda, "cpu")]
    writes = name in ("full_moesi", "enhanced_mesi")
    wval = rng.normal(size=(L // 2, B)).astype(np.float32)
    got = []
    for cs in stores:
        vals = [cs.read(list(range(L)), node=0), cs.read([1, 2], node=R - 1)]
        if writes:
            cs.write(list(range(0, L, 2)), wval, node=0)
            cs.evict(list(range(0, L, 4)), node=0)
            vals.append(cs.home_read(list(range(0, L, 2))))
        for node in {0, R - 1}:
            cs.evict([1, 2], node=node)
        cs.home_write([1], np.ones((1, B), np.float32))
        vals.append(cs.read([1, 2], node=0))
        got.append(([v.cpu() for v in vals], flatten(cs.state),
                    cs.interconnect_messages, cs.hits, cs.misses,
                    cs.payload_bytes))
    (vg, fg, *ag), (vc, fc, *ac) = got
    for a, b in zip(vg, vc):
        assert torch.equal(a, b)
    for k in fc:
        np.testing.assert_array_equal(fg[k], fc[k], err_msg=k)
    assert ag == ac


def test_quantize_weight_card_equals_cpu(cuda):
    from repro_torch.serve.quantize import quantize_weight
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.as_tensor(rng.standard_normal((256, 384)).astype(
            np.float32)).to(dtype)
        got, want = quantize_weight(w.to(cuda)), quantize_weight(w)
        assert torch.equal(got["q"].cpu(), want["q"])
        assert torch.equal(got["s"].cpu().view(torch.int32),
                           want["s"].view(torch.int32))


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan"])
def test_kernel_refuses_input_that_requires_grad(cuda, name):
    """A kernel has no backward: on the card its wrapper raises rather
    than return an output cut off from the graph, and runs under
    ``torch.no_grad()``."""
    if name == "flash_attention":
        t = torch.randn((1, 2, 128, 64), device=cuda)

        def call(x):
            return MK.flash_attention(x, x, x)
    else:
        t = torch.randn((1, 128, 128), device=cuda)
        a = torch.rand((1, 128, 128), device=cuda)

        def call(x):
            return MK.rglru_scan(x, a)
    t.requires_grad_(True)
    before = dict(MK.launches)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        call(t)
    assert MK.launches == before
    with torch.no_grad():
        out = call(t)
    assert not out.requires_grad
    assert MK.launches[name] == before[name] + 1


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m", "whisper-small"])
def test_train_grads_card_equal_cpu(cuda, arch):
    """``loss_fn``'s loss and every gradient leaf in fp32, card against
    CPU on the same parameters and batch, at the CPU tests' tolerances
    (loss 1e-5; gradients atol 1e-5, rtol 1e-4); the training path
    launches no kernel."""
    from repro_torch.train.train_step import _value_and_grad
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(SEED)
    params = T.init_params(cfg, generator=gen, device="cpu")
    mb = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                                  dtype=torch.int32),
          "targets": torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                                   dtype=torch.int32)}
    if cfg.encoder is not None:
        mb["frames"] = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                                   generator=gen)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lc, _, gc = _value_and_grad(cfg, params, mb)
        MK.reset_launches()
        lg, _, gg = _value_and_grad(cfg, tree_map(lambda p: p.to(cuda),
                                                  params),
                                    {k: v.to(cuda) for k, v in mb.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert sum(MK.launches.values()) == 0
    assert abs(float(lg) - float(lc)) <= 1e-5
    for a, b in zip(leaves(gg), leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)


@pytest.fixture
def mesh1(cuda):
    """A one-device NCCL mesh (a world of one, ended afterwards)."""
    from repro_torch.launch.mesh import close, make_local_mesh
    mesh = make_local_mesh(("pod", "data", "model"), device=cuda)
    yield mesh
    close()


@pytest.mark.parametrize("mode,micro", [("2d", 1), ("fsdp", 2)])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_make_train_step_on_card_equals_train_step(mesh1, arch, mode,
                                                   micro):
    """On a one-device NCCL mesh every collective is a copy: two steps of
    ``make_train_step`` equal ``train_step``'s bit for bit."""
    import torch.distributed as dist
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, make_train_step, train_step
    from repro_torch.tree import leaves
    assert dist.get_backend() == "nccl"
    cfg = get_config(arch, smoke=True)
    dev = torch.device("cuda")
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "targets")}
    ocfg = OptimConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, ocfg, mesh1, params, micro,
                           sharding_mode=mode)
    a, b = init_state(params), init_state(params)
    for _ in range(2):
        a, ma = train_step(cfg, ocfg, micro, a, batch)
        b, mb = step(b, batch)
        for k in ("loss", "lr", "grad_norm"):
            assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y.full_tensor())


def test_filtered_batch_on_card_equals_pushdown_select(mesh1):
    """``filtered_batch`` over the mesh's ``data`` axis (one shard) is
    ``pushdown_select`` over the card bit for bit, and launches
    ``select_scan`` once."""
    from repro_torch.data.pipeline import filtered_batch
    table = make_table(SEED, 1 << 16, 32, 0.1, device="cuda")
    want = PD.pushdown_select(["cuda"], 4096, table, 0.0, 1.0)
    before = NK.launches["select_scan"]
    got = filtered_batch(mesh1, "data", table, 0.0, 1.0, 4096)
    assert NK.launches["select_scan"] == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(got.moved_rows) > 0


def test_kernel_wrappers_refuse_dtensor_on_card(mesh1):
    """A DTensor on the card is refused, not read as its local block."""
    from repro_torch.launch import sharding as sh
    table = sh.distribute(make_table(SEED, 1024, 8, 0.1, device="cuda"),
                          mesh1, sh.P("data", None))
    q = sh.distribute(torch.zeros((1, 2, 64, 64), device="cuda"), mesh1,
                      sh.P())
    before = dict(NK.launches), dict(MK.launches)
    with pytest.raises(TypeError, match="select_scan: a DTensor"):
        NK.select_scan(table, 0.0, 1.0)
    with pytest.raises(TypeError, match="flash_attention: a DTensor"):
        MK.flash_attention(q, q.to_local(), q.to_local())
    assert (dict(NK.launches), dict(MK.launches)) == before
