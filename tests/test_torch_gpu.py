"""The port on the card: each CUDA kernel against its plain version, and
the card's streaming run against the CPU's, bit for bit.

Every test here needs a CUDA device and ``nvcc``; it carries the ``gpu``
marker and skips elsewhere.  The file imports nothing of JAX or of
``repro``, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \
        tests/test_torch_gpu.py
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import coherency_step as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.traffic import (EngineConfig, StreamConfig,  # noqa: E402
                                 WorkloadSpec, run_stream, validate_run)

pytestmark = pytest.mark.gpu

SEED = 99


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bools(rng, shape, p):
    return torch.as_tensor(rng.random(shape) < p)


@pytest.mark.parametrize("shape", [(16,), (8, 16), (4, 8, 16), (3, 33),
                                   (1, 1), (64, 4096), (5, 4097)])
def test_credit_rank_kernel(cuda, shape):
    rng = np.random.default_rng(SEED)
    a = _bools(rng, shape, 0.4)
    c = _bools(rng, shape, 0.3) & ~a
    got = K.credit_rank(a.to(cuda), c.to(cuda)).cpu()
    assert torch.equal(got, ref.credit_rank_ref(a, c))


@pytest.mark.parametrize("P,L,lead", [(3, 16, ()), (65, 32, ()),
                                      (5, 8, (4,)), (65, 1, ()),
                                      (65, 4096, ())])
def test_arb_winner_kernel(cuda, P, L, lead):
    rng = np.random.default_rng(SEED + P)
    r = _bools(rng, lead + (P, L), 0.3)
    r[..., :3] = False                # nobody ready: the fill-value ties
    rr = torch.as_tensor(rng.integers(0, P, lead + (L,)).astype(np.int32))
    got = K.arb_winner(r.to(cuda), rr.to(cuda)).cpu()
    assert torch.equal(got, ref.arb_winner_ref(r, rr))


@pytest.mark.parametrize("all_false", [False, True])
@pytest.mark.parametrize("shape", [(8, 16), (5, 7), (33,), (64, 4096),
                                   (4096,)])
def test_count_fold_kernel(cuda, shape, all_false):
    rng = np.random.default_rng(SEED)
    m = _bools(rng, shape, 0.0 if all_false else 0.5)
    g = torch.as_tensor(rng.integers(0, 16, shape).astype(np.int8))
    g.view(-1)[::7] = 100             # the HOME_TXN sentinel: no bin
    p = _bools(rng, shape, 0.5)
    gc, gp = K.count_fold(m.to(cuda), g.to(cuda), p.to(cuda))
    wc, wp = ref.count_fold_ref(m, g, p)
    assert torch.equal(gc.cpu(), wc) and int(gp) == int(wp)


@pytest.mark.parametrize("R,L", [(4, 16), (3, 7), (1, 1), (64, 4096)])
def test_lat_hist_kernel(cuda, R, L):
    rng = np.random.default_rng(SEED)
    lat = torch.as_tensor(rng.integers(-4, 600, (R, L)).astype(np.int32))
    ret = _bools(rng, (R, L), 0.5)
    got = K.lat_hist(lat.to(cuda), ret.to(cuda)).cpu()
    assert torch.equal(got, ref.lat_hist_ref(lat, ret, K.LAT_EDGES))


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
