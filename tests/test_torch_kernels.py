"""The coherency-step kernels of the port: plain versions against the
reference's, and the wrappers' dispatch on the CPU.

The plain PyTorch versions (``repro_torch.kernels.ref``) must equal
``repro.kernels.ref`` — the engine's own expressions — on the same numpy
inputs, including the ragged, P=65 and negative-latency shapes of
``tests/test_coherency_kernels.py``.  Integer arithmetic: bit-exact.
The CUDA kernels themselves are tested on the card in
``tests/test_torch_gpu.py``.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.traffic.counters import LAT_EDGES  # noqa: E402
from repro_torch.kernels import coherency_step as K  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SEED = 1234
EDGES = tuple(int(e) for e in LAT_EDGES)
CUDA_SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src"
               / "repro_torch" / "csrc" / "coherency_step.cu")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _credit_inputs(shape, seed=SEED):
    rng = np.random.default_rng(seed)
    active = rng.random(shape) < 0.4
    cand = (rng.random(shape) < 0.3) & ~active
    return active, cand


def _arb_inputs(P, L, lead, seed):
    rng = np.random.default_rng(seed)
    ready = rng.random(lead + (P, L)) < 0.3
    ready[..., :3] = False            # lines with nobody ready: fill ties
    arb = rng.integers(0, P, lead + (L,)).astype(np.int32)
    return ready, arb


def _count_inputs(shape, seed=SEED, all_false=False):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < 0.5
    if all_false:
        mask[...] = False
    msg = rng.integers(0, 16, shape).astype(np.int8)
    pay = rng.random(shape) < 0.5
    return mask, msg, pay


def _lat_inputs(R, L, seed=SEED):
    rng = np.random.default_rng(seed)
    # negative latencies (an un-born in-flight lane) and values straddling
    # every bucket edge.
    lat = rng.integers(-4, 600, (R, L)).astype(np.int32)
    retired = rng.random((R, L)) < 0.5
    return lat, retired


CREDIT_SHAPES = [(16,), (8, 16), (4, 8, 16), (3, 33), (64, 128), (1, 1)]
ARB_CASES = [(3, 16, ()), (9, 16, ()), (65, 32, ()), (5, 8, (4,)),
             (65, 1, ())]
COUNT_SHAPES = [(8, 16), (4, 8, 16), (5, 7), (33,)]
LAT_SHAPES = [(4, 16), (8, 32), (3, 7), (1, 1)]


@pytest.mark.parametrize("shape", CREDIT_SHAPES)
def test_credit_rank_plain_equals_reference(shape):
    active, cand = _credit_inputs(shape)
    want = np.asarray(jref.credit_rank_ref(active, cand))
    got = tref.credit_rank_ref(_t(active), _t(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,L,lead", ARB_CASES)
def test_arb_winner_plain_equals_reference(P, L, lead):
    ready, arb = _arb_inputs(P, L, lead, SEED + P)
    want = np.asarray(jref.arb_winner_ref(ready, arb))
    got = tref.arb_winner_ref(_t(ready), _t(arb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("all_false", [False, True])
@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_count_fold_plain_equals_reference(shape, all_false):
    mask, msg, pay = _count_inputs(shape, all_false=all_false)
    wc, wp = jref.count_fold_ref(mask, msg, pay)
    gc, gp = tref.count_fold_ref(_t(mask), _t(msg), _t(pay))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gp) == int(wp)
    assert gc.dtype == torch.int32 and gp.dtype == torch.int32


def test_count_fold_ignores_codes_outside_msgtype():
    """The home's HOME_TXN sentinel (100) is an int8 code outside 0..15:
    like the reference's one-hot compare, the fold puts it in no bin."""
    msg = np.asarray([100, 1, 100, 15], np.int8)
    mask = np.ones(4, bool)
    pay = np.ones(4, bool)
    wc, wp = jref.count_fold_ref(mask, msg, pay)
    gc, gp = tref.count_fold_ref(_t(mask), _t(msg), _t(pay))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gp) == int(wp) == 4


@pytest.mark.parametrize("R,L", LAT_SHAPES)
def test_lat_hist_plain_equals_reference(R, L):
    lat, retired = _lat_inputs(R, L)
    want = np.asarray(jref.lat_hist_ref(lat, retired, EDGES))
    got = tref.lat_hist_ref(_t(lat), _t(retired), EDGES)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers return the plain results and launch
    nothing."""
    K.reset_launches()
    a, c = _credit_inputs((8, 16))
    assert torch.equal(K.credit_rank(_t(a), _t(c)),
                       tref.credit_rank_ref(_t(a), _t(c)))
    r, rr = _arb_inputs(9, 16, (), 1)
    assert torch.equal(K.arb_winner(_t(r), _t(rr)),
                       tref.arb_winner_ref(_t(r), _t(rr)))
    m, g, p = _count_inputs((8, 16))
    for x, y in zip(K.count_fold(_t(m), _t(g), _t(p)),
                    tref.count_fold_ref(_t(m), _t(g), _t(p))):
        assert torch.equal(x, y)
    lat, ret = _lat_inputs(4, 16)
    assert torch.equal(K.lat_hist(_t(lat), _t(ret)),
                       tref.lat_hist_ref(_t(lat), _t(ret), EDGES))
    assert all(v == 0 for v in K.launches.values())


def test_cuda_lat_hist_edges_are_the_reference_edges():
    """The CUDA ``lat_hist`` buckets by edges fixed at compile time; they
    must be the reference's ``LAT_EDGES``, as the wrapper's are."""
    m = re.search(r"edges\[kLatEdges\] = \{([^}]*)\}",
                  CUDA_SOURCE.read_text())
    assert m is not None
    assert tuple(int(x) for x in m.group(1).split(",")) == EDGES
    assert K.LAT_EDGES == EDGES
