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


def _count_codes(shape, seed):
    """Codes of every kind: in 0..15, the HOME_TXN sentinel 100, other
    codes past 15 and negative int8 values."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(-128, 128, shape).astype(np.int8)
    msg = np.where(rng.random(shape) < 0.6, rng.integers(0, 16, shape),
                   msg).astype(np.int8)
    msg.reshape(-1)[::7] = 100
    return msg


@pytest.mark.parametrize("all_false", [False, True])
@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_count_fold_base_adds_the_reference_delta(shape, all_false):
    """``base=(c0, p0)`` gives ``c0 + delta`` and ``p0 + payload delta``
    of the reference's fold, bit for bit, on codes of every kind; on CPU
    tensors the wrapper returns the same."""
    mask, _, pay = _count_inputs(shape, all_false=all_false)
    msg = _count_codes(shape, SEED + len(shape))
    rng = np.random.default_rng(SEED + 7)
    c0 = rng.integers(0, 2 ** 20, 16).astype(np.int32)
    p0 = np.int32(rng.integers(0, 2 ** 20))
    wc, wp = jref.count_fold_ref(mask, msg, pay)
    base = (_t(c0), torch.tensor(p0))
    gc, gp = tref.count_fold_ref(_t(mask), _t(msg), _t(pay), base=base)
    np.testing.assert_array_equal(gc.numpy(), c0 + np.asarray(wc))
    assert int(gp) == int(p0) + int(wp)
    assert gc.dtype == torch.int32 and gp.dtype == torch.int32
    assert gc.shape == (16,) and gp.shape == ()
    kc, kp = K.count_fold(_t(mask), _t(msg), _t(pay), base=base)
    assert torch.equal(kc, gc) and torch.equal(kp, gp)


def _words(planes):
    """[G, 4] uint64 little-endian words of 16-lane groups of byte planes
    (zero past the end), as the CUDA kernels load them."""
    flat = np.asarray(planes).reshape(-1).view(np.uint8)
    pad = np.zeros(-(-flat.size // 16) * 16, np.uint8)
    pad[:flat.size] = flat
    return pad.reshape(-1, 4, 4).astype(np.uint64) @ \
        (np.uint64(1) << np.arange(0, 32, 8, dtype=np.uint64))


def _count_fold_emulation(mask, msg, pay):
    """``count_fold_kernel``'s arithmetic (``csrc/coherency_step.cu``),
    one 16-lane group at a time: each lane's shift of 4 * code (64 or more
    when it does not count), ``1 << shift`` into the 4-bit fields of two
    words per 8 lanes (a shift of 32 or more gives 0, as PTX clamps it),
    widened to byte fields, popcounts for the payload."""
    m, c, p = _words(mask), _words(msg), _words(pay)
    high = (((c >> 4) & 0x0F0F0F0F) + 0x0F0F0F0F) & 0x10101010
    off = ((m ^ 0x01010101) & 0x01010101) << 4
    shifts = ((c & 0x0F0F0F0F) | high | off) << 2
    lo = np.zeros(m.shape, np.uint64)
    hi = np.zeros(m.shape, np.uint64)
    for e in range(4):
        se = (shifts >> np.uint64(8 * e)) & np.uint64(0xff)
        for acc, s in ((lo, se), (hi, se ^ np.uint64(32))):
            acc += np.where(s < 32, np.uint64(1) << np.minimum(s, 31), 0)
    assert (lo >> 32 == 0).all() and (hi >> 32 == 0).all()
    half = [(w[:, 0] + w[:, 1], w[:, 2] + w[:, 3]) for w in (lo, hi)]
    n4 = np.uint64(0x0F0F0F0F)
    fields = [a & n4 for a in half[0]] + [(a >> 4) & n4 for a in half[0]] \
        + [a & n4 for a in half[1]] + [(a >> 4) & n4 for a in half[1]]
    b = [fields[0] + fields[1], fields[2] + fields[3], fields[4] + fields[5],
         fields[6] + fields[7]]
    hist = np.zeros(16, np.int64)
    for i in range(4):
        for j, base in ((0, 2 * i), (1, 2 * i + 1), (2, 8 + 2 * i),
                        (3, 9 + 2 * i)):
            byte = (b[j] >> np.uint64(8 * i)) & np.uint64(0xff)
            assert (byte <= 16).all()
            hist[base] += int(byte.sum())
    pays = sum(int(np.bitwise_count(m[:, i] & p[:, i]).sum())
               for i in range(4))
    return hist, pays


@pytest.mark.parametrize("shape", COUNT_SHAPES + [(64, 256)])
def test_count_fold_kernel_arithmetic_equals_reference(shape):
    """The CUDA kernel's branch-free counting, emulated on the CPU, equals
    the reference's fold on codes of every kind."""
    mask, _, pay = _count_inputs(shape)
    msg = _count_codes(shape, SEED + 3)
    wc, wp = jref.count_fold_ref(mask, msg, pay)
    hist, pays = _count_fold_emulation(mask, msg, pay)
    np.testing.assert_array_equal(hist, np.asarray(wc))
    assert pays == int(wp)


def _credit_rank_emulation(active, cand):
    """``credit_rank_kernel``'s arithmetic for rows that start on a
    16-byte edge: each 16-lane group's planes as 16-bit masks (a product
    gathers a word's 4 bytes into its top nibble), per-parity popcounts
    with 0x5555 / 0xAAAA, the groups' candidate counts scanned."""
    rows, L = active.shape
    gather = np.uint64(0x10204080)
    out = np.zeros((rows, L), np.int64)
    for r in range(rows):
        bits = []
        for plane in (active[r], cand[r]):
            w = _words(plane)
            nib = ((w * gather) & np.uint64(0xFFFFFFFF)) >> np.uint64(28)
            bits.append((nib << (np.arange(4, dtype=np.uint64) * 4)).sum(1))
        am, cm = bits
        X, Y = np.uint64(0x5555), np.uint64(0xAAAA)
        occ = [int(np.bitwise_count(am & X).sum()),
               int(np.bitwise_count(am & Y).sum())]
        cx = np.bitwise_count(cm & X).astype(np.int64)
        cy = np.bitwise_count(cm & Y).astype(np.int64)
        before = [np.cumsum(cx) - cx, np.cumsum(cy) - cy]
        for j in range(16):
            below = cm & np.uint64((1 << j) - 1)
            cls = j & 1
            v = occ[cls] + before[cls] + np.bitwise_count(
                below & (Y if cls else X))
            lanes = np.arange(len(am)) * 16 + j
            keep = lanes < L
            out[r, lanes[keep]] = v[keep]
    return out


@pytest.mark.parametrize("shape", [(8, 16), (3, 33), (4, 128), (2, 4096)])
def test_credit_rank_kernel_arithmetic_equals_reference(shape):
    """The CUDA kernel's bitmask counting and scan, emulated on the CPU,
    equal the reference's credit rank."""
    active, cand = _credit_inputs(shape)
    want = np.asarray(jref.credit_rank_ref(active, cand))
    np.testing.assert_array_equal(_credit_rank_emulation(active, cand),
                                  want)


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
