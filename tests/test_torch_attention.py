"""The model substrate's kernel twins and entry points against ``repro``.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernels in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs them, and the
pure-jnp oracles of ``repro.kernels.ref``) and through ``repro_torch``'s
counterparts on the CPU, where each kernel wrapper runs its plain
version: ``flash_attention_ref``, ``chunked_attention`` (with and without
``kv_length``) and ``rglru_scan_ref``, then ``ops.attention`` and
``ops.rglru`` with the reference's routing.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 (attention) and 3e-5 (RG-LRU) in fp32,
2e-2 and 3e-2 in bf16.  The training path's side of the two twins:
``chunked_attention`` recomputes each query block in the backward (the
bytes it saves, its output under grad bit for bit, its gradients
against ``jax.grad``), and ``rglru_scan_ref`` scans in chunks with no
loop over the tokens (across chunk edges, with gates at and near 0 and
near 1, its gradients, its aten operations a call), gradients at 1e-5
abs / 1e-4 rel.  The CUDA kernels themselves are held against
their plain versions on the card in ``tests/test_torch_gpu.py``.
"""
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import models as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 616

#: ``tests/test_kernels.py``'s attention cases: B, Hq, Hkv, Sq, Sk, D,
#: causal, window, softcap.
ATTN_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, None),
    (1, 4, 1, 32, 64, 16, True, None, None),     # MQA + longer KV
    (1, 2, 2, 64, 64, 32, True, 16, None),       # sliding window
    (1, 2, 2, 64, 64, 32, True, None, 30.0),     # gemma2 softcap
    (1, 2, 2, 64, 64, 32, False, None, None),    # bidirectional (encoder)
    (1, 3, 3, 1, 64, 32, True, None, None),      # decode
]
#: ``tests/test_kernels.py``'s RG-LRU shapes: B, S, D.
RGLRU_CASES = [(2, 64, 32), (1, 128, 64), (3, 32, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RGLRU_TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


def _qkv(case, dtype, seed=SEED):
    B, Hq, Hkv, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(seed + Sq + D)
    return [_pair(rng, s, dtype) for s in
            ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -- the plain twins against repro.kernels.ref ------------------------------

@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_ref_equals_reference(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype)
    causal, window, cap = case[6:]
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                    softcap=cap)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   softcap=cap)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("kv_length", [None, 1, 37, 96])
@pytest.mark.parametrize("case", [
    (1, 4, 2, 64, 128, 16, True, None, None),
    (2, 2, 1, 32, 128, 32, True, 48, 50.0),
    (1, 2, 2, 64, 64, 16, False, None, None),
    (1, 4, 1, 1, 96, 32, True, None, None),      # decode over a cache
    (1, 2, 2, 48, 80, 16, True, None, None),     # ragged: the dense oracle
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_attention_equals_reference(case, kv_length, dtype):
    """Small chunks, so the online softmax walks several key chunks."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype)
    causal, window, cap = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap, chunk_q=16,
              chunk_k=32)
    want = jref.chunked_attention(
        jq, jk, jv, kv_length=None if kv_length is None
        else jnp.asarray(kv_length, jnp.int32), **kw)
    got = tref.chunked_attention(tq, tk, tv, kv_length=kv_length, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("B,S,D", RGLRU_CASES + [(2, 100, 40)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_scan_ref_equals_reference(B, S, D, dtype):
    rng = np.random.default_rng(SEED + S)
    jx, tx = _pair(rng, (B, S, D), dtype)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, D)).astype(np.float32)))
    jd, td = DTYPES[dtype]
    want = jref.rglru_scan_ref(jx, jnp.asarray(a, jd))
    got = tref.rglru_scan_ref(tx, torch.as_tensor(a).to(td))
    assert got.dtype == td
    _close(got, want, RGLRU_TOL[dtype])


# -- the training path: each query block recomputed, the scan in chunks -----

#: gradients against ``jax.grad`` (``tests/test_torch_train.py``'s).
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
#: the bytes one ``chunked_attention`` call may keep for its backward at
#: B=1, 4 query heads over 2 kv heads, S=4096, D=64, fp32: its inputs
#: (8.4 MB) and a few blocks' worth; a call that kept every tile saved
#: 895.3 MB.
SAVED_BOUND = 32e6


def test_chunked_attention_saves_no_tile():
    """The bytes of the tensors autograd saves for the backward."""
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((1, 4, 4096, 64), (1, 2, 4096, 64), (1, 2, 4096, 64)))
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tref.chunked_attention(q, k, v)
    assert 0 < sum(seen) <= SAVED_BOUND, sum(seen)
    out.sum().backward()
    assert all(bool(t.grad.isfinite().all()) for t in (q, k, v))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv_length", [None, 70])
def test_chunked_attention_under_grad_is_bit_identical(dtype, kv_length):
    """The recomputed blocks run the operations of the direct ones: the
    output under grad equals the ``no_grad`` output bit for bit."""
    (_, tq), (_, tk), (_, tv) = _qkv((1, 4, 2, 64, 128, 16), dtype)
    kw = dict(window=48, softcap=20.0, kv_length=kv_length, chunk_q=16,
              chunk_k=32)
    with torch.no_grad():
        want = tref.chunked_attention(tq, tk, tv, **kw)
    q = tq.clone().requires_grad_(True)
    got = tref.chunked_attention(q, tk, tv, **kw)
    assert got.requires_grad
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv_length", [None, 37, 96])
@pytest.mark.parametrize("case", [
    (1, 4, 2, 64, 128, 16, True, None, None),    # causal, GQA
    (2, 2, 1, 32, 128, 32, True, 48, 50.0),      # window, softcap, MQA
    (1, 2, 2, 64, 64, 16, False, None, None),    # bidirectional
    (1, 4, 1, 1, 96, 32, True, None, None),      # decode over a cache
])
def test_chunked_attention_grads_equal_reference(case, kv_length):
    """Gradients of q, k and v through several query and key blocks
    against ``jax.grad`` of the reference, on one random cotangent."""
    import jax
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, "float32")
    causal, window, cap = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap, chunk_q=16,
              chunk_k=32)
    rng = np.random.default_rng(SEED + 1)
    ct = rng.standard_normal(tuple(jq.shape)).astype(np.float32)
    jkv = None if kv_length is None else jnp.asarray(kv_length, jnp.int32)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.chunked_attention(
        q, k, v, kv_length=jkv, **kw) * ct), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = tref.chunked_attention(tq, tk, tv, kv_length=kv_length, **kw)
    (out * torch.as_tensor(ct)).sum().backward()
    for got, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _decays(rng, shape, kind):
    """RG-LRU gates: uniform in (0, 1), near 0 with some exactly 0, near
    1, or all three across the channels."""
    u = rng.random(shape).astype(np.float32)
    if kind == "near zero":
        return np.where(u < 0.25, 0.0, 1e-2 * u).astype(np.float32)
    if kind == "near one":
        return (1 - 1e-3 * u).astype(np.float32)
    a = rng.random(shape).astype(np.float32)
    third = shape[-1] // 3
    a[..., :third] = np.where(u[..., :third] < 0.25, 0.0,
                              1e-2 * u[..., :third])
    a[..., third:2 * third] = 1 - 1e-3 * u[..., third:2 * third]
    return a


RGLRU_SEQS = [1, tref.RGLRU_CHUNK - 1, tref.RGLRU_CHUNK,
              tref.RGLRU_CHUNK + 1, 1000, 4096]


@pytest.mark.parametrize("S", RGLRU_SEQS)
@pytest.mark.parametrize("decay", ["near zero", "near one", "mixed"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_scan_ref_chunks_equal_reference(S, decay, dtype):
    """The chunked scan against the reference's ``lax.scan`` across the
    chunk edges, with gates that wipe the state (a = 0) and that keep it
    for thousands of tokens."""
    rng = np.random.default_rng(SEED + S)
    jx, tx = _pair(rng, (2, S, 24), dtype)
    a = _decays(rng, (2, S, 24), decay)
    jd, td = DTYPES[dtype]
    want = jref.rglru_scan_ref(jx, jnp.asarray(a, jd))
    got = tref.rglru_scan_ref(tx, torch.as_tensor(a).to(td))
    assert got.dtype == td and got.shape == tx.shape
    _close(got, want, RGLRU_TOL[dtype])


@pytest.mark.parametrize("S", [1, tref.RGLRU_CHUNK + 1, 300])
def test_rglru_scan_ref_grads_equal_reference(S):
    """Gradients of x and a against ``jax.grad`` of the reference, a in
    (0, 0.9999): d/da sqrt(1 - a^2) is infinite at a = 1 in both."""
    import jax
    rng = np.random.default_rng(SEED + S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    a = (1e-4 + (0.9999 - 2e-4) * rng.random((2, S, 16))).astype(np.float32)
    ct = rng.standard_normal((2, S, 16)).astype(np.float32)
    want = jax.grad(lambda x, a: jnp.sum(jref.rglru_scan_ref(x, a) * ct),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    tx, ta = (torch.as_tensor(t).requires_grad_(True) for t in (x, a))
    (tref.rglru_scan_ref(tx, ta) * torch.as_tensor(ct)).sum().backward()
    for got, w in zip((tx, ta), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("S", [4096, 32768])
def test_rglru_scan_ref_has_no_token_loop(S):
    """At most S / 4 aten operations a call (a loop over the tokens
    dispatched about 4 a token)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.randn((1, S, 8))
    a = torch.rand((1, S, 8))
    with Count():
        tref.rglru_scan_ref(x, a)
    assert 0 < Count.n <= S // 4, Count.n


# -- ops against the Pallas kernels (interpret mode) ------------------------

@pytest.mark.parametrize("case", ATTN_CASES + [
    (1, 2, 1, 200, 200, 16, True, None, None),   # ragged, small: dense
    (1, 2, 1, 300, 300, 16, True, 64, None),     # ragged, large: chunked
    (1, 4, 2, 256, 256, 16, True, 100, 20.0),    # two blocks of 128
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_attention_equals_reference(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype)
    causal, window, cap = case[6:]
    want = jops.attention(jq, jk, jv, causal=causal, window=window,
                          softcap=cap, use_kernel=True)
    before = dict(K.launches)
    got = tops.attention(tq, tk, tv, causal=causal, window=window,
                         softcap=cap)
    assert K.launches == before              # the CPU runs no kernel
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, ATTN_TOL[dtype])


def _tensor_core_emulation(q, k, v, causal, window, softcap, block_q=128,
                           block_k=64):
    """The tensor-core kernel's arithmetic in plain torch: bf16 q, k and
    v; 128-query by 64-key tiles; fp32 m, l and accumulator; p rounded to
    bf16 before its product with v (the one rounding the plain version
    does not make); the Pallas kernel's -1e30 and dead-row rules."""
    B, Hq, Sq, D = q.shape
    rep = Hq // k.shape[1]
    Sk = k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    out = torch.zeros((B, Hq, Sq, D))
    for q0 in range(0, Sq, block_q):
        qt = q[:, :, q0:q0 + block_q].float()
        pos = torch.arange(q0, q0 + qt.shape[2])[:, None] + (Sk - Sq)
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k0 in range(0, Sk, block_k):
            kj = torch.arange(k0, min(k0 + block_k, Sk))[None, :]
            x = qt @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * D ** -0.5
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            keep = torch.ones((qt.shape[2], kj.shape[1]), dtype=torch.bool)
            if causal:
                keep &= kj <= pos
            if window is not None:
                keep &= (pos - kj) < window
            x = torch.where(keep, x, -1e30)
            m_cur = torch.maximum(m, x.amax(-1))
            dead = m_cur <= -1e30 / 2
            p = torch.where(dead[..., None], 0.0,
                            torch.exp(x - m_cur[..., None]))
            alpha = torch.where(dead, 1.0, torch.exp(m - m_cur))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                p.bfloat16().float() @ vf[:, :, k0:k0 + block_k]
            m = m_cur
        l = torch.where(l == 0, 1.0, l)
        out[:, :, q0:q0 + block_q] = acc / l[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("case", ATTN_CASES + [
    (1, 16, 1, 256, 256, 256, True, 100, None),  # recurrentgemma's heads
    (1, 2, 1, 64, 320, 32, True, None, 30.0),    # ragged keys, softcap
    (1, 2, 2, 64, 64, 32, False, 0, None),       # the last row sees no key
])
def test_tensor_core_rounding_within_contract(case):
    """The bf16 kernel's one new rounding (p to bf16 before p . v), in
    its tiles, against the Pallas kernel in interpret mode at the bf16
    tolerance."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, "bfloat16")
    causal, window, cap = case[6:]
    want = jops.attention(jq, jk, jv, causal=causal, window=window,
                          softcap=cap, use_kernel=True)
    got = _tensor_core_emulation(tq, tk, tv, causal, window, cap)
    assert got.dtype == torch.bfloat16
    _close(got, want, ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_attention_with_kv_length_equals_reference(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 4, 1, 1, 64, 32), dtype)
    for n in (1, 30, 64):
        want = jops.attention(jq, jk, jv, kv_length=jnp.asarray(n, jnp.int32),
                              use_kernel=True)
        got = tops.attention(tq, tk, tv, kv_length=n)
        _close(got, want, ATTN_TOL[dtype])


def test_ops_attention_routing(monkeypatch):
    """Which version each shape reaches, as in ``repro.kernels.ops``."""
    calls = []
    for mod, name in ((K, "flash_attention"),
                      (tref, "chunked_attention"),
                      (tref, "flash_attention_ref")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _n=name, _r=real, **kw:
            (calls.append(_n), _r(*a, **kw))[1])
    for Sq, Sk, kv_length, want in (
            (64, 64, None, "flash_attention"),
            (256, 256, None, "flash_attention"),
            (1, 64, None, "flash_attention"),
            (100, 100, None, "flash_attention"),        # one block of 100
            (200, 200, None, "flash_attention_ref"),
            (300, 300, None, "chunked_attention"),
            (1, 64, 5, "chunked_attention")):
        calls.clear()
        q = torch.zeros((1, 2, Sq, 16))
        k = torch.zeros((1, 1, Sk, 16))
        tops.attention(q, k, k, kv_length=kv_length)
        assert calls[0] == want, (Sq, Sk, kv_length, calls)


@pytest.mark.parametrize("B,S,D", RGLRU_CASES + [(2, 100, 40), (1, 256, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_rglru_equals_reference(B, S, D, dtype):
    rng = np.random.default_rng(SEED + S)
    jx, tx = _pair(rng, (B, S, D), dtype)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, D)).astype(np.float32)))
    jd, td = DTYPES[dtype]
    want = jops.rglru(jx, jnp.asarray(a, jd), use_kernel=True)
    got = tops.rglru(tx, torch.as_tensor(a).to(td))
    _close(got, want, RGLRU_TOL[dtype])


#: steps per chunk of ``rglru_scan_kernel`` (``ScanPair<T>::kSteps`` in
#: ``csrc/models.cu``).
SCAN_STEPS = {"float32": 8, "bfloat16": 16}


def _chunked_scan_emulation(x, a, steps):
    """``rglru_scan_kernel``'s order in plain torch: chunks of ``steps``
    steps scanned from zero to (A, H) per channel, the carries composed
    chunk after chunk as (A2 A1, A2 H1 + H2), then every chunk run again
    from its carry-in; fp32 arithmetic, steps past S the identity (a = 1,
    x = 0), h in x's dtype."""
    B, S, D = x.shape
    n = -(-S // steps)
    pad = (0, 0, 0, n * steps - S)
    af = torch.nn.functional.pad(a.float(), pad, value=1.0)
    xf = torch.nn.functional.pad(x.float(), pad, value=0.0)
    af, xf = af.view(B, n, steps, D), xf.view(B, n, steps, D)
    gx = torch.sqrt(torch.clamp(1.0 - af ** 2, min=0.0)) * xf
    A, H = torch.ones((B, n, D)), torch.zeros((B, n, D))
    for u in range(steps):                       # each chunk from zero
        H = af[:, :, u] * H + gx[:, :, u]
        A = A * af[:, :, u]
    carry, c_in = torch.zeros((B, D)), []
    for k in range(n):                           # the carries, composed
        c_in.append(carry)
        carry = A[:, k] * carry + H[:, k]
    h, hs = torch.stack(c_in, 1), []
    for u in range(steps):                       # each chunk again
        h = af[:, :, u] * h + gx[:, :, u]
        hs.append(h)
    return torch.stack(hs, 2).reshape(B, n * steps, D)[:, :S].to(x.dtype)


@pytest.mark.parametrize("B,S,D,decay", [c + ("sigmoid",) for c in
                                         RGLRU_CASES] + [
    (2, 2048, 128, "sigmoid"),
    (2, 2048, 128, "near one"),                  # long memory
    (2, 2048, 128, "near zero")])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_scan_order_within_contract(B, S, D, decay, dtype):
    """The CUDA scan's reassociated order, in its chunks, against the
    Pallas kernel in interpret mode at the RG-LRU tolerance."""
    rng = np.random.default_rng(SEED + S)
    jx, tx = _pair(rng, (B, S, D), dtype)
    u = rng.random((B, S, D)).astype(np.float32)
    a = {"sigmoid": 1 / (1 + np.exp(-rng.standard_normal((B, S, D)))),
         "near one": 1 - 2e-3 * u, "near zero": 1e-2 * u}[decay]
    a = a.astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jops.rglru(jx, jnp.asarray(a, jd), use_kernel=True)
    got = _chunked_scan_emulation(tx, torch.as_tensor(a).to(td),
                                  SCAN_STEPS[dtype])
    assert got.dtype == td
    _close(got, want, RGLRU_TOL[dtype])


# -- dispatch ----------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_versions():
    before = dict(K.launches)
    q = torch.randn((1, 2, 8, 16))
    got = K.flash_attention(q, q, q, window=4, softcap=5.0)
    torch.testing.assert_close(got, tref.flash_attention_ref(
        q, q, q, window=4, softcap=5.0))
    x = torch.randn((2, 8, 4))
    torch.testing.assert_close(K.rglru_scan(x, torch.sigmoid(x)),
                               tref.rglru_scan_ref(x, torch.sigmoid(x)))
    assert K.launches == before


def test_cpu_flash_attention_returns_q_dtype():
    """The kernel's contract (q's dtype), where the oracle returns v's."""
    q = torch.randn((1, 2, 8, 16))
    assert K.flash_attention(q, q, q.bfloat16()).dtype == torch.float32


def test_non_cpu_tensor_never_takes_plain_path(monkeypatch):
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device takes the kernel path, whose checks refuse it."""
    called = []
    for name in ("flash_attention_ref", "rglru_scan_ref"):
        monkeypatch.setattr(tref, name,
                            lambda *a, _n=name, **kw: called.append(_n))
    q = torch.zeros((1, 2, 64, 32), device="meta")
    x = torch.zeros((2, 16, 8), device="meta")
    before = dict(K.launches)
    for call in (lambda: K.flash_attention(q, q, q),
                 lambda: K.rglru_scan(x, x),
                 lambda: tops.attention(q, q, q),
                 lambda: tops.rglru(x, x)):
        with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
            call()
    assert called == []
    assert K.launches == before


def test_model_wrappers_have_no_fallback():
    tree = ast.parse((ROOT / "src" / "repro_torch" / "kernels"
                      / "models.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_cuda_source_names_the_pallas_calls_it_replaces():
    src = (ROOT / "src" / "repro_torch" / "csrc" / "models.cu").read_text()
    found = re.findall(r"replaces \w+,\s*(?://\s*)?"
                       r"(src/repro/kernels/\w+\.py):(\d+)", src)
    assert len(found) == 2
    for path, line in found:
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert "pl.pallas_call(" in text, (path, line)

