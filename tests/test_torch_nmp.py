"""The near-memory operators of the port against ``repro``'s, bit for bit.

The same numpy inputs go through ``repro.nmp`` / ``repro.kernels`` (the
Pallas kernels in interpret mode on the CPU, as ``tests/test_kernels.py``
and ``tests/test_kernel_ops.py`` run them) and through ``repro_torch``'s
copies on the CPU, where every kernel wrapper runs its plain version:
the regex compiler's tables, ``select_scan``, ``dfa_match``/``dfa_select``,
``fib_hash``, ``build_kvs``, ``kvs_lookup``, the three plain kernel twins
and the three ``ops`` entry points.  The CUDA kernels themselves are held
against their plain versions on the card in ``tests/test_torch_gpu.py``.
"""
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nmp as jnmp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nmp import dfa as jdfa  # noqa: E402
from repro.nmp import kvstore as jkv  # noqa: E402
from repro.nmp import regex as jregex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import nmp as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nmp import dfa as tdfa  # noqa: E402
from repro_torch.nmp import kvstore as tkv  # noqa: E402
from repro_torch.nmp import regex as tregex  # noqa: E402
from repro_torch.nmp import select as tsel  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 515

PATTERNS = ["abc", "a(b|c)+d", "[0-9]+", "x.?y", "xyzzy", "error!", "ab+c",
            "[a-c]+x", "[^a-z]q", "cat|dog|bird", r"\d\w\s", r"\d+\.\d*",
            "(ab|cd)*e?f", "[\\d_]z", "a*", ""]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a):
    """Floats as their integer bits, so -0.0 and +0.0 differ."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _table(n, w, sel, seed=SEED):
    return tsel.make_table(seed, n, w, sel, device="cpu")


def _strings(n, width, pattern_words, seed=SEED):
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"abcdexyz019_ !", np.uint8),
                     size=(n, width))
    for i in range(0, n, 3):                  # plant a word in every third
        word = np.frombuffer(pattern_words[i % len(pattern_words)].encode(),
                             np.uint8)[:width]
        at = rng.integers(0, width - len(word) + 1)
        arr[i, at:at + len(word)] = word
    arr[rng.random(n) < 0.2, width // 2:] = 0       # NUL-padded tails
    return arr.astype(np.uint8)


# -- the regex compiler: a copy, held equal table for table ----------------

@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_tables_identical(pattern):
    a, b = jregex.compile_regex(pattern), tregex.compile_regex(pattern)
    np.testing.assert_array_equal(a.transitions, b.transitions)
    np.testing.assert_array_equal(a.accept, b.accept)
    assert a.transitions.dtype == b.transitions.dtype == np.int32
    assert a.pattern == b.pattern and a.n_states == b.n_states


@pytest.mark.parametrize("pattern,kw", [
    ("(a|b)*a(a|b)(a|b)(a|b)(a|b)", dict(max_states=8)),
    ("a)", {}), ("(ab", {}), ("*a", {})])
def test_compile_regex_errors_identical(pattern, kw):
    with pytest.raises(ValueError) as ja:
        jregex.compile_regex(pattern, **kw)
    with pytest.raises(ValueError) as tb:
        tregex.compile_regex(pattern, **kw)
    assert str(ja.value) == str(tb.value)


# -- select ------------------------------------------------------------------

def test_make_table_column_rules():
    t = _np(tsel.make_table(np.random.default_rng(3), 4096, 32, 0.25,
                            device="cpu"))
    match = t[:, 0] > 0
    assert set(np.unique(t[:, 0])) == {-1.0, 1.0}
    np.testing.assert_array_equal(t[:, 1], np.where(match, 0.0, 2.0))
    assert 0.2 < match.mean() < 0.3
    assert t.dtype == np.float32 and np.isfinite(t).all()
    same = _np(tsel.make_table(3, 4096, 32, 0.25, device="cpu"))
    np.testing.assert_array_equal(t, same)


@pytest.mark.parametrize("n,w,sel,capacity", [
    (256, 8, 0.3, None), (1000, 32, 0.1, 64), (1000, 32, 0.9, 1000),
    (77, 5, 0.5, 10), (512, 32, 0.0, None), (300, 4, 1.0, 299)])
def test_select_scan_equals_reference(n, w, sel, capacity):
    t = _table(n, w, sel)
    t[::7, 5 % w] = -0.0                      # bits are copied, not summed
    jp, jc, jm = jnmp.select_scan(jnp.asarray(_np(t)), 0.0, 1.0,
                                  capacity=capacity)
    tp, tc, tm = tsel.select_scan(t, 0.0, 1.0, capacity=capacity)
    np.testing.assert_array_equal(_bits(_np(tp)), _bits(np.asarray(jp)))
    assert int(tc) == int(jc) and tc.dtype == torch.int32
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))


def test_select_scan_bf16_equals_reference():
    t = _table(512, 16, 0.4).to(torch.bfloat16)
    jt = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jp, jc, _ = jnmp.select_scan(jt, 0.0, 1.0, capacity=200)
    tp, tc, _ = tsel.select_scan(t, 0.0, 1.0, capacity=200)
    np.testing.assert_array_equal(tp.view(torch.int16).numpy(),
                                  np.asarray(jp).view(np.int16))
    assert int(tc) == int(jc)


# -- DFA ---------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["xyzzy", "a(b|c)+d", "[0-9]+", "x.?y",
                                     r"\d\w\s", "error!"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_dfa_match_equals_reference(pattern, with_lengths):
    rng = np.random.default_rng(SEED)
    arr = _strings(200, 24, ["xyzzy", "abcd", "x0y", "error!", "1a "])
    lengths = rng.integers(0, 25, 200).astype(np.int32) if with_lengths \
        else None
    want = jdfa.dfa_match(jregex.compile_regex(pattern), jnp.asarray(arr),
                          None if lengths is None else jnp.asarray(lengths))
    got = tdfa.dfa_match(tregex.compile_regex(pattern), torch.as_tensor(arr),
                         None if lengths is None else
                         torch.as_tensor(lengths))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
@pytest.mark.parametrize("capacity", [None, 40])
def test_dfa_select_equals_reference(dtype, capacity):
    s = _strings(150, 20, ["xyzzy", "qq"])
    table = np.concatenate([np.arange(150)[:, None] % 256,
                            s, s[:, :3]], axis=1).astype(dtype)
    want = jdfa.dfa_select(jregex.compile_regex("xyzzy"),
                           jnp.asarray(table), 1, 21, capacity=capacity)
    got = tdfa.dfa_select(tregex.compile_regex("xyzzy"),
                          torch.as_tensor(table), 1, 21, capacity=capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# -- KVS ---------------------------------------------------------------------

EDGE_KEYS = np.array([0, 1, 2, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31,
                      2 ** 31 + 1, 2 ** 32 - 3, 2 ** 32 - 2, 2 ** 32 - 1],
                     np.uint32)


@pytest.mark.parametrize("n_buckets", [1, 7, 64, 1000, 65536, 100003])
def test_fib_hash_equals_reference(n_buckets):
    rng = np.random.default_rng(n_buckets)
    keys = np.concatenate([EDGE_KEYS, rng.integers(
        0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32),
        (2 ** 32 - 1 - np.arange(500)).astype(np.uint32)])
    want = np.asarray(jkv.fib_hash(jnp.asarray(keys), n_buckets))
    got = tkv.fib_hash(tkv.key_bits(keys, "cpu"), n_buckets)
    np.testing.assert_array_equal(_np(got), want)
    as64 = torch.as_tensor(keys.astype(np.int64))
    np.testing.assert_array_equal(_np(tkv.fib_hash(as64, n_buckets)), want)
    np.testing.assert_array_equal(_np(tkv.key_bits(as64, "cpu")),
                                  keys.view(np.int32))


def _kvs_inputs(n, key_range, seed=SEED):
    """Keys with duplicates (``key_range`` < n) and edge values."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n).astype(np.uint32)
    keys[:len(EDGE_KEYS)] = EDGE_KEYS[:n]
    keys[-5:] = keys[3]                         # one key five more times
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("n,key_range,n_buckets", [
    (300, 100, 16), (500, 10 ** 9, 64), (64, 2 ** 32, 1), (257, 50, 1000),
    (12, 5, 3)])
def test_build_kvs_identical_arrays(n, key_range, n_buckets):
    keys, vals = _kvs_inputs(n, key_range)
    want = jkv.build_kvs(keys, vals, n_buckets)
    got = tkv.build_kvs(keys, vals, n_buckets, device="cpu")
    flat = convert.kvs_to_numpy(got)
    for f in ("heads", "keys", "values", "nxt"):
        np.testing.assert_array_equal(flat[f], np.asarray(getattr(want, f)))
        assert flat[f].dtype == np.asarray(getattr(want, f)).dtype
    back = convert.kvstore_to_torch(want, "cpu")
    for a, b in zip(back, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_chain", [1, 3, 8, 40])
def test_kvs_lookup_equals_reference(max_chain):
    keys, vals = _kvs_inputs(600, 400)
    rng = np.random.default_rng(max_chain)
    q = np.concatenate([keys[rng.integers(0, 600, 150)],
                        rng.integers(0, 2 ** 32, 50,
                                     dtype=np.uint64).astype(np.uint32),
                        EDGE_KEYS])
    want = jkv.kvs_lookup(jkv.build_kvs(keys, vals, 32), jnp.asarray(q),
                          max_chain)
    got = tkv.kvs_lookup(tkv.build_kvs(keys, vals, 32, device="cpu"),
                         tkv.key_bits(q, "cpu"), max_chain)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# -- the three plain kernel twins against repro.kernels.ref -----------------

@pytest.mark.parametrize("n,w,block", [(256, 8, 64), (512, 16, 128),
                                       (128, 128, 128), (96, 3, 32)])
def test_select_scan_ref_equals_reference(n, w, block):
    t = _table(n, w, 0.3)
    for x in (0.0, float("-inf"), 0.5):
        pj, cj = jref.select_scan_ref(jnp.asarray(_np(t)), x, 1.0, block)
        pt, ct = tref.select_scan_ref(t, x, 1.0, block)
        np.testing.assert_array_equal(_bits(_np(pt)), _bits(np.asarray(pj)))
        np.testing.assert_array_equal(_np(ct), np.asarray(cj))


@pytest.mark.parametrize("pattern", ["abc", "a(b|c)+d", "[0-9]+", "x.?y",
                                     "xyzzy"])
@pytest.mark.parametrize("width", [8, 32])
def test_regex_dfa_ref_equals_reference(pattern, width):
    dfa = jregex.compile_regex(pattern)
    arr = _strings(128, width, ["abcd", "xyzzy", "x1y", "09"], seed=width)
    want = jref.regex_dfa_ref(jnp.asarray(dfa.transitions),
                              jnp.asarray(dfa.accept), jnp.asarray(arr))
    trans, accept = convert.dfa_to_torch(dfa, "cpu")
    got = tref.regex_dfa_ref(trans, accept, torch.as_tensor(arr))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _in_place(arr, stride, offset):
    """``arr`` [n, w] uint8 written into a zeroed [n, stride] table at
    column ``offset``: (the table, the view of its string field)."""
    n, w = arr.shape
    table = torch.zeros((n, stride), dtype=torch.uint8)
    field = table[:, offset:offset + w]
    field.copy_(torch.as_tensor(arr))
    return table, field


@pytest.mark.parametrize("pattern", ["xyzzy", "a(b|c)+d", "[0-9]+", "x.?y"])
@pytest.mark.parametrize("stride,offset", [(128, 8), (130, 1), (62, 0)])
def test_regex_dfa_on_a_row_strided_view_equals_reference(pattern, stride,
                                                          offset):
    """The path's layout (a 62-byte field at byte 8 of 128-byte rows), a
    stride that is no multiple of 16 and the contiguous case: the plain
    twin and the CPU wrapper take the view as it lies, and equal the
    reference on the contiguous field."""
    dfa = jregex.compile_regex(pattern)
    arr = _strings(300, 62, ["abcd", "xyzzy", "x1y", "09"], seed=stride)
    want = jref.regex_dfa_ref(jnp.asarray(dfa.transitions),
                              jnp.asarray(dfa.accept), jnp.asarray(arr))
    trans, accept = convert.dfa_to_torch(dfa, "cpu")
    table, field = _in_place(arr, stride, offset)
    assert field.stride() == (stride, 1)
    got = tref.regex_dfa_ref(trans, accept, field)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    before = dict(K.launches)
    np.testing.assert_array_equal(_np(K.regex_dfa(trans, accept, field)),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        _np(tops.regex_match(trans, accept, field)), np.asarray(want))
    assert K.launches == before


@pytest.mark.parametrize("n_entries,n_buckets,max_chain",
                         [(500, 64, 32), (1000, 1000, 8), (300, 7, 5)])
def test_hash_probe_ref_equals_reference(n_entries, n_buckets, max_chain):
    keys = np.arange(1, n_entries + 1, dtype=np.uint32)
    kvs = jkv.build_kvs(keys, np.ones((n_entries, 2), np.float32), n_buckets)
    q = np.random.RandomState(0).randint(1, n_entries * 2, 128).astype(
        np.uint32)
    fj, sj = jref.hash_probe_ref(kvs.heads, kvs.keys, kvs.nxt,
                                 jnp.asarray(q), max_chain)
    tk = convert.kvstore_to_torch(kvs, "cpu")
    ft, st = tref.hash_probe_ref(tk.heads, tk.keys, tk.nxt,
                                 tkv.key_bits(q, "cpu"), max_chain)
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


def _is_records(keys, nxt):
    """``keys`` and ``nxt`` are the two columns of one [..., n, 2] tensor."""
    return (keys.untyped_storage().data_ptr()
            == nxt.untyped_storage().data_ptr()
            and keys.stride()[-1] == nxt.stride()[-1] == 2
            and nxt.storage_offset() == keys.storage_offset() + 1)


@pytest.mark.parametrize("n,key_range,n_buckets", [
    (300, 100, 16), (500, 10 ** 9, 64), (64, 2 ** 32, 1), (12, 5, 3)])
@pytest.mark.parametrize("max_chain", [3, 40])
def test_kvs_records_layout_equals_reference(n, key_range, n_buckets,
                                             max_chain):
    """``build_kvs`` and ``convert.kvstore_to_torch`` lay keys and nxt out
    as records, with the reference's values (duplicate keys and bucket
    collisions included); the probe's plain twin and ``kvs_lookup`` give
    the reference's answers on records and on two contiguous arrays."""
    keys, vals = _kvs_inputs(n, key_range)
    ref_kvs = jkv.build_kvs(keys, vals, n_buckets)
    for got in (tkv.build_kvs(keys, vals, n_buckets, device="cpu"),
                convert.kvstore_to_torch(ref_kvs, "cpu")):
        assert _is_records(got.keys, got.nxt)
        assert tkv.records(got.keys, got.nxt) is not None
        flat = convert.kvs_to_numpy(got)
        for f in ("keys", "nxt"):
            np.testing.assert_array_equal(flat[f],
                                          np.asarray(getattr(ref_kvs, f)))
    q = np.concatenate([keys[::3], EDGE_KEYS,
                        np.arange(1, 40, dtype=np.uint32) * 7919])
    fj, sj = jref.hash_probe_ref(ref_kvs.heads, ref_kvs.keys, ref_kvs.nxt,
                                 jnp.asarray(q), max_chain)
    vj, hj, stj = jkv.kvs_lookup(ref_kvs, jnp.asarray(q), max_chain)
    qt = tkv.key_bits(q, "cpu")
    for k, nx in ((got.keys, got.nxt),
                  (got.keys.contiguous(), got.nxt.contiguous())):
        ft, st = tref.hash_probe_ref(got.heads, k, nx, qt, max_chain)
        np.testing.assert_array_equal(_np(ft), np.asarray(fj))
        np.testing.assert_array_equal(_np(st), np.asarray(sj))
        vt, ht, stt = tkv.kvs_lookup(got._replace(keys=k, nxt=nx), qt,
                                     max_chain)
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
        np.testing.assert_array_equal(_np(ht), np.asarray(hj))
        np.testing.assert_array_equal(_np(stt), np.asarray(stj))


def test_records_names_only_the_two_columns_of_one_tensor():
    rec = torch.arange(20, dtype=torch.int32).view(10, 2)
    keys, nxt = rec[:, 0], rec[:, 1]
    assert torch.equal(tkv.records(keys, nxt), rec)
    assert tkv.records(nxt, keys) is None                 # swapped
    assert tkv.records(keys.contiguous(), nxt.contiguous()) is None
    assert tkv.records(keys[1:], nxt[:-1]) is None         # other rows
    assert tkv.records(keys, rec[:, 1].clone()) is None    # two tensors
    moved_k, moved_n = tkv.chains_to(keys, nxt, "cpu")
    assert _is_records(moved_k, moved_n)


# -- the ops entry points against repro.kernels.ops (Pallas, interpret) -----

@pytest.mark.parametrize("n,block", [(100, 64), (256, 64), (300, 128)])
@pytest.mark.parametrize("x", [0.0, float("-inf")])
def test_ops_select_equals_reference(n, block, x):
    t = _table(n, 8, 0.3)
    pj, cj = jops.select(jnp.asarray(_np(t)), x, 1.0, block_rows=block)
    pt, ct = tops.select(t, x, 1.0, block_rows=block)
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    pad = (-n) % block
    if pad:                      # x = -inf: the padding rows match too
        last = _np(t)[n - n % block:]
        real = int(((last[:, 0] > x) & (last[:, 1] < 1.0)).sum())
        assert int(ct[-1]) == real + (pad if x == float("-inf") else 0)


@pytest.mark.parametrize("n,block", [(5, 4), (130, 64), (64, 64)])
@pytest.mark.parametrize("pattern", ["ab+c", "xyzzy", "[0-9]+"])
def test_ops_regex_match_equals_reference(n, block, pattern):
    dfa = jregex.compile_regex(pattern)
    arr = _strings(n, 12, ["abbbc", "xyzzy", "42"])
    want = jops.regex_match(jnp.asarray(dfa.transitions),
                            jnp.asarray(dfa.accept), jnp.asarray(arr),
                            block_rows=block)
    trans, accept = convert.dfa_to_torch(dfa, "cpu")
    got = tops.regex_match(trans, accept, torch.as_tensor(arr))
    assert got.shape == (n,)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("nq,block_q,max_chain", [(59, 32, 8), (64, 64, 2),
                                                  (200, 128, 12)])
def test_ops_probe_equals_reference(nq, block_q, max_chain):
    keys, vals = _kvs_inputs(300, 200)
    kvs = jkv.build_kvs(keys, vals, 16)
    q = np.concatenate([keys[:nq // 2], np.arange(nq - nq // 2,
                                                  dtype=np.uint32) * 7919])
    fj, sj = jops.probe(kvs.heads, kvs.keys, kvs.nxt, jnp.asarray(q),
                        max_chain=max_chain, block_q=block_q)
    tk = convert.kvstore_to_torch(kvs, "cpu")
    ft, st = tops.probe(tk.heads, tk.keys, tk.nxt, tkv.key_bits(q, "cpu"),
                        max_chain=max_chain, block_q=block_q)
    assert ft.shape == (nq,)
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


OPS_LAYOUTS = ["select, strided table", "select, contiguous table",
               "regex_match, rows not contiguous",
               "regex_match, a field in place", "probe, strided columns",
               "probe, records", "attention, bf16 off a 16-byte boundary",
               "attention, fp32 transposed"]


@pytest.mark.parametrize("case", OPS_LAYOUTS)
def test_ops_hand_the_wrappers_a_layout_they_take(case, monkeypatch):
    """Each ``ops`` entry point hands its wrapper a layout the card's
    kernel takes: an argument the wrapper would refuse there is copied
    first (and the answer is the reference's on the same values), one it
    takes is handed on as it lies."""
    from repro_torch.kernels import models as MK
    from repro_torch.kernels.coherency_step import rows_layout
    entry = case.split(",")[0]
    wrapper = {"select": (K, "select_scan"), "regex_match": (K, "regex_dfa"),
               "probe": (K, "hash_probe"),
               "attention": (MK, "flash_attention")}[entry]
    seen = []
    real = getattr(*wrapper)
    monkeypatch.setattr(*wrapper, lambda *a, **kw: (seen.append(a),
                                                    real(*a, **kw))[1])
    if entry == "select":
        wide = _table(256, 16, 0.3)
        t = wide[:, ::2] if "strided" in case else wide[:, :8].contiguous()
        pj, cj = jops.select(jnp.asarray(_np(t)), 0.0, 1.0)
        pt, ct = tops.select(t, 0.0, 1.0)
        np.testing.assert_array_equal(_np(ct), np.asarray(cj))
        np.testing.assert_array_equal(_bits(_np(pt)), _bits(pj))
        arg = seen[0][0]
        assert arg.is_contiguous() and torch.equal(arg, t)
        assert (arg.data_ptr() == t.data_ptr()) == t.is_contiguous()
    elif entry == "regex_match":
        dfa = jregex.compile_regex("ab+c")
        arr = _strings(64, 12, ["abbbc", "xyzzy"])
        want = jops.regex_match(jnp.asarray(dfa.transitions),
                                jnp.asarray(dfa.accept), jnp.asarray(arr))
        trans, accept = convert.dfa_to_torch(dfa, "cpu")
        field = (torch.as_tensor(arr.T.copy()).t() if "not" in case
                 else _in_place(arr, 128, 8)[1])
        got = tops.regex_match(trans, accept, field)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        arg = seen[0][2]
        assert rows_layout(arg) and torch.equal(arg, field)
        assert (arg.data_ptr() == field.data_ptr()) == rows_layout(field)
    elif entry == "probe":
        keys, vals = _kvs_inputs(300, 200)
        kvs = jkv.build_kvs(keys, vals, 16)
        q = np.concatenate([keys[:40], np.arange(20, dtype=np.uint32) * 97])
        fj, sj = jops.probe(kvs.heads, kvs.keys, kvs.nxt, jnp.asarray(q),
                            max_chain=12)
        tk = convert.kvstore_to_torch(kvs, "cpu")
        k, nx = tk.keys, tk.nxt
        if "strided" in case:
            three = torch.stack([k, nx, nx], 1)
            k, nx = three[:, 0], three[:, 1]
        ft, st = tops.probe(tk.heads, k, nx, tkv.key_bits(q, "cpu"),
                            max_chain=12)
        np.testing.assert_array_equal(_np(ft), np.asarray(fj))
        np.testing.assert_array_equal(_np(st), np.asarray(sj))
        _, ak, an = seen[0][:3]
        assert _is_records(ak, an) and K.chains_layout(ak, an)
        assert (ak is k and an is nx) == ("records" in case)
    else:
        dtype = torch.bfloat16 if "bf16" in case else torch.float32
        g = torch.Generator().manual_seed(SEED)
        shape = (1, 2, 64, 32)
        q, k, v = (torch.randn(shape, generator=g).to(dtype)
                   for _ in range(3))
        if dtype == torch.bfloat16:
            flat = torch.zeros(q.numel() + 1, dtype=dtype)
            q = flat[1:].view(shape).copy_(q)
            assert q.data_ptr() % 16
        else:
            k = k.transpose(2, 3).contiguous().transpose(2, 3)
            assert not k.is_contiguous()
        got = tops.attention(q, k, v)
        aq, ak, av = seen[0]
        assert all(t.is_contiguous() for t in (aq, ak, av))
        assert dtype != torch.bfloat16 or \
            all(t.data_ptr() % 16 == 0 for t in (aq, ak, av))
        want = tref.flash_attention_ref(q.clone(), k.contiguous(),
                                        v).to(dtype)
        assert torch.equal(got, want)
    assert len(seen) == 1


# -- dispatch ----------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_versions():
    before = dict(K.launches)
    t = _table(256, 8, 0.5)
    K.select_scan(t, 0.0, 1.0, 64)
    dfa = tregex.compile_regex("ab")
    trans, accept = tdfa.dfa_tables(dfa, "cpu")
    K.regex_dfa(trans, accept, torch.zeros((4, 8), dtype=torch.uint8))
    kv = tkv.build_kvs(np.arange(10, dtype=np.uint32), np.ones((10, 1)), 4,
                       device="cpu")
    K.hash_probe(kv.heads, kv.keys, kv.nxt, kv.keys, 4)
    assert K.launches == before


def test_non_cpu_tensor_never_takes_plain_path(monkeypatch):
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device takes the kernel path, whose checks refuse it."""
    called = []
    for name in ("select_scan_ref", "regex_dfa_ref", "hash_probe_ref"):
        monkeypatch.setattr(tref, name,
                            lambda *a, _n=name: called.append(_n))
    f32 = torch.zeros((256, 8), dtype=torch.float32, device="meta")
    i32 = torch.zeros((256, 8), dtype=torch.int32, device="meta")
    u8 = torch.zeros((256, 8), dtype=torch.uint8, device="meta")
    before = dict(K.launches)
    calls = [lambda: K.select_scan(f32, 0.0, 1.0),
             lambda: K.regex_dfa(torch.zeros((2, 256), dtype=torch.int32,
                                             device="meta"),
                                 torch.zeros(2, dtype=torch.bool,
                                             device="meta"), u8),
             lambda: K.hash_probe(i32[0], i32[0], i32[0], i32[0], 4)]
    for call in calls:
        with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
            call()
    assert called == []
    assert K.launches == before


def test_nmp_wrappers_have_no_fallback():
    """No ``try`` in the near-memory wrappers or their entry points: a
    failed build or launch is never swallowed into the plain path."""
    for name in ("nmp.py", "ops.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / "kernels"
                          / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_cuda_source_names_the_pallas_calls_it_replaces():
    src = (ROOT / "src" / "repro_torch" / "csrc" / "nmp.cu").read_text()
    found = re.findall(r"replaces \w+, (src/repro/kernels/\w+\.py):(\d+)",
                       src)
    assert len(found) == 3
    for path, line in found:
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert "pl.pallas_call(" in text, (path, line)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, vals = np.arange(8, dtype=np.uint32), np.ones((8, 1), np.float32)
    for call in (lambda: tsel.make_table(0, 16, 4, 0.5),
                 lambda: tkv.build_kvs(keys, vals, 4),
                 lambda: convert.kvstore_to_torch(
                     jkv.build_kvs(keys, vals, 4)),
                 lambda: convert.dfa_to_torch(tregex.compile_regex("a"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
