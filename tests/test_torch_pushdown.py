"""Operator pushdown in the port against ``repro.core.pushdown``, bit for bit.

With one shard, ``repro``'s ``shard_map`` runs on a one-device ``Mesh``
and the port on ``["cpu"]``; the gathered rows, counts, moved rows and
the lookup's values, found flags and steps must be identical.  With
S ∈ {4, 8} shards over ``["cpu"] * S`` the port's combine is held against
what ``shard_map`` computes — the per-shard ``repro.nmp.select_scan`` and
``dfa_select`` stacked, and ``kvs_lookup`` over the whole table — as
``tests/test_multidevice.py`` checks for select and lookup.  Each shard's
hot loop runs through the port's ``kernels.ops``, whose plain versions
run on the CPU, so the stitch of per-block matches is what is tested.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from repro.core import pushdown as jpd  # noqa: E402
from repro.nmp import dfa as jdfa  # noqa: E402
from repro.nmp import kvstore as jkv  # noqa: E402
from repro.nmp import regex as jregex  # noqa: E402
from repro.nmp import select as jsel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pushdown as tpd  # noqa: E402
from repro_torch.kernels import nmp as K  # noqa: E402
from repro_torch.nmp import kvstore as tkv  # noqa: E402
from repro_torch.nmp import regex as tregex  # noqa: E402
from repro_torch.nmp import select as tsel  # noqa: E402

SEED = 2024


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("x",))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_result(got, want):
    np.testing.assert_array_equal(_bits(_np(got.rows)),
                                  _bits(np.asarray(want.rows)))
    np.testing.assert_array_equal(_np(got.counts), np.asarray(want.counts))
    assert int(got.moved_rows) == int(want.moved_rows)
    assert got.counts.dtype == got.moved_rows.dtype == torch.int32


def _table(n, w, sel):
    t = tsel.make_table(SEED + n, n, w, sel, device="cpu")
    t[::5, w - 1] = -0.0                      # bits are copied, not summed
    return t


def _regex_table(n, width=40, lo=4, seed=SEED):
    """int32 rows with a string field in columns [lo, lo + 24): a planted
    ``xyzzy`` in every fourth row, random lowercase elsewhere."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (n, width)).astype(np.int32)
    t[:, lo:lo + 24] = rng.choice(np.frombuffer(b"xyzab ", np.uint8),
                                  (n, 24))
    for i in range(0, n, 4):
        at = lo + rng.integers(0, 20)
        t[i, at:at + 5] = np.frombuffer(b"xyzzy", np.uint8)
    return t, lo, lo + 24


# -- one shard: the reference's shard_map on a one-device mesh -------------

@pytest.mark.parametrize("n,w,sel,capacity,x", [
    (1024, 8, 0.2, 1024, 0.0), (1000, 32, 0.1, 128, 0.0),
    (300, 8, 0.5, 40, 0.0), (1000, 32, 0.3, 1000, float("-inf")),
    (77, 5, 1.0, 77, float("-inf")), (512, 4, 0.0, 16, 0.0)])
def test_pushdown_select_one_shard_equals_reference(mesh1, n, w, sel,
                                                   capacity, x):
    t = _table(n, w, sel)
    want = jpd.pushdown_select(mesh1, "x", capacity, jnp.asarray(_np(t)),
                               x, 1.0)
    K.reset_launches()
    got = tpd.pushdown_select(["cpu"], capacity, t, x, 1.0)
    _same_result(got, want)
    assert K.launches["select_scan"] == 0        # the plain path on the CPU


@pytest.mark.parametrize("n,capacity,pattern", [
    (256, 256, "xyzzy"), (300, 50, "xyzzy"), (100, 100, "zz+a"),
    (64, 8, "[ab]y")])
def test_pushdown_regex_one_shard_equals_reference(mesh1, n, capacity,
                                                  pattern):
    t, lo, hi = _regex_table(n)
    want = jpd.pushdown_regex(mesh1, "x", capacity,
                              jregex.compile_regex(pattern),
                              jnp.asarray(t), lo, hi)
    got = tpd.pushdown_regex(["cpu"], capacity,
                             tregex.compile_regex(pattern),
                             torch.as_tensor(t), lo, hi)
    _same_result(got, want)


@pytest.mark.parametrize("n,capacity", [(300, 300), (256, 40)])
def test_pushdown_regex_reads_a_uint8_field_in_place(mesh1, monkeypatch, n,
                                                     capacity):
    """A uint8 table's string field reaches the kernel wrapper as a view
    of the table's own storage (no copy), and the pushdown still equals
    the reference bit for bit."""
    t32, lo, hi = _regex_table(n, width=128, lo=8)
    t = (t32 & 0xFF).astype(np.uint8)
    seen = []
    real = K.regex_dfa

    def spy(trans, accept, strings):
        seen.append(strings)
        return real(trans, accept, strings)

    monkeypatch.setattr(K, "regex_dfa", spy)
    table = torch.as_tensor(t)
    want = jpd.pushdown_regex(mesh1, "x", capacity,
                              jregex.compile_regex("xyzzy"),
                              jnp.asarray(t), lo, hi)
    got = tpd.pushdown_regex(["cpu"], capacity,
                             tregex.compile_regex("xyzzy"), table, lo, hi)
    _same_result(got, want)
    assert len(seen) == 1
    field = seen[0]
    assert field.untyped_storage().data_ptr() == \
        table.untyped_storage().data_ptr()
    assert field.stride() == (128, 1) and field.shape == (n, hi - lo)
    assert field.data_ptr() == table.data_ptr() + lo


def _kvs_case(n, key_range, seed=SEED):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, key_range, n).astype(np.uint32)
    keys[:3] = [2 ** 32 - 1, 2 ** 31, 0]
    keys[-4:] = keys[5]                          # a duplicated key
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    vals[::9, 1] = -0.0
    q = np.concatenate([keys[rng.integers(0, n, 120)],
                        rng.integers(0, 2 ** 32, 40,
                                     dtype=np.uint64).astype(np.uint32),
                        keys[:3]])
    return keys, vals, q


@pytest.mark.parametrize("n,key_range,n_buckets,max_chain", [
    (2000, 10 ** 6, 256, 64), (500, 300, 32, 6), (300, 2 ** 32, 1, 400)])
def test_pushdown_lookup_one_shard_equals_reference(mesh1, n, key_range,
                                                   n_buckets, max_chain):
    keys, vals, q = _kvs_case(n, key_range)
    jk = jpd.build_sharded_kvs(keys, vals, n_buckets, 1)
    want = jpd.pushdown_lookup(mesh1, "x", jk, jnp.asarray(q), max_chain)
    tk = tpd.build_sharded_kvs(keys, vals, n_buckets, 1, device="cpu")
    got = tpd.pushdown_lookup(["cpu"], tk, q, max_chain)
    np.testing.assert_array_equal(_bits(_np(got[0])), _bits(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert got[2].dtype == torch.int32 and got[1].dtype == torch.bool


# -- S shards over ["cpu"] * S: the combine --------------------------------

@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("x", [0.0, float("-inf")])
def test_pushdown_select_sharded_combine(S, x):
    n, cap = 1024 + 8 * 40, 100          # ragged shards, capacity < count
    t = _table(n, 8, 0.4)
    got = tpd.pushdown_select(["cpu"] * S, cap, t, x, 1.0)
    per = n // S
    parts = [jsel.select_scan(jnp.asarray(_np(t)[s * per:(s + 1) * per]),
                              x, 1.0, capacity=cap) for s in range(S)]
    np.testing.assert_array_equal(
        _bits(_np(got.rows)), _bits(np.stack([p[0] for p in parts])))
    np.testing.assert_array_equal(_np(got.counts),
                                  np.array([p[1] for p in parts]))
    _, total, _ = jsel.select_scan(jnp.asarray(_np(t)), x, 1.0)
    assert int(got.moved_rows) == int(total)


@pytest.mark.parametrize("S", [4, 8])
def test_pushdown_regex_sharded_combine(S):
    t, lo, hi = _regex_table(8 * 37)
    dfa = jregex.compile_regex("xyzzy")
    got = tpd.pushdown_regex(["cpu"] * S, 20, tregex.compile_regex("xyzzy"),
                             torch.as_tensor(t), lo, hi)
    per = t.shape[0] // S
    parts = [jdfa.dfa_select(dfa, jnp.asarray(t[s * per:(s + 1) * per]),
                             lo, hi, capacity=20) for s in range(S)]
    np.testing.assert_array_equal(_np(got.rows),
                                  np.stack([p[0] for p in parts]))
    np.testing.assert_array_equal(_np(got.counts),
                                  np.array([p[1] for p in parts]))


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("n_buckets", [256, 64])
def test_pushdown_lookup_sharded_combine(S, n_buckets):
    keys, vals, q = _kvs_case(2000, 10 ** 5)
    max_chain = 80
    got = tpd.pushdown_lookup(
        ["cpu"] * S, tpd.build_sharded_kvs(keys, vals, n_buckets, S,
                                           device="cpu"), q, max_chain)
    want = jkv.kvs_lookup(jkv.build_kvs(keys, vals, n_buckets),
                          jnp.asarray(q), max_chain)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))


def test_pushdown_lookup_8shards_as_multidevice_test():
    """The case of ``tests/test_multidevice.py::
    test_pushdown_lookup_8shards``, on ``["cpu"] * 8``."""
    keys = np.arange(1, 2001, dtype=np.uint32)
    vals = np.stack([keys.astype(np.float32)] * 2, 1)
    skvs = tpd.build_sharded_kvs(keys, vals, 256, 8, device="cpu")
    v, found, _ = tpd.pushdown_lookup(
        ["cpu"] * 8, skvs, np.array([1, 500, 1999, 4242], np.uint32), 64)
    assert found.tolist() == [True, True, True, False]
    assert v[:3, 0].tolist() == [1.0, 500.0, 1999.0]


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("n,key_range,n_buckets", [
    (600, 10 ** 6, 64), (400, 50, 256), (10, 10, 8)])
def test_build_sharded_kvs_identical_arrays(S, n, key_range, n_buckets):
    keys, vals, _ = _kvs_case(n, key_range)
    want = jpd.build_sharded_kvs(keys, vals, n_buckets, S)
    got = tpd.build_sharded_kvs(keys, vals, n_buckets, S, device="cpu")
    flat = convert.kvs_to_numpy(got)
    for f in ("heads", "keys", "values", "nxt"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(_bits(flat[f]), _bits(w))
        assert flat[f].dtype == w.dtype
    assert got.n_buckets == want.n_buckets
    back = convert.sharded_kvs_to_torch(want, "cpu")
    for a, b in zip(back[:-1], got[:-1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [1, 4])
def test_build_sharded_kvs_lays_out_records(S):
    """Keys and nxt of ``build_sharded_kvs`` and of
    ``convert.sharded_kvs_to_torch`` are the two columns of one
    ``[S, cap, 2]`` tensor, with the reference's values; each shard's
    pair stays records when moved, and the lookup equals the
    reference's."""
    keys, vals, q = _kvs_case(700, 300)
    want = jpd.build_sharded_kvs(keys, vals, 64, S)
    for got in (tpd.build_sharded_kvs(keys, vals, 64, S, device="cpu"),
                convert.sharded_kvs_to_torch(want, "cpu")):
        cap = got.keys.shape[1]
        assert got.keys.stride() == got.nxt.stride() == (2 * cap, 2)
        assert got.nxt.storage_offset() == got.keys.storage_offset() + 1
        assert got.keys.untyped_storage().data_ptr() == \
            got.nxt.untyped_storage().data_ptr()
        flat = convert.kvs_to_numpy(got)
        for f in ("keys", "nxt"):
            np.testing.assert_array_equal(flat[f],
                                          np.asarray(getattr(want, f)))
        for s in range(S):
            assert tkv.records(got.keys[s], got.nxt[s]) is not None
        res = tpd.pushdown_lookup(["cpu"] * S, got, q, 60)
        ref = jkv.kvs_lookup(jkv.build_kvs(keys, vals, 64), jnp.asarray(q),
                             60)
        for g, w in zip(res, ref):       # the combine's sum makes -0.0 +0.0
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_build_sharded_kvs_bucket_past_the_shards_raises():
    """64 buckets over 3 shards leave bucket 63 in no shard's 21: both
    builds refuse an entry there."""
    keys = np.arange(1, 400, dtype=np.uint32)
    vals = np.ones((399, 1), np.float32)
    with pytest.raises(IndexError):
        jpd.build_sharded_kvs(keys, vals, 64, 3)
    with pytest.raises(IndexError):
        tpd.build_sharded_kvs(keys, vals, 64, 3, device="cpu")


# -- byte accounting and device lists --------------------------------------

def test_byte_accounting_equals_reference(mesh1):
    t = _table(512, 32, 0.1)
    jt = jnp.asarray(_np(t))
    want = jpd.pushdown_select(mesh1, "x", 512, jt, 0.0, 1.0)
    got = tpd.pushdown_select(["cpu"], 512, t, 0.0, 1.0)
    assert tpd.bulk_transfer_bytes(t) == jpd.bulk_transfer_bytes(jt)
    assert tpd.pushdown_bytes(got, 32, 4) == jpd.pushdown_bytes(want, 32, 4)


def test_cuda_device_twice_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="appears twice"):
        tpd.shard_devices(["cuda", "cuda:0"])
    assert len(tpd.shard_devices(["cpu"] * 3)) == 3


@pytest.mark.parametrize("entry", ["select", "regex", "lookup"])
def test_default_devices_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _table(256, 8, 0.5)
    calls = {
        "select": lambda: tpd.pushdown_select(None, 16, t, 0.0, 1.0),
        "regex": lambda: tpd.pushdown_regex(
            None, 16, tregex.compile_regex("a"), t, 2, 6),
        "lookup": lambda: tpd.pushdown_lookup(None, tpd.build_sharded_kvs(
            np.arange(4, dtype=np.uint32), np.ones((4, 1)), 4, 1,
            device="cpu"), np.arange(3, dtype=np.uint32), 4),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpd.build_sharded_kvs(np.arange(4, dtype=np.uint32),
                              np.ones((4, 1)), 4, 1)


# -- repairs: the float field's saturating cast, capacity 0, bf16 tables ----

FIELD_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float16": (jnp.float16, torch.float16)}


def _f32(a):
    """Rows of any float dtype as float32 numpy (NaN compares equal in
    ``assert_array_equal``)."""
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype", list(FIELD_DTYPES))
def test_field_bytes_saturates_as_reference(dtype):
    from repro_torch.nmp.dfa import field_bytes
    v = np.array([300.0, -1.0, 376.0, np.nan, np.inf, -np.inf, 65.7, 255.9,
                  -0.5, 120.0, 0.0, 255.0], np.float32)
    jd, td = FIELD_DTYPES[dtype]
    want = np.asarray(jnp.asarray(v, jd).astype(jnp.uint8))
    got = field_bytes(torch.as_tensor(v).to(td))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    ints = np.array([300, -1, 376, 65], np.int32)       # integers wrap
    np.testing.assert_array_equal(
        field_bytes(torch.as_tensor(ints)).numpy(),
        np.asarray(jnp.asarray(ints).astype(jnp.uint8)))


def _float_field_table():
    """256 float rows whose field [1, 6) spells ``xyzzy``; in the even rows
    the ``x`` is 376.0 (saturates to 255; wrapping gives 120, ``x``), and
    other columns hold 300.0, -1.0 and NaN."""
    t = np.full((256, 8), 97.0, np.float32)
    t[:, 1:6] = np.frombuffer(b"xyzzy", np.uint8)
    t[::2, 1] = 376.0
    t[:, 6] = 300.0
    t[1::4, 7] = -1.0
    t[3::4, 7] = np.nan
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pushdown_regex_float_field_equals_reference(mesh1, dtype):
    """The probe of the fault: 128 matches, as the reference finds (a
    wrapping cast matched all 256)."""
    t = _float_field_table()
    jd, td = FIELD_DTYPES[dtype]
    for lo, hi in ((0, 8), (1, 6)):
        want = jpd.pushdown_regex(mesh1, "x", 256,
                                  jregex.compile_regex("xyzzy"),
                                  jnp.asarray(t, jd), lo, hi)
        got = tpd.pushdown_regex(["cpu"], 256, tregex.compile_regex("xyzzy"),
                                 torch.as_tensor(t).to(td), lo, hi)
        assert int(got.counts[0]) == int(want.counts[0]) == 128
        np.testing.assert_array_equal(_f32(got.rows), _f32(want.rows))
        from repro_torch.nmp.dfa import dfa_select
        jp, jc, jm = jdfa.dfa_select(jregex.compile_regex("xyzzy"),
                                     jnp.asarray(t, jd), lo, hi)
        tp, tc, tm = dfa_select(tregex.compile_regex("xyzzy"),
                                torch.as_tensor(t).to(td), lo, hi)
        assert int(tc) == int(jc) == 128
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(_f32(tp), _f32(jp))


def test_capacity_zero_is_every_row_as_reference(mesh1):
    """``capacity=0`` reads as ``capacity or n`` (n: the rows of a
    shard), in ``pushdown_select``, ``pushdown_regex`` and the select
    operator, as in the reference."""
    t = _table(512, 8, 0.4)
    want = jpd.pushdown_select(mesh1, "x", 0, jnp.asarray(_np(t)), 0.0, 1.0)
    got = tpd.pushdown_select(["cpu"], 0, t, 0.0, 1.0)
    assert got.rows.shape == (1, 512, 8)
    _same_result(got, want)
    rt, lo, hi = _regex_table(300)
    want = jpd.pushdown_regex(mesh1, "x", 0, jregex.compile_regex("xyzzy"),
                              jnp.asarray(rt), lo, hi)
    got = tpd.pushdown_regex(["cpu"], 0, tregex.compile_regex("xyzzy"),
                             torch.as_tensor(rt), lo, hi)
    assert got.rows.shape == (1, 300, rt.shape[1])
    _same_result(got, want)
    got = tpd.pushdown_select(["cpu"] * 4, 0, t, 0.0, 1.0)
    assert got.rows.shape == (4, 128, 8)
    jp, jc, _ = jsel.select_scan(jnp.asarray(_np(t)), 0.0, 1.0, capacity=0)
    tp, tc = tsel.compact(t, tsel.predicate(t, 0.0, 1.0), 0)
    np.testing.assert_array_equal(_bits(_np(tp)), _bits(np.asarray(jp)))
    assert int(tc) == int(jc)


def test_pushdown_select_bf16_equals_reference(mesh1):
    """A bf16 table compares in bf16: 0.3 is 0.30078125 there, so rows at
    exactly that value do not pass ``a > 0.3``."""
    t = _table(1024, 8, 0.5).to(torch.bfloat16)
    t[::3, 0] = 0.30078125
    t[1::3, 0] = 0.3125
    want = jpd.pushdown_select(mesh1, "x", 600,
                               jnp.asarray(_f32(t), jnp.bfloat16), 0.3, 1.0)
    got = tpd.pushdown_select(["cpu"], 600, t, 0.3, 1.0)
    np.testing.assert_array_equal(_f32(got.rows), _f32(want.rows))
    np.testing.assert_array_equal(_np(got.counts), np.asarray(want.counts))
