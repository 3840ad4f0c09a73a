"""The port's bit-packed directory planes, several homes, home bandwidth
and shared credits, against the reference.

Packed words are int32 tensors in the port and uint32 arrays in
``repro``, with the same bits: every comparison goes through
``.view(np.int32)`` (or ``convert.engine_state_to_numpy``, which views
them back as uint32).  Integer arithmetic throughout, so every check is
bit-exact.

* the word helpers and the packed directory functions, each against
  ``repro.core.directory_mn`` at R in {8, 33, 64} (W = 1, ragged 2, 2);
* the plain versions of ``packed_any``/``packed_fanout`` against
  ``repro.kernels.ref`` and the Pallas kernels run in interpret mode,
  and their extended forms (several planes read as slices of the packed
  view; the home flags) against the compositions they replace;
* ``step_mn`` leaf by leaf after every step on ``PACKED_CASES`` and on
  the dense H=2, ``home_bw=1`` and ``hreq_shared`` options.

The streams of these options are in ``tests/test_torch_homes.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import directory_mn as jdmn  # noqa: E402
from repro.core.engine_mn import EngineMN as JEngine  # noqa: E402
from repro.core.protocol import FULL_MOESI as J_FULL_MOESI  # noqa: E402
from repro.core.protocol import MnAbsorb, bake_mn  # noqa: E402
from repro.kernels import coherency_step as jcoh  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import directory_mn as dmn  # noqa: E402
from repro_torch.core.engine_mn import EngineMN  # noqa: E402
from repro_torch.core.protocol import FULL_MOESI, device_tables  # noqa: E402
from repro_torch.kernels import coherency_step as K  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.traffic import EngineConfig  # noqa: E402

SEED = 4321
#: (R, H, moesi): W=1, ragged W=2 and full W=2 words, one and two homes
#: (the cases of ``tests/test_coherency_kernels.py::PACKED_CASES``).
PACKED_CASES = [(8, 1, True), (33, 2, False), (64, 2, True)]
RS = (8, 33, 64)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _t(x):
    """numpy -> tensor; uint32 words become int32 with the same bits."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.as_tensor(x.copy())


def _words(x) -> np.ndarray:
    """A reference word array or a port word tensor, as int32 bits."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _assert_words(got, want, what=""):
    g, w = _words(got), _words(want)
    assert g.dtype == np.int32 and w.dtype == np.int32, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_same(j_tree, t_state, what):
    a = convert.flatten(_np_tree(j_tree))
    b = convert.flatten(convert.engine_state_to_numpy(t_state)
                        if hasattr(t_state, "hreq_pending") else t_state)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")


def _mask(rng, shape, p=0.4):
    return rng.random(shape) < p


def _packed_view(rng, R, L, lead=()):
    """A reference packed view ``[*lead, 2, L, W]`` with EXCL inside PRES,
    bits 31 and 63 used where R allows."""
    pres_m = _mask(rng, lead + (R, L), 0.5)
    pres_m[..., R - 1, 0] = True
    excl_m = pres_m & _mask(rng, lead + (R, L), 0.4)
    pres = jdmn.pack_mask(jnp.asarray(pres_m))
    excl = jdmn.pack_mask(jnp.asarray(excl_m))
    return jnp.stack([pres, excl], axis=-3)


# ---------------------------------------------------------------------------
# word helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (2,)], ids=["flat", "homes"])
@pytest.mark.parametrize("R", RS)
def test_pack_unpack_roundtrip(R, lead):
    rng = np.random.default_rng(SEED + R)
    L = 12
    m = _mask(rng, lead + (R, L))
    m[..., R - 1, :3] = True                # the top bit of the last word
    if R >= 32:
        m[..., 31, 3:6] = True              # bit 31: the int32 sign bit
    want = jdmn.pack_mask(jnp.asarray(m))
    got = dmn.pack_mask(torch.as_tensor(m))
    assert tuple(got.shape) == lead + (L, dmn.n_words(R))
    assert dmn.n_words(R) == jdmn.n_words(R)
    _assert_words(got, want)
    back = dmn.unpack_mask(got, R)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), m)
    np.testing.assert_array_equal(
        dmn.unpack_mask(_t(want), R).numpy(),
        np.asarray(jdmn.unpack_mask(want, R)))


def test_pack_mask_wraps_all_ones():
    """All 64 bits set: each word is -1 in int32, 0xffffffff in uint32."""
    m = np.ones((64, 3), bool)
    got = dmn.pack_mask(torch.as_tensor(m))
    assert (got == -1).all()
    _assert_words(got, jdmn.pack_mask(jnp.asarray(m)))


@pytest.mark.parametrize("R", RS)
def test_node_hot_get_bit_write_bit(R):
    rng = np.random.default_rng(SEED + 2 * R)
    L = 16
    W = dmn.n_words(R)
    node = rng.integers(0, R, (L,)).astype(np.int32)
    node[:4] = [0, R - 1, min(31, R - 1), min(32, R - 1)]
    _assert_words(dmn.node_hot(torch.as_tensor(node), W),
                  jdmn.node_hot(jnp.asarray(node), W))
    words = jdmn.pack_mask(jnp.asarray(_mask(rng, (R, L), 0.5)))
    np.testing.assert_array_equal(
        dmn.get_bit(_t(words), torch.as_tensor(node)).numpy(),
        np.asarray(jdmn.get_bit(words, jnp.asarray(node))))
    do = rng.random(L) < 0.5
    clear = ~do & (rng.random(L) < 0.5)
    want = jdmn.write_bit(words, jnp.asarray(do), jnp.asarray(clear),
                          jnp.asarray(node))
    got = dmn.write_bit(_t(words), torch.as_tensor(do),
                        torch.as_tensor(clear), torch.as_tensor(node))
    _assert_words(got, want)


@pytest.mark.parametrize("R", RS)
def test_any_bits(R):
    rng = np.random.default_rng(SEED + 3 * R)
    m = _mask(rng, (2, R, 20), 0.03)
    m[..., R - 1, 0] = True
    words = jdmn.pack_mask(jnp.asarray(m))
    got = dmn.any_bits(_t(words))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdmn.any_bits(words)))


# ---------------------------------------------------------------------------
# packed directory functions
# ---------------------------------------------------------------------------


def _dir_pair(rng, R, L, lead=()):
    """The same packed directory state in both packages."""
    B = 2
    backing = rng.normal(size=lead + (L, B)).astype(np.float32)
    view = _packed_view(rng, R, L, lead)
    hs = rng.integers(0, 4, lead + (L,)).astype(np.int8)
    buf = rng.normal(size=lead + (L, B)).astype(np.float32)
    j = jdmn.DirectoryMNState(
        home_state=jnp.asarray(hs), view=view, backing=jnp.asarray(backing),
        home_buf=jnp.asarray(buf), illegal=jnp.zeros((), jnp.int32))
    t = dmn.DirectoryMNState(
        home_state=torch.as_tensor(hs), view=_t(view),
        backing=torch.as_tensor(backing), home_buf=torch.as_tensor(buf),
        illegal=torch.zeros((), dtype=torch.int32))
    return j, t


def _assert_dir(jd, td, what):
    for f in jdmn.DirectoryMNState._fields:
        a, b = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
        if a.dtype == np.uint32:
            _assert_words(b, a, f"{what}: {f}")
        else:
            assert a.dtype == b.dtype, f"{what}: {f}"
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("lead", [(), (2,)], ids=["flat", "homes"])
@pytest.mark.parametrize("R", RS)
def test_view_of_needed_and_home_needed_words(R, lead):
    rng = np.random.default_rng(SEED + 5 * R)
    L = 24
    jd, td = _dir_pair(rng, R, L, lead)
    node = rng.integers(0, R, lead + (L,)).astype(np.int32)
    np.testing.assert_array_equal(
        dmn.view_of(td, torch.as_tensor(node)).numpy(),
        np.asarray(jdmn.view_of(jd, jnp.asarray(node))))
    active = rng.random(lead + (L,)) < 0.7
    msg = rng.integers(0, 16, lead + (L,)).astype(np.int8)
    for got, want in zip(
            dmn.needed_words(td, torch.as_tensor(active),
                             torch.as_tensor(msg), torch.as_tensor(node)),
            jdmn.needed_words(jd, jnp.asarray(active), jnp.asarray(msg),
                              jnp.asarray(node))):
        _assert_words(got, want, "needed_words")
    # The home side: ``needed_words`` with the home flags and no request
    # active gives the reference's ``home_needed_words`` on every line.
    wr = rng.random(lead + (L,)) < 0.5
    ww = rng.random(lead + (L,)) < 0.5
    for got, want in zip(
            dmn.needed_words(td, torch.zeros(lead + (L,), dtype=torch.bool),
                             torch.as_tensor(msg), torch.as_tensor(node),
                             home_read=torch.as_tensor(wr),
                             home_write=torch.as_tensor(ww)),
            jdmn.home_needed_words(jd, jnp.asarray(wr), jnp.asarray(ww))):
        _assert_words(got, want, "home_needed_words")


@pytest.mark.parametrize("moesi", [True, False], ids=["moesi", "mesi"])
@pytest.mark.parametrize("R", RS)
def test_absorb_and_grant_packed(R, moesi):
    from repro.core.protocol import ENHANCED_MESI as J_MESI
    from repro_torch.core.protocol import ENHANCED_MESI
    rng = np.random.default_rng(SEED + 7 * R + moesi)
    L, B = 24, 2
    jt = bake_mn(J_FULL_MOESI if moesi else J_MESI)
    tt = device_tables(FULL_MOESI if moesi else ENHANCED_MESI, "cpu")
    jd, td = _dir_pair(rng, R, L)
    active = rng.random((R, L)) < 0.2
    kind = rng.choice([int(MnAbsorb.VOL_I), int(MnAbsorb.REPLY_S),
                       int(MnAbsorb.REPLY_I)], (R, L)).astype(np.int8)
    # at most one dirty source per line (single writer).
    dirty = np.zeros((R, L), bool)
    src = rng.integers(0, R, L)
    dirty[src, np.arange(L)] = rng.random(L) < 0.5
    pay = rng.normal(size=(R, L, B)).astype(np.float32)
    jd2 = jdmn.absorb(jt, jd, jnp.asarray(active), jnp.asarray(kind),
                      jnp.asarray(dirty), jnp.asarray(pay))
    td2 = dmn.absorb(tt, td, torch.as_tensor(active), torch.as_tensor(kind),
                     torch.as_tensor(dirty), torch.as_tensor(pay))
    _assert_dir(jd2, td2, "absorb")
    g_act = rng.random(L) < 0.6
    msg = rng.choice([1, 2, 3, 4], L).astype(np.int8)       # requests
    node = rng.integers(0, R, L).astype(np.int32)
    jd3, jresp, jval = jdmn.grant(jt, jd2, jnp.asarray(g_act),
                                  jnp.asarray(msg), jnp.asarray(node))
    td3, tresp, tval = dmn.grant(tt, td2, torch.as_tensor(g_act),
                                 torch.as_tensor(msg),
                                 torch.as_tensor(node))
    _assert_dir(jd3, td3, "grant")
    np.testing.assert_array_equal(tresp.numpy(), np.asarray(jresp))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


# ---------------------------------------------------------------------------
# plain kernel versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 1), (8, 2), (3, 16, 2), (64, 3),
                                   (2, 2048, 2)])
def test_packed_any_plain_equals_reference(shape):
    rng = np.random.default_rng(SEED)
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    w = np.where(rng.random(shape) < 0.5, w, 0).astype(np.uint32)
    w.reshape(-1)[:4] = [0x80000000, 0xffffffff, 0, 1]
    want = np.asarray(jref.packed_any_ref(jnp.asarray(w)))
    got = tref.packed_any_ref(_t(w))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcoh.packed_any(jnp.asarray(w),
                                                interpret=True)))


@pytest.mark.parametrize("lead", [(), (2,)], ids=["flat", "homes"])
@pytest.mark.parametrize("R,L", [(8, 16), (33, 8), (64, 32)])
def test_packed_fanout_plain_equals_reference(R, L, lead):
    rng = np.random.default_rng(SEED + R)
    view = _packed_view(rng, R, L, lead)
    pres, excl = view[..., 0, :, :], view[..., 1, :, :]
    node = rng.integers(0, R, lead + (L,)).astype(np.int32)
    node.reshape(-1)[:2] = [R - 1, min(31, R - 1)]
    sh = rng.random(lead + (L,)) < 0.5
    ex = (rng.random(lead + (L,)) < 0.5) & ~sh
    args = (pres, excl, jnp.asarray(node), jnp.asarray(sh), jnp.asarray(ex))
    want = jref.packed_fanout_ref(*args)
    pallas = jcoh.packed_fanout(*args, interpret=True)
    got = tref.packed_fanout_ref(_t(pres), _t(excl), torch.as_tensor(node),
                                 torch.as_tensor(sh), torch.as_tensor(ex))
    for g, w, p in zip(got, want, pallas):
        assert tuple(g.shape) == lead + (L, dmn.n_words(R))
        _assert_words(g, w)
        _assert_words(g, p)


#: the multi-plane ``packed_any`` cases: one-word (R=8), ragged two-word
#: (R=33) and bit-31-only planes, and strided slices of the packed
#: ``[H, 2, L/H, W]`` view and pending arrays, as the step's grant test
#: reads them.
ANY_CASES = ["W=1 (R=8)", "ragged W=2 (R=33)", "bit 31", "view slices"]


def _any_planes(rng, case, n, L=40):
    """(reference uint32 planes, port int32 planes) of ``n`` sparse word
    planes of one shape for ``case``.  Line 0 is empty in every plane and
    line 1 set only in the last, so the OR differs from its first plane."""
    R = {"W=1 (R=8)": 8, "ragged W=2 (R=33)": 33}.get(case, 64)
    lead = (2,) if case == "view slices" else ()
    masks = []
    for k in range(n + n % 2 if lead else n):
        m = _mask(rng, lead + (R, L), 0.01)
        if case == "bit 31":
            m = np.zeros_like(m)
            m[..., 31, :] = rng.random(lead + (L,)) < 0.15
        m[..., :, :2] = False
        masks.append(m)
    masks[n - 1][..., 31 if case == "bit 31" else R - 1, 1] = True
    words = [np.asarray(jdmn.pack_mask(jnp.asarray(m))) for m in masks]
    if not lead:
        return words, [_t(w) for w in words]
    # two [H, 2, L/H, W] arrays, each plane a slice [:, p] of one of them
    arrs = [np.stack(words[i:i + 2], axis=-3) for i in (0, 2)[:len(words)
                                                             // 2]]
    t_arrs = [_t(a) for a in arrs]
    j = [a[:, p] for a in arrs for p in (0, 1)][:n]
    t = [a[:, p] for a in t_arrs for p in (0, 1)][:n]
    assert all(not x.is_contiguous() for x in t)
    return j, t


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ANY_CASES)
def test_packed_any_planes_equal_reference(case, n):
    """The multi-plane twin (and ``any_bits``) equals the reference's
    ``packed_any`` of the planes' OR, the Pallas kernel's of it in
    interpret mode, and the OR of the reference's verdicts per plane."""
    rng = np.random.default_rng(SEED + 11 * n + ANY_CASES.index(case))
    jp, tp = _any_planes(rng, case, n)
    acc = jp[0]
    for p in jp[1:]:
        acc = acc | p
    want = np.asarray(jref.packed_any_ref(jnp.asarray(acc)))
    assert want.any() and not want.all() and want[..., 1].all()
    np.testing.assert_array_equal(
        want, np.logical_or.reduce([np.asarray(jref.packed_any_ref(
            jnp.asarray(p))) for p in jp]))
    np.testing.assert_array_equal(
        np.asarray(jcoh.packed_any(jnp.asarray(acc), interpret=True)), want)
    for got in (tref.packed_any_ref(*tp), K.packed_any(*tp),
                dmn.any_bits(*tp)):
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout,want", [
    ("contiguous", 15), ("view slice", 30), ("one home's slice", 15),
    ("nested lead dims", 30), ("broadcast lead", 0),
    ("words not dense", None), ("lines not dense", None),
    ("lead dims that do not nest", None), ("transposed", None),
    ("one dim", None)])
def test_plane_stride_reads_planes_where_they_lie(layout, want):
    """The words between a plane's ``[L, W]`` blocks, for the layouts the
    packed kernels read in place; None for those they refuse."""
    v = torch.zeros((2, 2, 5, 3), dtype=torch.int32)      # [H, 2, L, W]
    w = torch.zeros((3, 4, 5, 3), dtype=torch.int32)
    t = {"contiguous": v[0, 0], "view slice": v[:, 1],
         "one home's slice": v[1, 0], "nested lead dims": w[:, ::2],
         "broadcast lead": v[0, 0].expand(4, 5, 3),
         "words not dense": v[..., :2], "lines not dense": v[:, :, ::2],
         "lead dims that do not nest": w[::2, :2],
         "transposed": v[:, 0].transpose(0, 1),
         "one dim": v[0, 0, 0]}[layout]
    assert K.plane_stride(t) == want


@pytest.mark.parametrize("case,fits", [
    ("view slices, 2^29 blocks", True),
    ("view slices, 2^29 + 1 blocks", False),
    ("contiguous, 2^31 - 1 words", True),
    ("contiguous, 2^31 words", False),
    ("broadcast plane, 2^31 output words", False)])
def test_plane_span_refused_past_32_bit_index(case, fits):
    """The packed wrappers refuse planes that the kernels' 32-bit index
    cannot reach, naming the limit (meta tensors: no memory is taken)."""
    L, W = 2, 1
    big = torch.empty(2 ** 32, dtype=torch.int32, device="meta")
    # The two planes of a [blocks, 2, L, W] view: each spans
    # (blocks - 1) * 2 * L * W + L * W words, 2^31 - 2 at 2^29 blocks.
    blocks = 2 ** 29 if fits else 2 ** 29 + 1
    planes = {
        "view slices": lambda: (big.as_strided((blocks, L, W),
                                               (2 * L * W, W, 1), L * W),
                                big.as_strided((blocks, L, W),
                                               (2 * L * W, W, 1))),
        "contiguous": lambda: (big[:n].view(-1, 1, W),),
        "broadcast plane": lambda: (big[:L * W].view(L, W)
                                    .expand(2 ** 30, L, W),)}
    n = 2 ** 31 - 1 if fits else 2 ** 31
    got = planes[case.split(",")[0]]()
    assert all(K.plane_stride(p) is not None for p in got)
    if fits:
        K.check_plane_span("packed_any", *got)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            K.check_plane_span("packed_any", *got)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["flat", "homes"])
@pytest.mark.parametrize("R", RS)
def test_packed_fanout_home_flags_equal_reference(R, lead):
    """The home-flag twin equals the reference's remote and home fan-out
    merged by ``jnp.where`` on the flagged lines, on a state with home
    lanes, remote lanes and both request flags, the planes read as slices
    of the packed view; and ``needed_words`` with the home flags equals
    ``where(is_home_txn, home_needed_words, needed_words)``, the merge the
    engine's fan-out phase made before."""
    rng = np.random.default_rng(SEED + 13 * R + len(lead))
    L = 32
    shape = lead + (L,)
    jd, td = _dir_pair(rng, R, L, lead)
    node = rng.integers(0, R, shape).astype(np.int32)
    node.reshape(-1)[:2] = [R - 1, min(31, R - 1)]
    is_home = rng.random(shape) < 0.4
    hr = is_home & (rng.random(shape) < 0.6)
    hw = is_home & (rng.random(shape) < 0.6)
    sh, ex = rng.random(shape) < 0.5, rng.random(shape) < 0.5
    home = hr | hw
    assert (sh & ex & ~home).any() and (hr & hw).any() and \
        (hr & ~hw).any() and (hw & ~hr).any() and (is_home & ~home).any()
    pres, excl = jd.view[..., 0, :, :], jd.view[..., 1, :, :]
    remote = jref.packed_fanout_ref(pres, excl, jnp.asarray(node),
                                    jnp.asarray(sh), jnp.asarray(ex))
    home_w = jdmn.home_needed_words(jd, jnp.asarray(hr), jnp.asarray(hw))
    want = [jnp.where(jnp.asarray(home)[..., None], h, r)
            for h, r in zip(home_w, remote)]
    tpres, texcl = td.view[..., 0, :, :], td.view[..., 1, :, :]
    args = (tpres, texcl, torch.as_tensor(node), torch.as_tensor(sh),
            torch.as_tensor(ex), torch.as_tensor(hr), torch.as_tensor(hw))
    for got in (tref.packed_fanout_ref(*args), K.packed_fanout(*args)):
        for g, w in zip(got, want):
            assert tuple(g.shape) == shape + (dmn.n_words(R),)
            _assert_words(g, w)
    active = rng.random(shape) < 0.8
    msg = rng.integers(0, 16, shape).astype(np.int8)
    msg[is_home] = 100                      # the engine's HOME_TXN code
    act = active & ~is_home
    merged = [jnp.where(jnp.asarray(is_home)[..., None], h, r)
              for h, r in zip(home_w, jdmn.needed_words(
                  jd, jnp.asarray(act), jnp.asarray(msg),
                  jnp.asarray(node)))]
    got = dmn.needed_words(td, torch.as_tensor(act), torch.as_tensor(msg),
                           torch.as_tensor(node),
                           home_read=torch.as_tensor(hr),
                           home_write=torch.as_tensor(hw))
    for g, w in zip(got, merged):
        _assert_words(g, w)


def test_cpu_packed_wrappers_take_the_plain_versions():
    """On CPU tensors the packed wrappers return the plain results and
    launch nothing, in every form: one plane or several, with or without
    the home flags (which go together)."""
    rng = np.random.default_rng(SEED)
    K.reset_launches()
    w = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (2, 16, 2),
                                     dtype=np.int64).astype(np.int32))
    assert torch.equal(K.packed_any(w), tref.packed_any_ref(w))
    assert torch.equal(K.packed_any(w, ~w, w), tref.packed_any_ref(w, ~w, w))
    node = torch.as_tensor(rng.integers(0, 64, (2, 16)).astype(np.int32))
    sh = torch.as_tensor(rng.random((2, 16)) < 0.5)
    ex = ~sh
    for flags in ((), (sh, ex)):
        for a, b in zip(K.packed_fanout(w, w, node, sh, ex, *flags),
                        tref.packed_fanout_ref(w, w, node, sh, ex, *flags)):
            assert torch.equal(a, b)
    assert K.launches["packed_any"] == K.launches["packed_fanout"] == 0
    with pytest.raises(ValueError):
        K.packed_any()
    with pytest.raises(ValueError):
        K.packed_any(*[w] * (K.MAX_PLANES + 1))
    with pytest.raises(ValueError):
        K.packed_fanout(w, w, node, sh, ex, home_read=sh)


# ---------------------------------------------------------------------------
# step_mn leaf by leaf
# ---------------------------------------------------------------------------


def _schedule(rng, R, L, B, t, n_ops):
    op = np.zeros((R, L), np.int8)
    if t < n_ops:
        for r in range(R):
            op[r, rng.integers(0, L)] = rng.choice([1, 2, 3])
    val = rng.normal(size=(R, L, B)).astype(np.float32)
    wr = (rng.random(L) < 0.05) & (t < n_ops)
    ww = (rng.random(L) < 0.05) & (t < n_ops)
    wv = rng.normal(size=(L, B)).astype(np.float32)
    return op, val, wr, ww, wv


def _drive_leaf_by_leaf(R, moesi, steps=48, credits=None, **kw):
    L, B = 16, 2
    rng = np.random.default_rng(SEED + R)
    backing = rng.normal(size=(L, B)).astype(np.float32)
    je = JEngine(jnp.asarray(backing), n_remotes=R, moesi=moesi,
                 credits=credits, **kw)
    te = EngineMN(backing, n_remotes=R, moesi=moesi, credits=credits,
                  device="cpu", **kw)
    js = je.init()
    ts = te.init()
    _assert_same(js, ts, "init")
    for t in range(steps):
        op, val, wr, ww, wv = _schedule(rng, R, L, B, t, steps - 16)
        js, jo = je.step(js, *(jnp.asarray(x) for x in
                               (op, val, wr, ww, wv)))
        ts, to = te.step(ts, *(torch.as_tensor(x) for x in
                               (op, val, wr, ww, wv)))
        _assert_same(js, ts, f"state after step {t}")
        _assert_same(jo, to, f"output of step {t}")
    assert int(ts.msg_count.sum()) > 0
    return te, ts


@pytest.mark.parametrize("R,H,moesi", PACKED_CASES)
def test_step_mn_packed_leaf_by_leaf(R, H, moesi):
    te, ts = _drive_leaf_by_leaf(R, moesi, n_homes=H, packed=True)
    assert ts.hreq_pending.dtype == torch.int32
    assert tuple(ts.dir.view.shape) == (2, 16, dmn.n_words(R))
    st = te.drain(ts, 512)
    assert te.quiescent(st)


@pytest.mark.parametrize("kw", [dict(n_homes=2), dict(home_bw=1),
                                dict(n_homes=2, home_bw=1),
                                dict(shared_credits=True)],
                         ids=["h2", "home_bw1", "h2_home_bw1", "shared"])
def test_step_mn_dense_options_leaf_by_leaf(kw):
    # a credit of 3 makes the shared pool bind at R=8.
    credits = np.asarray([3] * 10, np.int32) \
        if kw.get("shared_credits") else None
    _drive_leaf_by_leaf(8, True, credits=credits, **kw)


def test_state_convert_roundtrip_packed():
    je = JEngine(jnp.zeros((8, 3), jnp.float32), n_remotes=40, packed=True)
    js = _np_tree(je.init())
    ts = convert.engine_state_to_torch(js, "cpu")
    assert ts.dir.view.dtype == torch.int32
    assert ts.hreq_pending.dtype == torch.int32
    _assert_same(js, ts, "roundtrip")


def test_engine_argument_checks():
    z = np.zeros((12, 2), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        EngineMN(z, n_remotes=2, n_homes=5, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        EngineMN(z, n_remotes=2, n_homes=0, device="cpu")
    with pytest.raises(ValueError, match="home_bw"):
        EngineMN(z, n_remotes=2, home_bw=-1, device="cpu")
    with pytest.raises(ValueError, match="divide lines"):
        EngineConfig(remotes=2, lines=12, homes=5)
    e = EngineConfig(remotes=2, lines=12, homes=3, home_bw=1,
                     shared_credits=True, packed=True).build("cpu")
    assert (e.n_homes, e.home_bw, e.shared_credits, e.packed) == \
        (3, 1, True, True)
