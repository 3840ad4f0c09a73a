"""The port's checkpoints against ``repro.checkpoint``, on the CPU.

* the port's msgpack (``checkpoint.codec.packb``) gives the bytes of
  ``msgpack.packb(obj, use_bin_type=True)`` on a checkpoint's objects
  and at every length boundary of the subset it writes, and reads them
  back as ``msgpack.unpackb`` does;
* its zstd frames of raw blocks decompress exactly in ``zstandard``, and
  it reads ``zstandard``'s compressed frames (through the package);
* a checkpoint written by the port loads in ``repro.checkpoint.load``
  into the reference's ``TrainState`` of each smoke config, and one the
  reference wrote loads in the port, bit for bit (fp32 and bf16);
* corruption is detected and ``latest_valid`` skips it;
* without ``msgpack`` and ``zstandard`` (a fresh interpreter where both
  imports fail, as on the card's machine) the port writes, verifies and
  loads its own checkpoints;
* ``model_params_to_numpy`` inverts ``model_params_to_torch`` for all
  ten configs.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import msgpack
import numpy as np
import pytest
import zstandard

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import init_state as j_init_state  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import codec  # noqa: E402

ARCHS = ["smollm-360m", "gemma2-9b", "granite-34b", "nemotron-4-340b",
         "chameleon-34b", "recurrentgemma-9b", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "rwkv6-3b", "whisper-small"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_state(arch, dtype=None, seed=0):
    """A reference ``TrainState`` with non-zero moments, a step and a
    data step (and its config)."""
    cfg = jconfigs.get_config(arch, smoke=True)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = j_init_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)

    def moment(p):
        return jax.numpy.asarray(rng.standard_normal(p.shape), np.float32)

    opt = jadamw.OptState(jax.numpy.asarray(7, np.int32),
                          jax.tree_util.tree_map(moment, params),
                          jax.tree_util.tree_map(moment, params))
    return cfg, JTrainState(params, opt, jax.numpy.asarray(7, np.int32))


def _t_cfg(arch, dtype=None):
    cfg = tconfigs.get_config(arch, smoke=True)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _leaves_equal(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8))


# -- msgpack -------------------------------------------------------------------

_EDGES = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
          2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
          -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0, 1.5,
          1e300, float("inf"), "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
          "é" * 40000, b"", b"x" * 255, b"x" * 256, b"x" * 65535,
          b"x" * 65536, [], list(range(15)), list(range(16)),
          list(range(70000)), {}, {str(i): i for i in range(15)},
          {str(i): i for i in range(16)}, {str(i): i for i in range(70000)},
          {"meta": {"step": 3, "arch": "smollm-360m-smoke"},
           "leaves": {".data_step": {"shape": [], "dtype": "int32",
                                     "data": b"\x01\x02", "sha256": "ab"}},
           "manifest_sha": "00"}]


@pytest.mark.parametrize("obj", _EDGES, ids=range(len(_EDGES)))
def test_msgpack_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == want
    back = codec.unpackb(want)
    ref = msgpack.unpackb(want, raw=False)
    assert _plain(back) == ref


def _plain(x):
    """memoryviews (the port's ``bin``) as bytes, for comparison."""
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def test_checkpoint_file_is_msgpack_packb(tmp_path):
    """A whole port checkpoint is the bytes ``msgpack.packb`` gives for
    the object ``msgpack.unpackb`` reads from it."""
    cfg, js = _j_state("granite-moe-1b-a400m")
    tcfg = _t_cfg("granite-moe-1b-a400m")
    ts = convert.train_state_to_torch(_np(js), tcfg, "cpu")
    path = tck.save(str(tmp_path / "a.ckpt"),
                    convert.stack_train_state(ts, tcfg),
                    meta={"step": 7, "arch": tcfg.name, "lr": 0.5})
    blob = open(path, "rb").read()
    obj = msgpack.unpackb(blob, raw=False)
    assert msgpack.packb(obj, use_bin_type=True) == blob
    assert codec.packb(obj) == blob
    assert obj["meta"] == {"step": 7, "arch": tcfg.name, "lr": 0.5}


# -- zstd ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 131071, 131072, 131073, 400000])
def test_zstd_raw_frames_decompress_in_zstandard(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    frame = codec.zstd_frame(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert codec.zstd_decode(frame) == data
    fp = zstandard.get_frame_parameters(frame)
    assert fp.content_size == n


@pytest.mark.parametrize("n", [0, 5, 300000])
def test_zstd_reads_zstandard_frames(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 4, n, np.uint8).tobytes() + b"\0" * n
    for level in (1, 3, 19):
        frame = zstandard.ZstdCompressor(level=level).compress(data)
        assert codec.zstd_decode(frame) == data


def test_zstd_rle_block():
    # one RLE block of 1000 bytes 'z', last block, content size 1000.
    frame = codec.ZSTD_MAGIC + b"\xe0" + (1000).to_bytes(8, "little") + \
        ((1000 << 3) | (1 << 1) | 1).to_bytes(3, "little") + b"z"
    assert codec.zstd_decode(frame) == b"z" * 1000
    assert zstandard.ZstdDecompressor().decompress(frame) == b"z" * 1000


# -- cross-package loads --------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_in_reference(tmp_path, arch, dtype):
    cfg, js = _j_state(arch, dtype)
    tcfg = _t_cfg(arch, dtype)
    ts = convert.train_state_to_torch(_np(js), tcfg, "cpu")
    if dtype == "bfloat16":
        assert ts.params["embed"]["tok"].dtype == torch.bfloat16
    path = tck.save(str(tmp_path / "step_7.ckpt"),
                    convert.stack_train_state(ts, tcfg),
                    meta={"step": 7, "arch": tcfg.name})
    assert jck.verify(path) and tck.verify(path)
    like = j_init_state(j_init_params(jax.random.key(1), cfg))
    back, meta = jck.load(path, like)
    assert meta == {"step": 7, "arch": tcfg.name}
    _leaves_equal(back, js)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_loads_in_port(tmp_path, arch, dtype):
    cfg, js = _j_state(arch, dtype, seed=3)
    tcfg = _t_cfg(arch, dtype)
    path = jck.save(str(tmp_path / "step_7.ckpt"), js,
                    meta={"step": 7, "arch": cfg.name})
    assert tck.verify(path)
    like = convert.stack_train_state(
        convert.train_state_to_torch(_np(j_init_state(j_init_params(
            jax.random.key(1), cfg))), tcfg, "cpu"), tcfg)
    stacked, meta = tck.load(path, like, device="cpu")
    assert meta == {"step": 7, "arch": cfg.name}
    got = convert.unstack_train_state(stacked, tcfg)
    want = convert.train_state_to_torch(_np(js), tcfg, "cpu")
    la, lb = ttree.leaves(got), ttree.leaves(want)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keys_are_the_references(tmp_path):
    cfg, js = _j_state("recurrentgemma-9b")
    tcfg = _t_cfg("recurrentgemma-9b")
    st = convert.stack_train_state(
        convert.train_state_to_torch(_np(js), tcfg, "cpu"), tcfg)
    keys = sorted(ttree.key(p) for p, _ in ttree.leaves_with_path(st))
    assert keys == sorted(jck._flatten(js))
    assert ".params/layers/slot0/ffn/w1" in keys
    assert ".opt/.m/embed/tok" in keys and ".data_step" in keys


def test_load_missing_leaf_raises(tmp_path):
    path = tck.save(str(tmp_path / "x.ckpt"), {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        tck.load(path, {"a": torch.zeros(3), "b": torch.zeros(1)},
                 device="cpu")


def test_leaf_dtypes_and_shapes_roundtrip(tmp_path):
    tree = {"f": torch.randn(3, 5), "h": torch.randn(4).bfloat16(),
            "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.tensor([True, False]), "e": torch.zeros((0, 3)),
            "s": torch.tensor(5, dtype=torch.int32),
            "q": torch.tensor([-3, 7], dtype=torch.int8),
            "n": [np.arange(4, dtype=np.int64), np.float32(2.5)]}
    path = tck.save(str(tmp_path / "x.ckpt"), tree, meta={"k": [1, 2]})
    back, meta = tck.load(path, tree, device="cpu")
    assert meta == {"k": [1, 2]}
    for (p, a), (_, b) in zip(ttree.leaves_with_path(back),
                              ttree.leaves_with_path(tree)):
        b = tck._host(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert torch.equal(a, b), p
    obj = msgpack.unpackb(open(path, "rb").read(), raw=False)
    assert obj["leaves"]["h"]["dtype"] == "bfloat16"
    assert obj["leaves"]["n/1"]["shape"] == []


# -- integrity -----------------------------------------------------------------

def _state_ckpt(tmp_path, name):
    tcfg = _t_cfg("smollm-360m")
    _, js = _j_state("smollm-360m")
    st = convert.stack_train_state(
        convert.train_state_to_torch(_np(js), tcfg, "cpu"), tcfg)
    return tck.save(str(tmp_path / name), st, meta={"step": 1}), st


def test_corruption_detected(tmp_path):
    path, st = _state_ckpt(tmp_path, "step_1.ckpt")
    assert tck.verify(path)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert not tck.verify(path)
    assert not jck.verify(path)
    with pytest.raises(IOError, match="corruption"):
        tck.load(path, st, device="cpu")


def test_truncated_checkpoint_fails_verify(tmp_path):
    path, _ = _state_ckpt(tmp_path, "step_1.ckpt")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) - 100])
    assert not tck.verify(path)


def test_latest_valid_skips_corrupt(tmp_path):
    d = tmp_path / "ck"
    p1, _ = _state_ckpt(d, "step_1.ckpt")
    p2, _ = _state_ckpt(d, "step_2.ckpt")
    assert tck.latest_valid(str(d)) == p2
    with open(p2, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    assert tck.latest_valid(str(d)) == p1
    assert tck.latest_valid(str(tmp_path / "none")) is None
    assert tck.step_path(str(d), 3) == os.path.join(str(d), "step_3.ckpt")


def test_async_checkpointer_copies_in_save(tmp_path):
    """The device-to-host copy happens in ``save``: a tensor changed right
    after the call is saved as it was."""
    saver = tck.AsyncCheckpointer()
    t = {"w": torch.ones(1000)}
    saver.save(str(tmp_path / "a.ckpt"), t, meta={"step": 1})
    t["w"].add_(1.0)
    saver.wait()
    assert saver.last_path == str(tmp_path / "a.ckpt")
    back, _ = tck.load(saver.last_path, t, device="cpu")
    assert torch.equal(back["w"], torch.ones(1000))


def test_async_checkpointer_raises_a_failed_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    saver = tck.AsyncCheckpointer()
    saver.save(str(blocker / "a.ckpt"), {"w": torch.ones(3)})
    with pytest.raises(OSError):
        saver.wait()
    assert saver.last_path is None
    saver.wait()                     # the error is reported once


# -- without msgpack and zstandard ---------------------------------------------------

def test_port_checkpoints_need_neither_package(tmp_path):
    """A fresh interpreter in which ``import msgpack`` and ``import
    zstandard`` fail writes, verifies and loads a port checkpoint (bf16
    and fp32 leaves), and refuses a compressed frame naming the
    package."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["msgpack"] = None
        sys.modules["zstandard"] = None
        import torch
        from repro_torch.checkpoint import checkpoint as ck
        from repro_torch.checkpoint import codec
        tree = {{"a": torch.randn(70000), "b": torch.randn(5).bfloat16(),
                 "c": torch.tensor(3, dtype=torch.int32)}}
        p = ck.save({str(tmp_path / "x.ckpt")!r}, tree, meta={{"step": 3}})
        assert ck.verify(p)
        back, meta = ck.load(p, tree, device="cpu")
        assert meta == {{"step": 3}}
        assert all(torch.equal(back[k], tree[k]) for k in tree)
        frame = codec.ZSTD_MAGIC + b"\\xe0" + (4).to_bytes(8, "little") + \\
            ((4 << 3) | (2 << 1) | 1).to_bytes(3, "little") + b"abcd"
        try:
            codec.zstd_decode(frame)
        except ModuleNotFoundError as e:
            assert "zstandard" in str(e)
        else:
            raise AssertionError("a compressed block must need zstandard")
        assert "msgpack" not in [m for m in sys.modules if sys.modules[m]]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


# -- the way back ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_to_numpy_inverts_to_torch(arch):
    cfg = jconfigs.get_config(arch, smoke=True)
    tcfg = _t_cfg(arch)
    jp = _np(j_init_params(jax.random.key(5), cfg))
    tp = convert.model_params_to_torch(jp, tcfg, "cpu")
    back = convert.model_params_to_numpy(tp, tcfg)
    _leaves_equal(back, jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    again = convert.unstack_model_params(
        convert.stack_model_params(tp, tcfg), tcfg)
    for a, b in zip(ttree.leaves(again), ttree.leaves(tp)):
        assert torch.equal(a, b)


def test_bf16_params_cross_through_fp32_exactly():
    cfg = dataclasses.replace(jconfigs.get_config("smollm-360m", smoke=True),
                              dtype="bfloat16")
    tcfg = _t_cfg("smollm-360m", "bfloat16")
    jp = _np(j_init_params(jax.random.key(5), cfg))
    tp = convert.model_params_to_torch(jp, tcfg, "cpu")
    back = convert.model_params_to_numpy(tp, tcfg)
    assert back["embed"]["tok"].dtype == np.float32
    np.testing.assert_array_equal(back["embed"]["tok"],
                                  jp["embed"]["tok"].astype(np.float32))


def test_train_state_to_numpy_fields():
    cfg, js = _j_state("whisper-small")
    tcfg = _t_cfg("whisper-small")
    ts = convert.train_state_to_torch(_np(js), tcfg, "cpu")
    assert ts.opt.step.dtype == ts.data_step.dtype == torch.int32
    assert int(ts.opt.step) == 7 and len(ts.params["cross"]) == \
        tcfg.n_superlayers
    back = convert.train_state_to_numpy(ts, tcfg)
    _leaves_equal(JTrainState(back.params, jadamw.OptState(*back.opt),
                              back.data_step), _np(js))
