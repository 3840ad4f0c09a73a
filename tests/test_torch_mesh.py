"""The port's sharding rules and shape stand-ins against ``repro``'s, in
one process (no process group).

* every parameter's spec of the ten smoke configs, in ``"2d"``,
  ``"fsdp"`` and ``"serve"``, and of a quantized config under
  ``"serve"``: the reference's (``repro.launch.sharding.param_specs``)
  with the stacked-layer ``None`` dropped where the reference stacks the
  leaf;
* ``dp_axes``, ``batch_spec``, ``act_spec``, ``kv_cache_spec`` (heads or
  sequence over ``model``) and ``decode_state_specs`` (batch sharded or
  replicated) on stand-in meshes, which carry only the axes' names and
  sizes the rules read, so the model axis can exceed 1 here;
* ``placements``: a spec's DTensor placements, its checks;
* ``bubble_fraction``;
* ``launch/specs.py``: the shapes and dtypes of the ``train``,
  ``prefill`` and ``decode`` cells' inputs equal the reference's
  ``ShapeDtypeStruct``s, with nothing allocated (every tensor on
  ``meta``) and nothing drawn from the generator.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.runtime.pipeline import bubble_fraction as j_bubble  # noqa: E402
from repro.serve.engine import decode_state_specs as j_state_specs  # noqa
from repro.serve.quantize import quantize_params as j_quantize  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.runtime import bubble_fraction  # noqa: E402
from repro_torch.serve import decode_state_specs, quantize_params  # noqa
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

ARCHS = ["smollm-360m", "gemma2-9b", "granite-34b", "nemotron-4-340b",
         "chameleon-34b", "recurrentgemma-9b", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "rwkv6-3b", "whisper-small"]
MODES = ["2d", "fsdp", "serve"]
#: (axes, sizes) of the stand-in meshes: the model axis 1, 2 and 8.
MESHES = [(("data", "model"), (4, 1)), (("data", "model"), (4, 2)),
          (("pod", "data", "model"), (2, 4, 8))]
CELLS = ["train_4k", "prefill_32k", "decode_32k"]


def _meshes(axes, sizes):
    """(the reference's stand-in, the port's): the names and sizes each
    package's rules read."""
    ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    port = types.SimpleNamespace(mesh_dim_names=axes, shape=tuple(sizes))
    return ref, port


def _names(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _ref_flat(tree):
    """reference path names -> leaf, with ``PartitionSpec`` leaves."""
    return {_names(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _ref_path(path, cfg):
    """(the reference's path of a port parameter or decode-state leaf,
    whether the reference stacks it over a leading axis)."""
    path = tuple(p[1:] if isinstance(p, str) and p.startswith(".") else p
                 for p in path)
    P, n = len(cfg.block_pattern), cfg.n_superlayers
    if path[0] == "layers" or isinstance(path[0], int):
        lead = () if isinstance(path[0], int) else ("layers",)
        i, rest = (path[0], path[1:]) if not lead else (path[1], path[2:])
        if i < n * P:
            return lead + (f"slot{i % P}",) + tuple(map(str, rest)), True
        return ("tail", f"tail{i - n * P}") + tuple(map(str, rest)), False
    if path[0] == "encoder" and path[1] == "layers":
        return ("encoder", "layers") + tuple(map(str, path[3:])), True
    if path[0] == "cross":
        return ("cross",) + tuple(map(str, path[2:])), True
    return tuple(map(str, path)), False


def _assert_specs_equal(port_specs, port_tree, ref_specs, cfg):
    want = _ref_flat(ref_specs)
    seen = set()
    for (path, spec), leaf in zip(leaves_with_path(port_specs),
                                  leaves(port_tree)):
        rpath, stacked = _ref_path(path, cfg)
        ref = tuple(want[rpath])
        assert isinstance(spec, sh.PartitionSpec), path
        assert len(spec) <= leaf.ndim, (path, spec)
        assert spec == (ref[1:] if stacked else ref), (path, spec, ref)
        seen.add(rpath)
    assert seen == set(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mode):
    tcfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    tp = tspecs.params_specs(tcfg)
    _assert_specs_equal(sh.param_specs(tp, mode), tp,
                        jsh.param_specs(jspecs.params_specs(jcfg), mode),
                        tcfg)


def test_quantized_param_specs_equal_reference():
    """A quantized tree's ``{"q", "s"}`` leaves under ``"serve"``: ``q``
    like its weight, ``s`` without the contraction axis."""
    arch = "smollm-360m"
    tcfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = convert.model_params_to_torch(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    jq, tq = j_quantize(jp, 1 << 10), quantize_params(tp, 1 << 10, cfg=tcfg)
    specs = sh.param_specs(tq, "serve")
    _assert_specs_equal(specs, tq, jsh.param_specs(jq, "serve"), tcfg)
    wq = specs["layers"][0]["mixer"]["wq"]
    assert wq["q"] == (None, "model") and wq["s"] == ("model",)


@pytest.mark.parametrize("axes,sizes", MESHES)
def test_mesh_rules_equal_reference(axes, sizes):
    jm, tm = _meshes(axes, sizes)
    for mode in MODES:
        assert sh.dp_axes(tm, mode) == jsh.dp_axes(jm, mode)
        for ndim in (2, 3):
            assert sh.batch_spec(tm, ndim, mode) == \
                tuple(jsh.batch_spec(jm, ndim, mode))
    assert sh.act_spec(tm) == tuple(jsh.act_spec(jm))
    # heads over model when they divide, else the sequence: both branches
    # wherever the model axis exceeds 1.
    for n_kv in (1, 2, 4, 8, 16):
        for stacked in (True, False):
            assert sh.kv_cache_spec(tm, n_kv, stacked) == \
                tuple(jsh.kv_cache_spec(jm, n_kv, stacked))
    if sizes[-1] > 1:
        assert sh.kv_cache_spec(tm, sizes[-1], False)[1] == "model"
        assert sh.kv_cache_spec(tm, sizes[-1] + 1, False)[2] == "model"


@pytest.mark.parametrize("shard_batch", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_equal_reference(arch, shard_batch):
    tcfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    tstate = tspecs.decode_state_sds(tcfg, 8, 32)
    jstate = jspecs.decode_state_sds(jcfg, 8, 32)
    for axes, sizes in MESHES:
        jm, tm = _meshes(axes, sizes)
        _assert_specs_equal(decode_state_specs(tcfg, tm, tstate, shard_batch),
                            tstate,
                            j_state_specs(jcfg, jm, jstate, shard_batch),
                            tcfg)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    _, m = _meshes(("pod", "data", "model"), (2, 4, 8))
    assert sh.placements(m, sh.P(("data", "model"), None), (64, 3)) == \
        (Replicate(), Shard(0), Shard(0))
    assert sh.placements(m, sh.P(None, "model"), (3, 16)) == \
        (Replicate(), Replicate(), Shard(1))
    assert sh.placements(m, sh.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.P(("data",), None) == ("data", None)
    bad = [(sh.P(("model", "data"), None), (64, 2), "mesh's order"),
           (sh.P("data", "data"), (8, 8), "two dims"),
           (sh.P("data", None), (6, 2), "does not divide"),
           (sh.P("stage"), (8,), "not one of"),
           (sh.P(None, None, "model"), (8, 8), "more entries")]
    for spec, shape, msg in bad:
        with pytest.raises(ValueError, match=msg):
            sh.placements(m, spec, shape)


def test_bubble_fraction_equals_reference():
    for s in (1, 2, 4, 16):
        for m in (1, 3, 8, 64):
            assert bubble_fraction(s, m) == j_bubble(s, m)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _ref_shapes(tree):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _ref_flat(tree).items()}


def _port_shapes(tree, cfg):
    """The port's tree as the reference's paths: a stacked leaf takes the
    number of superlayers (or encoder layers) in front."""
    if torch.is_tensor(tree):
        assert tree.device.type == "meta"
        return {(): (tuple(tree.shape), _dtype_name(tree))}
    out = {}
    for path, t in leaves_with_path(tree):
        assert t.device.type == "meta", path
        rpath, stacked = _ref_path(path, cfg)
        n = cfg.encoder.n_layers if rpath[:2] == ("encoder", "layers") \
            else cfg.n_superlayers
        shape = ((n,) if stacked else ()) + tuple(t.shape)
        assert out.setdefault(rpath, (shape, _dtype_name(t))) == \
            (shape, _dtype_name(t)), rpath
    return out


def _cell_shapes(spec, cfg, ref: bool):
    """{(part, path): (shape, dtype)} of one cell's inputs, a train
    state's params, moments and counters as parts of their own."""
    out = {}
    for part, tree in spec.items():
        parts = {part: tree}
        if hasattr(tree, "opt"):
            parts = {"params": tree.params, "m": tree.opt.m,
                     "v": tree.opt.v, "step": tree.opt.step,
                     "data_step": tree.data_step}
        for name, sub in parts.items():
            shapes = _ref_shapes(sub) if ref else _port_shapes(sub, cfg)
            out.update({(name,) + k: v for k, v in shapes.items()})
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, cell):
    """Smoke configs at the cells' batch and sequence; the port's tensors
    are all on ``meta``."""
    tcfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    shape = tconfigs.SHAPE_BY_NAME[cell]
    got = tspecs.input_specs(tcfg, shape)
    want = jspecs.input_specs(jcfg, jconfigs.SHAPE_BY_NAME[cell])
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _cell_shapes(got, tcfg, False) == _cell_shapes(want, jcfg, True)


def test_params_specs_full_size_on_meta_draw_nothing():
    """smollm-360m at its published size: the reference's shapes, no
    storage, and the generator's state unchanged."""
    cfg = tconfigs.get_config("smollm-360m")
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state().clone()
    from repro_torch.models import init_params
    p = init_params(cfg, generator=gen, device="meta")
    assert torch.equal(gen.get_state(), before)
    assert all(t.device.type == "meta" for t in leaves(p))
    assert _port_shapes(p, cfg) == _ref_shapes(
        jspecs.params_specs(jconfigs.get_config("smollm-360m")))
