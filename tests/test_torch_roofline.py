"""The port's roofline (``repro_torch.roofline``) against the reference's.

No world is needed: ``analytic_terms`` over every config, its smoke
variant, every shape, five mesh descriptions, the int8 what-ifs, a MoE
with ``dispatch_int8`` and both remat variants equal the reference's
exactly; ``analytic_roofline``, ``model_flops`` and ``Roofline`` equal the
reference's with its hardware constants substituted, and with the port's
own each time is its numerator over the H100's rate; ``mesh_desc`` reads
the dict stand-ins of ``benchmarks/perf_hillclimb.py`` and a
``DeviceMesh``-shaped object as the reference reads a JAX mesh;
``collective_bytes`` equals the reference's on the HLO text of a sharded
function compiled by the reference on 8 forced host devices, and on
hand-written lines.  The counters of ``repro_torch.roofline.count`` on
plain programs under ``FakeTensorMode``: flops equal
``FlopCounterMode``'s over three smoke configs' train steps, and the
bytes, flops and peak of a few known ops equal their closed forms.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC                                 # noqa: E402
from repro.roofline import analysis as RA                       # noqa: E402
from repro.roofline import analytic as RN                       # noqa: E402
from repro_torch import configs as TC                           # noqa: E402
from repro_torch.roofline import analysis as TA                 # noqa: E402
from repro_torch.roofline import analytic as TN                 # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(RC.ARCHS)
MESHES = ((16, 16, 1), (16, 16, 2), (1, 256, 1), (4, 2, 1), (1, 1, 1))
BYTES = ((2, 2), (1, 2), (2, 1), (1, 1))
H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12, "LINK_BW": 50e9}


class FakeMesh:
    shape = {"data": 16, "model": 16}


class FsdpRemapMesh:
    shape = {"data": 256, "model": 1}


class PodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


class TupleMesh:
    """What ``mesh_desc`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def _variants(cfg):
    """The config, its "dots" remat, no remat, and (a MoE) the int8
    dispatch."""
    out = [cfg, dataclasses.replace(cfg, remat_policy="dots"),
           dataclasses.replace(cfg, remat=False)]
    if cfg.moe is not None:
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_int8=True)))
    return out


def _pairs(arch, smoke):
    return list(zip(_variants(RC.get_config(arch, smoke=smoke)),
                    _variants(TC.get_config(arch, smoke=smoke))))


def _cells():
    return [(r, TC.SHAPE_BY_NAME[r.name]) for r in RC.SHAPES]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_reference(arch, smoke):
    n = 0
    for rcfg, tcfg in _pairs(arch, smoke):
        for rcell, tcell in _cells():
            for tp, fsdp, pods in MESHES:
                for wb, kb in BYTES:
                    want = RN.analytic_terms(rcfg, rcell,
                                             RN.MeshDesc(tp, fsdp, pods),
                                             weight_bytes=wb, kv_bytes_elem=kb)
                    got = TN.analytic_terms(tcfg, tcell,
                                            TN.MeshDesc(tp, fsdp, pods),
                                            weight_bytes=wb, kv_bytes_elem=kb)
                    assert got == want, (rcfg.name, rcell.name, tp, fsdp,
                                         pods, wb, kb)
                    n += 1
    assert n >= 3 * 4 * len(MESHES) * len(BYTES)


def test_meshdesc_properties():
    for tp, fsdp, pods in MESHES:
        r, t = RN.MeshDesc(tp, fsdp, pods), TN.MeshDesc(tp, fsdp, pods)
        assert (t.chips, t.dp) == (r.chips, r.dp)


@pytest.mark.parametrize("mesh", [FakeMesh(), FsdpRemapMesh(), PodMesh()],
                         ids=["FakeMesh", "FsdpRemapMesh", "pod"])
def test_mesh_desc_reads_dict_stand_ins(mesh):
    want = RN.mesh_desc(mesh)
    got = TN.mesh_desc(mesh)
    assert (got.tp, got.fsdp, got.pods) == (want.tp, want.fsdp, want.pods)


def test_mesh_desc_reads_a_device_mesh_shape():
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model")),
                         ((2, 4), ("data", "model"))):
        got = TN.mesh_desc(TupleMesh(shape, names))
        want = RN.mesh_desc(type("M", (), {"shape": dict(zip(names, shape))}))
        assert (got.tp, got.fsdp, got.pods) == (want.tp, want.fsdp, want.pods)
    md = TN.MeshDesc(4, 2)
    assert TN.mesh_desc(md) is md


def test_port_constants_are_the_h100s():
    for k, v in H100.items():
        assert getattr(TA, k) == v, k
    text = open(TA.__file__).read()
    for tpu in ("197e12", "819e9", "TPU", "v5e", "ICI"):
        assert tpu not in text, tpu


def _ref_constants(monkeypatch):
    for k in H100:
        monkeypatch.setattr(TA, k, getattr(RA, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_roofline_and_model_flops_equal_reference(arch,
                                                           monkeypatch):
    _ref_constants(monkeypatch)
    for rcfg, tcfg in _pairs(arch, False):
        for rcell, tcell in _cells():
            assert TA.model_flops(tcfg, tcell) == RA.model_flops(rcfg, rcell)
            for mesh in (FakeMesh(), FsdpRemapMesh(), PodMesh()):
                for wb, kb in BYTES:
                    want = RA.analytic_roofline(rcfg, rcell, mesh,
                                                weight_bytes=wb,
                                                kv_bytes_elem=kb)
                    got = TA.analytic_roofline(tcfg, tcell, mesh,
                                               weight_bytes=wb,
                                               kv_bytes_elem=kb)
                    assert got == want, (rcfg.name, rcell.name, wb, kb)


def _roofline(mod, **kw):
    base = dict(arch="a", shape="s", mesh="single", chips=256,
                flops_per_device=3.5e12, bytes_per_device=7.25e10,
                coll_bytes_per_device=1.5e9,
                coll_breakdown={"all-gather": 10 ** 9, "all-reduce": 0},
                model_flops=4.0e14, peak_mem_per_device=1.25e10)
    base.update(kw)
    return mod.Roofline(**base)


@pytest.mark.parametrize("kw", [
    {}, {"flops_per_device": 1e9}, {"coll_bytes_per_device": 1e12},
    {"chips": 512, "peak_mem_per_device": None}, {"flops_per_device": 0.0,
                                                  "bytes_per_device": 0.0,
                                                  "coll_bytes_per_device": 0.0}],
    ids=["memory", "low-flops", "collective", "multi", "zero"])
def test_roofline_to_dict_equals_reference(kw, monkeypatch):
    _ref_constants(monkeypatch)
    assert _roofline(TA, **kw).to_dict() == _roofline(RA, **kw).to_dict()


def test_times_are_numerators_over_the_h100_rates():
    r = _roofline(TA)
    assert r.t_compute == r.flops_per_device / 989e12
    assert r.t_memory == r.bytes_per_device / 3.35e12
    assert r.t_collective == r.coll_bytes_per_device / 50e9
    assert r.roofline_time == max(r.t_compute, r.t_memory, r.t_collective)
    for arch in ARCHS:
        cfg = TC.get_config(arch)
        for cell in TC.SHAPES:
            a = TA.analytic_roofline(cfg, cell, FakeMesh())
            t = TN.analytic_terms(cfg, cell, TN.MeshDesc(16, 16))
            assert a["t_compute"] == t["flops_global"] / 256 / 989e12
            assert a["t_memory"] == t["mem_bytes_dev"] / 3.35e12
            assert a["t_collective"] == t["coll_bytes_dev"] / 50e9


# -- collective_bytes ---------------------------------------------------------

HLO_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    assert len(jax.devices()) == 8
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))

    def body(a, b):
        g = jax.lax.all_gather(a, "x", tiled=True)
        rs = jax.lax.psum_scatter(b, "x", tiled=True)
        s = jax.lax.psum(a * 2.0, "x")
        t = jax.lax.all_to_all(b.reshape(8, -1), "x", 0, 0, tiled=True)
        p = jax.lax.ppermute(a, "x", [(i, (i + 1) % 8) for i in range(8)])
        return g.sum() + rs.sum() + s.sum() + t.sum() + p.sum()

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")),
                              out_specs=P(), check_vma=False))
    a = jnp.ones((64, 16), jnp.float32)
    b = jnp.ones((8 * 64, 4), jnp.bfloat16)
    sys.stdout.write(f.lower(a, b).compile().as_text())
""")


@pytest.fixture(scope="module")
def sharded_hlo():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", HLO_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_collective_bytes_equal_reference_on_compiled_hlo(sharded_hlo):
    got = TA.collective_bytes(sharded_hlo)
    assert got == RA.collective_bytes(sharded_hlo)
    # every one of the five kinds was compiled and counted
    assert all(got[k] > 0 for k in got), got


HAND_HLO = """
  %ag = bf16[2,128,512]{2,1,0} all-gather(%p), dimensions={0}
  %ags = (bf16[2,64]{1,0}, bf16[16,64]{1,0}) all-gather-start(%x), dimensions={0}
  %agd = bf16[16,64]{1,0} all-gather-done(%ags)
  %ars = f32[1024]{0} all-reduce-start(%y), to_apply=%add
  %ard = f32[1024]{0} all-reduce-done(%ars)
  %rs = (f32[8,4]{1,0}, s32[8]{0}) reduce-scatter(%a, %b), dimensions={0}
  %a2a = (f32[1,32]{1,0}, f32[1,32]{1,0}, /*index=2*/f32[1,32]{1,0}) all-to-all(%c, %d, %e)
  %cps = (u8[4096]{0}, u8[4096]{0}, u32[], u32[]) collective-permute-start(%z)
  %cpd = u8[4096]{0} collective-permute-done(%cps)
  %t = token[] after-all()
  %m = pred[7]{0} all-reduce(%q), to_apply=%or
  %not = f32[9]{0} add(%all-gather, %x)
"""


def test_collective_bytes_equal_reference_on_hand_written_lines():
    got = TA.collective_bytes(HAND_HLO)
    assert got == RA.collective_bytes(HAND_HLO)
    assert got == {"all-gather": 2 * 128 * 512 * 2 + (2 + 16) * 64 * 2,
                   "all-reduce": 1024 * 4 + 7,
                   "reduce-scatter": 8 * 4 * 4 + 8 * 4,
                   "all-to-all": 3 * 32 * 4,
                   "collective-permute": 2 * 4096 + 2 * 4}


# -- the counters of one traced call (no world) ------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_counted_flops_equal_flop_counter_mode(arch):
    """The counter's flops are ``FlopCounterMode``'s on a plain program:
    a smoke config's unsharded train step (forward and backward)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import input_specs
    from repro_torch.optim import OptimConfig
    from repro_torch.roofline.count import trace_step
    from repro_torch.train import init_state, train_step
    from repro_torch.tree import tree_map
    cfg = TC.get_config(arch, smoke=True)
    spec = input_specs(cfg, TC.ShapeCell("train_4k", 16, 4, "train"))

    def args():
        fake = lambda t: torch.empty(t.shape, dtype=t.dtype)
        return (init_state(tree_map(fake, spec["state"].params)),
                {k: fake(x) for k, x in spec["batch"].items()})

    step = lambda s, b: train_step(cfg, OptimConfig(), 1, s, b)
    got = trace_step(step, args)
    with FakeTensorMode():
        a = args()
        with FlopCounterMode(display=False) as fc:
            step(*a)
    assert got.flops == fc.get_total_flops() > 0


def test_counted_bytes_and_memory_of_known_ops():
    """Bytes accessed: inputs and outputs of each op, none for a view;
    the peak holds the external argument and what is live at once."""
    from repro_torch.roofline.count import trace_step

    def fn(a, b):
        c = a + b                 # 3 x 4096 bytes
        d = c.view(32, 32)        # a view: none
        return (d @ d).sum()      # mm 3 x 4096, sum 4096 + 4

    got = trace_step(fn, lambda: (torch.empty(1024), torch.empty(1024)))
    assert got.bytes_accessed == 3 * 4096 + 3 * 4096 + 4096 + 4
    assert got.flops == 2 * 32 * 32 * 32
    assert got.argument_bytes == 2 * 4096 and got.output_bytes == 4
    assert got.peak_bytes == 2 * 4096 + 2 * 4096 + 4
    assert got.collective_bytes == dict.fromkeys(got.collective_bytes, 0)
