"""The port's mesh paths on a world of 8 ranks, on the CPU.

One ``gloo`` world of 8 processes (``_worker``, one per rank, rendezvous
through a ``dist.FileStore`` under the test's temporary directory, never
a fixed port) runs every check of this file and leaves its results in
files; one subprocess runs the reference's collectives on 8 forced host
devices (``--xla_force_host_platform_device_count=8``, the pattern of
``tests/test_multidevice.py::run_sub``) and leaves them in an ``.npz``;
this process runs the reference's unsharded steps meanwhile.  Held:

* ``make_train_step`` on ``(2, 4)`` ("data", "model") and ``(2, 2, 2)``
  ("pod", "data", "model"), 3 steps, at smoke size in fp32, ``"2d"``
  (tensor parallelism over ``model``, 4 and 2 ranks) and ``"fsdp"``:
  smollm-360m, granite-moe-1b-a400m and ``NONDIV`` (chameleon-34b's
  smoke config with 6 query and 2 kv heads, qk-norm: its query heads
  do not divide over 4 ranks) with one and two micro-batches,
  recurrentgemma-9b, rwkv6-3b and whisper-small (with encoder frames)
  with one: loss (1e-5), grad norm, the first step's moments ``m = 0.1
  g`` (the gradients), and the params and moments after 3 steps against
  ``repro``'s unsharded ``train_step`` on the global batch (atol 1e-5,
  rtol 1e-4).  A MoE routed per rank, a rank's own rows split into
  micro-batches, a replicated shard counted twice in the norm, or a
  leaf that ``model`` replicates given a partial gradient would each
  fail here;
* ``Trainer(mesh=...)`` checkpointing on ``(2, 2, 2)``, resumed with
  ``resume_on_mesh`` onto ``(4, 2)``: bit for bit, and ``repro``'s
  ``checkpoint.load`` reads the same file bit for bit;
* ``SyntheticPipeline(mesh=...)``: each rank's rows are the reference's
  shard of the same device, bit for bit;
* ``compressed_psum`` over 8 ranks (1e-6), ``pipeline_apply`` over 4
  stages (0.0 against serial, and equal to the reference's),
  ``moe_block_local`` over 2 DP shards (2e-5), all against the
  reference's results on 8 devices;
* ``filtered_batch`` over 4 ranks bit for bit against ``pushdown_select``
  over 4 CPU shards;
* ``make_serve_step``, gemma2-9b smoke on ``(2, 2, 2)`` (its 2 kv heads
  over ``model``) and ``(2, 4)`` (the caches' sequence over ``model``),
  recurrentgemma-9b (1 kv head) on ``(2, 4)``, B=8 (batch sharded) and
  B=3 (replicated): logits against ``repro``'s ``decode_step`` at 2e-5.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
#: a config whose query heads ``model`` does not divide on (2, 4): the
#: same replacement of the smoke config in both packages.
NONDIV = "chameleon-34b/heads6"
NONDIV_FIELDS = dict(n_heads=6, n_kv_heads=2, head_dim=8)
#: archs trained with one and two micro-batches, and with one.
TRAIN_MICRO = ("smollm-360m", "granite-moe-1b-a400m", NONDIV)
TRAIN_ONE = ("recurrentgemma-9b", "rwkv6-3b", "whisper-small")
TRAIN_ARCHS = TRAIN_MICRO + TRAIN_ONE
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_CASES = [(a, m, mode, k) for a in TRAIN_ARCHS for m in MESHES
               for mode in ("2d", "fsdp")
               for k in ((1, 2) if a in TRAIN_MICRO else (1,))]
TRAIN_STEPS, TRAIN_B, TRAIN_S = 3, 16, 16
OPTIM = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
SERVE_CASES = (("gemma2-9b", "2x2x2"), ("gemma2-9b", "2x4"),
               ("recurrentgemma-9b", "2x4"))
SERVE_ARCHS = ("gemma2-9b", "recurrentgemma-9b")
SERVE_BATCHES, SERVE_STEPS, SERVE_SEQ = (8, 3), 3, 8
LOSS_TOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
TIMEOUT = 400


def get_config(configs, arch):
    """``configs.get_config(arch, smoke=True)`` of either package, and
    ``NONDIV``'s replacement of it."""
    if arch == NONDIV:
        return dataclasses.replace(configs.get_config(
            arch.split("/")[0], smoke=True), **NONDIV_FIELDS)
    return configs.get_config(arch, smoke=True)


def _frames(cfg, i):
    """Step ``i``'s encoder frames [B, T, d] for an encoder-decoder
    (numpy, the same for both packages), else None."""
    if cfg.encoder is None:
        return None
    rng = np.random.default_rng(100 + i)
    return rng.standard_normal((TRAIN_B, cfg.encoder.n_frames,
                                cfg.d_model)).astype(np.float32)


# -- the world's ranks --------------------------------------------------------

def _train(rank, inputs, out):
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, make_train_step
    meshes = {k: make_mesh(*v, "cpu") for k, v in MESHES.items()}
    for arch, mname, mode, k in TRAIN_CASES:
        cfg, params = inputs[arch]
        mesh = meshes[mname]
        step = make_train_step(cfg, OptimConfig(**OPTIM), mesh, params, k,
                               sharding_mode=mode)
        pipe = SyntheticPipeline(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B),
                                 mesh)
        state, rec = init_state(params), {"loss": [], "grad_norm": []}
        for i in range(TRAIN_STEPS):
            batch = pipe.batch(i)
            if cfg.encoder is not None:
                batch["frames"] = torch.from_numpy(_frames(cfg, i))
            state, m = step(state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            full = sh.full_tree(state)
            if i == 0:
                rec["m1"] = full.opt.m
        rec["state"] = full
        out[f"train/{arch}/{mname}/{mode}/{k}"] = rec


def _checkpoint(rank, inputs, root, out):
    from repro_torch.data import DataConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime import resume_on_mesh
    from repro_torch.train import Trainer, TrainerConfig, init_state
    cfg, params = inputs["smollm-360m"]
    ckdir = os.path.join(root, "ck")
    tr = Trainer(cfg, OptimConfig(**OPTIM),
                 TrainerConfig(steps=4, ckpt_every=2, ckpt_dir=ckdir),
                 make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu"),
                 params, DataConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    tr.run()
    mesh42 = make_mesh((4, 2), ("data", "model"), "cpu")
    back, meta = resume_on_mesh(os.path.join(ckdir, "step_4.ckpt"),
                                init_state(params), mesh42, cfg)
    local = back.params["layers"][0]["mixer"]["wq"]
    out["ckpt"] = {"trained": sh.full_tree(tr.state),
                   "resumed": sh.full_tree(back), "meta": meta,
                   "wq_placements": [str(p) for p in local.placements],
                   "wq_local": tuple(local.to_local().shape)}


def _collectives(rank, inputs, out):
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.data.pipeline import filtered_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.optim import compression
    from repro_torch.runtime import pipeline_apply
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    batch = SyntheticPipeline(DataConfig(64, TRAIN_S, TRAIN_B), mesh
                              ).batch(5)
    out["batch"] = {k: v.to_local() for k, v in batch.items()}
    g = inputs["psum_grads"]
    pod = make_mesh((WORLD,), ("pod",), "cpu")
    mean, err = compression.compressed_psum(
        {"a": g["a"][rank], "b": g["b"][rank]},
        {"a": torch.zeros_like(g["a"][rank]),
         "b": torch.zeros_like(g["b"][rank])}, "pod", pod)
    out["psum"] = {"mean": mean, "err": err}
    stages = make_mesh((4, 2), ("stage", "x"), "cpu")
    ws = torch.stack([torch.full((2,), 1.0 + i) for i in range(4)])
    xm = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    out["pipeline"] = pipeline_apply(
        stages, "stage", lambda w, x: x * w[0] + w[1] * 0.0 + 1.0, ws, xm)
    cfg, p, x = inputs["moe_local"]
    dm = make_mesh((2, 4), ("data", "model"), "cpu")
    y, aux = moe.moe_block_local(p, cfg, x, dm, ("data",))
    out["moe_local"] = {"y": y.full_tensor(), "aux": aux}
    table = inputs["table"]
    res = filtered_batch(stages, "stage", table, 0.0, 1.0, 64)
    out["filtered"] = res


def _serve(rank, inputs, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import make_serve_step
    meshes = {k: make_mesh(*v, "cpu") for k, v in MESHES.items()}
    for arch, mname in SERVE_CASES:
        cfg, params = inputs[arch]
        for B in SERVE_BATCHES:
            state = T.init_decode_state(cfg, B, SERVE_SEQ, "cpu")
            step = make_serve_step(cfg, meshes[mname], state, params,
                                   global_batch=B)
            logits = []
            for i, tok in enumerate(inputs[f"serve_tokens/{arch}/{B}"]):
                lg, state = step(params, tok, i, state)
                logits.append(lg.full_tensor())
            out[f"serve/{arch}/{mname}/{B}"] = {
                "logits": torch.stack(logits),
                "placements": [str(p) for p in lg.placements],
                "cache": [str(p) for p in next(
                    st for st in state if "k" in st)["k"].placements]}


def _worker(rank: int, root: str) -> None:
    """Rank ``rank`` of the world: every check, its results to
    ``root/out_<rank>.pt``."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import close
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT // 2))
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    try:
        _train(rank, inputs, out)
        _checkpoint(rank, inputs, root, out)
        _collectives(rank, inputs, out)
        _serve(rank, inputs, out)
    finally:
        torch.save(out, os.path.join(root, f"out_{rank}.pt"))
        close()


# -- the reference on 8 forced host devices -----------------------------------

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
assert len(jax.devices()) == 8
root = sys.argv[1]
inp = dict(np.load(os.path.join(root, "ref_inputs.npz")))
res = {}
devs = np.array(jax.devices())

from repro.data.pipeline import DataConfig, SyntheticPipeline
mesh = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
batch = SyntheticPipeline(DataConfig(64, %(S)d, %(B)d), mesh).batch(5)
for k, v in batch.items():
    for sh in v.addressable_shards:
        res[f"batch/{k}/{sh.device.id}"] = np.asarray(sh.data)

from repro.optim import compression
pod = Mesh(devs.reshape(8), ("pod",))
def f(ga, gb):
    mean, err = compression.compressed_psum(
        {"a": ga[0], "b": gb[0]},
        {"a": jnp.zeros_like(ga[0]), "b": jnp.zeros_like(gb[0])}, "pod")
    return mean["a"], mean["b"], err["a"][None], err["b"][None]
fn = shard_map(f, mesh=pod, in_specs=(P("pod"), P("pod")),
               out_specs=(P(), P(), P("pod"), P("pod")), check_rep=False)
ma, mb, ea, eb = fn(jnp.asarray(inp["psum_a"]), jnp.asarray(inp["psum_b"]))
res.update({"psum/mean/a": ma, "psum/mean/b": mb, "psum/err/a": ea,
            "psum/err/b": eb})

from repro.runtime import pipeline_apply
stages = Mesh(devs.reshape(8, 1)[:4].reshape(4), ("stage",))
ws = jnp.stack([jnp.full((2,), 1.0 + i) for i in range(4)])
xm = jnp.arange(24, dtype=jnp.float32).reshape(6, 4)
res["pipeline"] = pipeline_apply(
    stages, "stage", lambda w, x: x * w[0] + w[1] * 0.0 + 1.0, ws, xm)

from repro.configs import get_config
from repro.models.moe import moe_block_local
cfg = get_config("granite-moe-1b-a400m", smoke=True)
p = {k[len("moe/"):]: jnp.asarray(v) for k, v in inp.items()
     if k.startswith("moe/")}
dm = Mesh(devs.reshape(2, 4), ("data", "model"))
y, aux = moe_block_local(p, cfg, jnp.asarray(inp["moe_x"]), dm, ("data",))
res["moe_local/y"], res["moe_local/aux"] = y, aux

np.savez(os.path.join(root, "ref_out.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
""" % {"S": TRAIN_S, "B": TRAIN_B}


# -- the fixture: inputs, the world, the references ---------------------------

def _reference_inputs():
    """The numpy inputs both packages take: the reference's smoke params
    (``jax.random``), the gradients to all-reduce, the MoE block's
    params and activations, the SELECT table."""
    import jax
    from repro import configs as jconfigs
    from repro.models import init_params
    from repro.models.moe import moe_params
    params = {}
    for arch in TRAIN_ARCHS + SERVE_ARCHS:
        jcfg = get_config(jconfigs, arch)
        params[arch] = (jcfg, jax.tree_util.tree_map(
            np.asarray, init_params(jax.random.key(3), jcfg)))
    rng = np.random.default_rng(11)
    jmoe = jconfigs.get_config("granite-moe-1b-a400m", smoke=True)
    moe_p = jax.tree_util.tree_map(np.asarray, moe_params(
        jax.random.key(5), jmoe, jax.numpy.float32))
    moe_x = rng.standard_normal((4, 8, jmoe.d_model)).astype(np.float32)
    grads = {"a": (rng.standard_normal((WORLD, 64)) * 0.1).astype(
                 np.float32),
             "b": rng.standard_normal((WORLD, 3, 5)).astype(np.float32)}
    return params, moe_p, moe_x, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank -> the world's results, the reference's 8-device results,
    the numpy inputs)."""
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.nmp.select import make_table
    root = str(tmp_path_factory.mktemp("world"))
    params, moe_p, moe_x, grads = _reference_inputs()
    inputs = {arch: (get_config(tconfigs, arch),
                     convert.model_params_to_torch(p, get_config(
                         tconfigs, arch), "cpu"))
              for arch, (_, p) in params.items()}
    tmoe = tconfigs.get_config("granite-moe-1b-a400m", smoke=True)
    inputs["moe_local"] = (tmoe, {k: torch.from_numpy(v)
                                  for k, v in moe_p.items()},
                           torch.from_numpy(moe_x))
    inputs["psum_grads"] = {k: torch.from_numpy(v) for k, v in grads.items()}
    inputs["table"] = make_table(13, 1024, 8, 0.2, device="cpu")
    rng = np.random.default_rng(17)
    for arch in SERVE_ARCHS:
        vocab = inputs[arch][0].vocab
        for B in SERVE_BATCHES:
            inputs[f"serve_tokens/{arch}/{B}"] = [
                torch.from_numpy(rng.integers(0, vocab, (B,)).astype(
                    np.int32)) for _ in range(SERVE_STEPS)]
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    np.savez(os.path.join(root, "ref_inputs.npz"), psum_a=grads["a"],
             psum_b=grads["b"], moe_x=moe_x,
             **{f"moe/{k}": v for k, v in moe_p.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    # each process writes to a file of its own: a full pipe would block a
    # rank inside a collective and stall the world.
    logs = [open(os.path.join(root, f"log_{r}.txt"), "w")
            for r in range(WORLD + 1)]
    procs = [subprocess.Popen([sys.executable, "-c", REF_SCRIPT, root],
                              env=env, stdout=logs[0], stderr=logs[0])]
    procs += [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(f"""
            import sys
            sys.path.insert(0, {here!r})
            from test_torch_distributed import _worker
            _worker({r}, {root!r})
        """)], env=env, stdout=logs[r + 1], stderr=logs[r + 1])
        for r in range(WORLD)]
    try:
        refs = _unsharded_references(params, inputs)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            p.kill()
        for f in logs:
            f.close()
    for i, p in enumerate(procs):
        with open(os.path.join(root, f"log_{i}.txt")) as f:
            assert p.returncode == 0, \
                f"{'the reference' if i == 0 else f'rank {i - 1}'}: " \
                f"{f.read()[-4000:]}"
    outs = [torch.load(os.path.join(root, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    ref8 = dict(np.load(os.path.join(root, "ref_out.npz")))
    return outs, ref8, refs, params, root


def _unsharded_references(params, inputs):
    """``repro``'s unsharded ``train_step`` (3 steps on the global
    batches) and ``decode_step`` on the same numpy inputs."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import DataConfig, SyntheticPipeline
    from repro.models import decode_step, init_decode_state
    from repro.optim import adamw
    from repro.train.train_step import init_state, train_step
    out = {}
    for arch in TRAIN_ARCHS:
        jcfg, p = params[arch]
        pipe = SyntheticPipeline(DataConfig(jcfg.vocab, TRAIN_S, TRAIN_B))
        for k in (1, 2) if arch in TRAIN_MICRO else (1,):
            fn = jax.jit(functools.partial(
                train_step, jcfg, adamw.OptimConfig(**OPTIM), k))
            state = init_state(jax.tree_util.tree_map(jnp.asarray, p))
            rec = {"loss": [], "grad_norm": []}
            for i in range(TRAIN_STEPS):
                batch = dict(pipe.batch(i))
                if jcfg.encoder is not None:
                    batch["frames"] = _frames(jcfg, i)
                state, m = fn(state, {kk: jnp.asarray(v)
                                      for kk, v in batch.items()})
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                if i == 0:
                    rec["m1"] = jax.tree_util.tree_map(np.asarray,
                                                       state.opt.m)
            rec["state"] = jax.tree_util.tree_map(np.asarray, state)
            out[f"train/{arch}/{k}"] = rec
    step = jax.jit(decode_step, static_argnums=(1,))
    for arch in SERVE_ARCHS:
        jcfg, p = params[arch]
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        for B in SERVE_BATCHES:
            state = init_decode_state(jcfg, B, SERVE_SEQ)
            logits = []
            for i, tok in enumerate(inputs[f"serve_tokens/{arch}/{B}"]):
                lg, state = step(jp, jcfg, jnp.asarray(tok.numpy()),
                                 jnp.asarray(i, jnp.int32), state)
                logits.append(np.asarray(lg))
            out[f"serve/{arch}/{B}"] = np.stack(logits)
    return out


# -- the checks ---------------------------------------------------------------

def _flat(tree):
    import jax
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, atol=ATOL, rtol=RTOL):
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("arch,mesh,mode,k", TRAIN_CASES)
def test_make_train_step_equals_unsharded_reference(world, arch, mesh, mode,
                                                    k):
    from repro_torch import convert
    outs, _, refs, params, _ = world
    key = f"train/{arch}/{mesh}/{mode}/{k}"
    got, want = outs[0][key], refs[f"train/{arch}/{k}"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               atol=LOSS_TOL, rtol=1e-5)
    from repro_torch import configs as tconfigs
    tcfg = get_config(tconfigs, arch)
    m1 = convert.model_params_to_numpy(got["m1"], tcfg)
    _close(m1, want["m1"])                          # 0.1 x the gradients
    st = convert.train_state_to_numpy(got["state"], tcfg)
    _close(st.params, want["state"].params)
    _close(st.opt.m, want["state"].opt.m)
    _close(st.opt.v, want["state"].opt.v, atol=1e-8)
    assert int(st.data_step) == int(want["state"].data_step) == TRAIN_STEPS
    # every rank ends with the same state.
    for r in range(1, WORLD):
        other = outs[r][key]
        assert other["loss"] == got["loss"]
        for a, b in zip(_leaves(other["state"]), _leaves(got["state"])):
            assert torch.equal(a, b)


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def test_trainer_checkpoint_resumes_on_another_mesh(world):
    import jax
    from repro.checkpoint import checkpoint as jck
    from repro.train.train_step import init_state as j_init_state
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    outs, _, _, params, root = world
    ck = outs[0]["ckpt"]
    trained, resumed = ck["trained"], ck["resumed"]
    for a, b in zip(_leaves(trained), _leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ck["meta"]["step"] == 4
    # the (4, 2) mesh's layout: wq [d, H*hd] over ("data", "model").
    assert ck["wq_placements"] == ["S(0)", "S(1)"]
    tcfg = tconfigs.get_config("smollm-360m", smoke=True)
    jcfg, p = params["smollm-360m"]
    like = j_init_state(jax.tree_util.tree_map(np.asarray, p))
    back, meta = jck.load(os.path.join(root, "ck", "step_4.ckpt"), like)
    want = convert.train_state_to_numpy(trained, tcfg)
    a, b = _flat(back), _flat(want)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert meta["step"] == 4


def test_pipeline_rows_are_the_reference_shards(world):
    outs, ref8, _, _, _ = world
    for r in range(WORLD):
        for k in ("tokens", "targets"):
            got = outs[r]["batch"][k].numpy()
            np.testing.assert_array_equal(got, ref8[f"batch/{k}/{r}"])
            assert got.shape == (TRAIN_B // 4, TRAIN_S)


def test_compressed_psum_equals_reference(world):
    outs, ref8, _, _, _ = world
    for r in range(WORLD):
        got = outs[r]["psum"]
        for k in ("a", "b"):
            np.testing.assert_allclose(got["mean"][k].numpy(),
                                       ref8[f"psum/mean/{k}"], atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(got["err"][k].numpy(),
                                       ref8[f"psum/err/{k}"][r], atol=1e-6,
                                       rtol=0)


def test_pipeline_apply_four_stages(world):
    outs, ref8, _, _, _ = world
    xm = np.arange(24, dtype=np.float32).reshape(6, 4)
    serial = xm
    for i in range(4):
        serial = serial * (1.0 + i) + 1.0
    for r in range(WORLD):
        got = outs[r]["pipeline"].numpy()
        assert np.abs(got - serial).max() == 0.0
        np.testing.assert_array_equal(got, ref8["pipeline"])


def test_moe_block_local_equals_reference(world):
    outs, ref8, _, _, _ = world
    for r in range(WORLD):
        got = outs[r]["moe_local"]
        np.testing.assert_allclose(got["y"].numpy(), ref8["moe_local/y"],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(float(got["aux"]),
                                   float(ref8["moe_local/aux"]), atol=1e-7,
                                   rtol=1e-5)


def test_filtered_batch_equals_pushdown_select(world):
    from repro_torch.core.pushdown import pushdown_select
    from repro_torch.nmp.select import make_table
    outs, _, _, _, _ = world
    table = make_table(13, 1024, 8, 0.2, device="cpu")
    want = pushdown_select(["cpu"] * 4, 64, table, 0.0, 1.0)
    for r in range(WORLD):
        got = outs[r]["filtered"]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(want.moved_rows) > 0


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
@pytest.mark.parametrize("B", SERVE_BATCHES)
def test_make_serve_step_equals_reference_decode(world, arch, mesh, B):
    outs, _, refs, _, _ = world
    key = f"serve/{arch}/{mesh}/{B}"
    got = outs[0][key]
    np.testing.assert_allclose(got["logits"].numpy(),
                               refs[f"serve/{arch}/{B}"], atol=2e-5,
                               rtol=2e-5)
    shape, axes = MESHES[mesh]
    n_dp = shape[0] * (shape[1] if len(shape) == 3 else 1)
    dp = ["S(0)"] * (len(shape) - 1) if B % n_dp == 0 else \
        ["R"] * (len(shape) - 1)
    assert got["placements"] == dp + ["R"]
    # the cache: kv heads over model where they divide, else the sequence.
    from repro_torch import configs as tconfigs
    kv = get_config(tconfigs, arch).n_kv_heads
    assert got["cache"] == dp + ["S(1)" if kv % shape[-1] == 0 else "S(2)"]
    for r in range(1, WORLD):
        assert torch.equal(outs[r][key]["logits"], got["logits"])
