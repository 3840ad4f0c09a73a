"""The port's training path against ``repro`` on the CPU.

The reference's parameters (``repro.models.init_params``) cross to the
port through numpy (``convert.model_params_to_torch``), and the same
numpy tokens, targets and frames feed both packages.  Held here, in fp32
on the smoke configs:

* ``loss_fn``'s loss (1e-5) and every gradient leaf against
  ``jax.value_and_grad(repro.models.loss_fn)`` for all ten archs; the
  gradients at ``GRAD_ATOL``/``GRAD_RTOL`` (measured worst 1.9e-6 abs,
  on recurrentgemma's embedding), compared in the reference's stacked
  layout (``convert.model_params_to_numpy``);
* the chunked head (``_chunk_nll``) in both of its branches;
* remat (``"full"`` and ``"dots"``) against none: the same gradients;
* ``train_step`` with one and two micro-batches against the reference's;
* ``schedule``, one AdamW ``update`` (``step`` exact), ``compress_tree``
  with error feedback, and ``SyntheticPipeline`` bit for bit;
* the int8 MoE wire's gradients against the reference's custom VJP;
* ``Trainer``: bitwise resume, straggler detection, loss decreasing, as
  ``tests/test_substrates.py`` holds the reference's.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models.transformer import _chunk_nll as j_chunk_nll  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.train.train_step import init_state as j_init_state  # noqa: E402
from repro.train.train_step import train_step as j_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.train_step import (_split_micro,  # noqa: E402
                                          _value_and_grad, init_state,
                                          make_train_step, train_step)
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["smollm-360m", "gemma2-9b", "granite-34b", "nemotron-4-340b",
         "chameleon-34b", "recurrentgemma-9b", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "rwkv6-3b", "whisper-small"]
B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """path -> fp32 numpy, the reference's pytree paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = np.asarray(leaf, np.float32)
    return out


def _assert_trees_close(got_np, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    a, b = _flat(got_np), _flat(want)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _setup(arch, batch=B, seq=S, seed=7):
    """(reference config, port config, reference params, port params,
    numpy batch) for one smoke config."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = j_init_params(jax.random.key(seed), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    rng = np.random.default_rng(seed)
    mb = {"tokens": rng.integers(0, jcfg.vocab, (batch, seq)).astype(
              np.int32),
          "targets": rng.integers(0, jcfg.vocab, (batch, seq)).astype(
              np.int32)}
    if jcfg.encoder is not None:
        mb["frames"] = rng.standard_normal(
            (batch, jcfg.encoder.n_frames, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, mb


def _j(mb):
    return {k: jnp.asarray(v) for k, v in mb.items()}


def _t(mb):
    return {k: torch.from_numpy(np.array(v)) for k, v in mb.items()}


def _j_value_and_grad(jcfg, jp, mb):
    def f(p):
        return j_loss_fn(p, jcfg, mb["tokens"], mb["targets"],
                         frames=mb.get("frames"))
    return jax.value_and_grad(f, has_aux=True)(jp)


# -- loss and gradients --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch):
    jcfg, tcfg, jp, tp, mb = _setup(arch)
    (jl, jm), jg = _j_value_and_grad(jcfg, jp, _j(mb))
    tl, tm, tg = _value_and_grad(tcfg, tp, _t(mb))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for k in ("nll", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL
    assert tl.dtype == torch.float32 and tl.dim() == 0
    for g, p in zip(leaves(tg), leaves(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert not g.requires_grad
    for p in leaves(tp):
        assert not p.requires_grad and p.grad is None
    _assert_trees_close(convert.model_params_to_numpy(tg, tcfg), _np(jg))


@pytest.mark.parametrize("seq,chunk", [(16, 4), (12, 8), (10, 10)],
                         ids=["chunked", "one_pass", "one_chunk"])
def test_chunk_nll_equals_reference(seq, chunk):
    """Both branches of the chunked head, value and gradient in x and in
    the embedding, on gemma2's head (a logit softcap) with the vocab cut
    to 250 so that 6 pad columns (-1e30) meet the one-hot product."""
    jcfg = dataclasses.replace(jconfigs.get_config("gemma2-9b", smoke=True),
                               vocab=250)
    tcfg = dataclasses.replace(tconfigs.get_config("gemma2-9b", smoke=True),
                               vocab=250)
    assert tcfg.padded_vocab == 256
    jp = j_init_params(jax.random.key(3), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, seq, jcfg.d_model)).astype(np.float32)
    tg = rng.integers(0, jcfg.vocab, (B, seq)).astype(np.int32)
    jv, (jgx, jge) = jax.value_and_grad(
        lambda xx, e: j_chunk_nll(e, jcfg, xx, jnp.asarray(tg), chunk),
        argnums=(0, 1))(jnp.asarray(x), jp["embed"])
    tx = torch.as_tensor(x).requires_grad_(True)
    tok = tp["embed"]["tok"].clone().requires_grad_(True)
    tv = T._chunk_nll(dict(tp["embed"], tok=tok), tcfg, tx,
                      torch.as_tensor(tg), chunk)
    tv.backward()
    assert torch.isfinite(tv)
    assert bool(torch.isfinite(tok.grad).all())
    assert not bool(tok.grad[tcfg.vocab:].any())
    assert abs(float(tv) - float(jv)) <= LOSS_TOL
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(tok.grad.numpy(), np.asarray(jge["tok"]),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m", "whisper-small"])
def test_remat_gives_the_same_gradients(arch, policy):
    """Recomputing each superlayer in the backward pass changes no
    gradient: remat against none, on the same parameters and batch."""
    _, tcfg, _, tp, mb = _setup(arch)
    rcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    l0, _, g0 = _value_and_grad(tcfg, tp, _t(mb))
    l1, _, g1 = _value_and_grad(rcfg, tp, _t(mb))
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b"])
def test_remat_over_query_blocks_equals_reference(arch, policy):
    """Remat of each superlayer around ``chunked_attention``'s own remat of
    each query block: at S=1024 attention runs two query blocks (and
    recurrentgemma's scan 16 chunks); the loss and every gradient leaf
    against the reference's with the same remat policy."""
    jcfg, tcfg, jp, tp, mb = _setup(arch, batch=1, seq=1024)
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    (jl, _), jg = _j_value_and_grad(jcfg, jp, _j(mb))
    tl, _, tg = _value_and_grad(tcfg, tp, _t(mb))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    _assert_trees_close(convert.model_params_to_numpy(tg, tcfg), _np(jg))


def test_remat_unknown_policy_raises():
    _, tcfg, _, tp, mb = _setup("smollm-360m")
    bad = dataclasses.replace(tcfg, remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        _value_and_grad(bad, tp, _t(mb))


def test_forward_unchanged_by_use_kernel_on_cpu():
    """On the CPU ``use_kernel`` only moves the routing between two plain
    versions: the hidden states agree at the model tests' 2e-4."""
    _, tcfg, _, tp, mb = _setup("recurrentgemma-9b")
    a, _ = T.forward_body(tp, tcfg, _t(mb)["tokens"])
    b, _ = T.forward_hidden(tp, tcfg, _t(mb)["tokens"])
    torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


# -- the train step ------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_train_step_equals_reference(arch, micro):
    """One step from the same state: loss, lr, grad norm, the moments
    and the parameters.  AdamW's first step moves a parameter by about
    ``lr * g / (|g| + eps)``, which turns a 1e-9 difference in a gradient
    near 0 into an O(lr) move; ``eps=1e-4`` keeps that map smooth, so
    the parameters compare at 1e-6 (the gradients themselves are held at
    ``GRAD_ATOL`` above, and here through ``m = 0.1 g``)."""
    jcfg, tcfg, jp, tp, mb = _setup(arch, batch=4)
    ocfg_j = jadamw.OptimConfig(peak_lr=1e-3, warmup_steps=2,
                                total_steps=10, eps=1e-4)
    ocfg_t = adamw.OptimConfig(**dataclasses.asdict(ocfg_j))
    js, jm = j_train_step(jcfg, ocfg_j, micro, j_init_state(jp),
                            _j(mb))
    ts, tm = train_step(tcfg, ocfg_t, micro, init_state(tp),
                            _t(mb))
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=LOSS_TOL, err_msg=k)
    assert int(ts.opt.step) == int(js.opt.step) == 1
    assert int(ts.data_step) == int(js.data_step) == 1
    assert ts.data_step.dtype == torch.int32
    got = convert.train_state_to_numpy(ts, tcfg)
    _assert_trees_close(got.params, _np(js.params), atol=1e-6, rtol=1e-5)
    _assert_trees_close(got.opt.m, _np(js.opt.m), atol=1e-7, rtol=1e-4)
    _assert_trees_close(got.opt.v, _np(js.opt.v), atol=1e-10, rtol=1e-4)


def test_split_micro_is_in_order():
    batch = {"tokens": torch.arange(24).reshape(6, 4)}
    mbs = _split_micro(batch, 3)
    assert [m["tokens"][:, 0].tolist() for m in mbs] == \
        [[0, 4], [8, 12], [16, 20]]


def test_micro_grads_accumulate_in_fp32():
    """Two micro-batches of a bf16 model: the accumulated gradient is the
    fp32 mean (the moments see fp32), the parameters stay bf16."""
    _, tcfg, _, tp, mb = _setup("smollm-360m", batch=4)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    bp = T.init_params(bcfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    st = init_state(bp)
    new, m = train_step(bcfg, adamw.OptimConfig(), 2, st, _t(mb))
    assert all(p.dtype == q.dtype for p, q in zip(leaves(new.params),
                                                  leaves(bp)))
    assert all(x.dtype == torch.float32 for x in leaves(new.opt.m))
    assert torch.isfinite(m["loss"])


@pytest.fixture
def mesh1():
    """A (1, 1, 1) mesh of one CPU rank (a world of one, ended
    afterwards)."""
    from repro_torch.launch.mesh import close, make_local_mesh
    yield make_local_mesh(("pod", "data", "model"), device="cpu")
    close()


@pytest.mark.parametrize("mode,micro", [("2d", 1), ("fsdp", 2)])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_make_train_step_on_one_rank_equals_train_step(arch, mode, micro,
                                                       mesh1):
    """On a mesh of one rank every collective is a copy: two steps of
    ``make_train_step`` equal ``train_step``'s bit for bit (loss, lr,
    grad norm, every leaf), the state's leaves DTensors."""
    from torch.distributed.tensor import DTensor
    _, tcfg, _, tp, mb = _setup(arch, batch=4)
    ocfg = adamw.OptimConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(tcfg, ocfg, mesh1, tp, micro, sharding_mode=mode)
    a, b = init_state(tp), init_state(tp)
    for _ in range(2):
        a, ma = train_step(tcfg, ocfg, micro, a, _t(mb))
        b, mb_ = step(b, _t(mb))
        for k in ("loss", "lr", "grad_norm"):
            assert torch.equal(ma[k], mb_[k]), k
    assert all(isinstance(x, DTensor) for x in leaves(b))
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y.full_tensor())


def test_compressed_psum_on_one_rank(mesh1):
    """Over an axis of one rank the mean is this rank's dequantized
    gradient and the residual ``compress_tree``'s, with the axis named on
    the mesh or given as its process group."""
    rng = np.random.default_rng(9)
    g = {"a": torch.from_numpy(rng.standard_normal((3, 7)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32))}
    err = compression.init_error(g)
    q, sc, want_err = compression.compress_tree(g, err)
    for where in (mesh1, mesh1.get_group("pod")):
        mean, new_err = compression.compressed_psum(g, err, "pod", where)
        for k in g:
            assert torch.equal(mean[k], compression.dequantize(q[k], sc[k]))
            assert torch.equal(new_err[k], want_err[k])


def test_pipeline_and_trainer_on_one_rank(mesh1, tmp_path):
    """``SyntheticPipeline(mesh=...)`` gives DTensors whose blocks are the
    whole batch; ``Trainer(mesh=...)`` on one rank ends where the
    unsharded ``Trainer`` does, bit for bit, and its checkpoint loads in
    ``repro`` bit for bit."""
    from repro.checkpoint import checkpoint as jck
    from torch.distributed.tensor import DTensor
    cfg = tconfigs.get_config("smollm-360m", smoke=True)
    dcfg = DataConfig(cfg.vocab, 8, 4)
    got = SyntheticPipeline(dcfg, mesh1).batch(3)
    want = SyntheticPipeline(dcfg, device="cpu").batch(3)
    for k in want:
        assert isinstance(got[k], DTensor)
        assert torch.equal(got[k].to_local(), want[k])
    runs = []
    for name, mesh in (("plain", None), ("mesh", mesh1)):
        params = T.init_params(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        tr = Trainer(cfg, adamw.OptimConfig(peak_lr=1e-3, warmup_steps=2,
                                            total_steps=10),
                     TrainerConfig(steps=4, ckpt_every=2,
                                   ckpt_dir=str(tmp_path / name)),
                     mesh, params, dcfg, device="cpu")
        tr.run()
        runs.append(tr)
    for x, y in zip(leaves(runs[0].state), leaves(runs[1].state)):
        assert torch.equal(x, y.full_tensor())
    like = convert.train_state_to_numpy(runs[0].state, cfg)
    back, meta = jck.load(str(tmp_path / "mesh" / "step_4.ckpt"),
                          j_init_state(like.params))
    assert meta["step"] == 4
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(like)):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


# -- optimizer -----------------------------------------------------------------

def test_schedule_equals_reference():
    """At the points of ``tests/test_substrates.py::test_schedule_shape``
    and past the end."""
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    jc, tc = jadamw.OptimConfig(**kw), adamw.OptimConfig(**kw)
    for s in range(120):
        want = float(jadamw.schedule(jc, jnp.asarray(s)))
        got = adamw.schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, s
    lrs = [float(adamw.schedule(tc, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert abs(lrs[10] - 1.0) < 0.01
    assert 0.1 - 1e-6 <= lrs[-1] < 0.2


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_adamw_update_equals_reference(arch):
    """One update on the same (clipped) gradients, from a state with
    non-zero moments; ``step`` exact, the decay mask by key (rwkv's
    mixes and bonus, the RG-LRU's Lambda, the norms)."""
    jcfg, tcfg, jp, tp, _ = _setup(arch)
    rng = np.random.default_rng(11)
    jg = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3,
                              p.dtype), jp)
    jm = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.01,
                              jnp.float32), jp)
    jv = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.random(p.shape) * 0.01, jnp.float32), jp)
    jst = jadamw.OptState(jnp.asarray(4, jnp.int32), jm, jv)
    kw = dict(peak_lr=0.01, warmup_steps=3, total_steps=20,
              weight_decay=0.1, clip_norm=1.0)
    jp2, jst2, jo = jadamw.update(jadamw.OptimConfig(**kw), jst, jp, jg)
    tst = adamw.OptState(torch.tensor(4, dtype=torch.int32),
                         convert.model_params_to_torch(_np(jm), tcfg, "cpu"),
                         convert.model_params_to_torch(_np(jv), tcfg, "cpu"))
    tg = convert.model_params_to_torch(_np(jg), tcfg, "cpu")
    tp2, tst2, to = adamw.update(adamw.OptimConfig(**kw), tst, tp, tg)
    assert int(tst2.step) == int(jst2.step) == 5
    assert tst2.step.dtype == torch.int32
    assert float(to["lr"]) == pytest.approx(float(jo["lr"]), rel=1e-6)
    assert float(to["grad_norm"]) == pytest.approx(float(jo["grad_norm"]),
                                                   rel=1e-5)
    _assert_trees_close(convert.model_params_to_numpy(tp2, tcfg),
                        _np(jp2), atol=1e-6, rtol=1e-5)
    _assert_trees_close(convert.model_params_to_numpy(tst2.m, tcfg),
                        _np(jst2.m), atol=1e-7, rtol=1e-5)
    _assert_trees_close(convert.model_params_to_numpy(tst2.v, tcfg),
                        _np(jst2.v), atol=1e-9, rtol=1e-5)


@pytest.mark.parametrize("name", ["ln", "final_ln", "cm_ln", "mix_r",
                                  "lam", "u", "wlog", "q_norm", "k_norm",
                                  "cm_mix", "wq", "w1", "tok", "router",
                                  "w_out", "conv_w"])
def test_decayable_equals_reference(name):
    class K:
        def __init__(self, key):
            self.key = key
    assert adamw._decayable(("layers", 0, "mixer", name)) == \
        jadamw._decayable((K("layers"), K("mixer"), K(name)))


def test_adamw_converges_quadratic():
    ocfg = adamw.OptimConfig(peak_lr=0.1, warmup_steps=5, total_steps=300,
                             weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adamw.init(params)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - 1.0)}
        params, st, _ = adamw.update(ocfg, st, params, g)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)


# -- gradient compression --------------------------------------------------------

def test_compress_tree_error_feedback_equals_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((64,)).astype(np.float32) * 0.1,
         "b": {"c": rng.standard_normal((8, 4)).astype(np.float32)}}
    jerr = jcomp.init_error(jax.tree_util.tree_map(jnp.asarray, g))
    terr = compression.init_error(jax.tree_util.tree_map(torch.as_tensor,
                                                         g))
    for _ in range(5):
        jq, js, jerr = jcomp.compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tq, ts, terr = compression.compress_tree(
            jax.tree_util.tree_map(torch.as_tensor, g), terr)
        for k in ("a", "b"):
            pick = (lambda t: t[k]) if k == "a" else (lambda t: t["b"]["c"])
            assert pick(tq).dtype == torch.int8
            np.testing.assert_array_equal(pick(tq).numpy(),
                                          np.asarray(pick(jq)))
            assert float(pick(ts)) == float(pick(js))
            np.testing.assert_allclose(pick(terr).numpy(),
                                       np.asarray(pick(jerr)), atol=1e-7)
    assert compression.compression_ratio(g) == jcomp.compression_ratio(g)


def test_quantize_roundtrip_small_error():
    x = torch.tensor([0.5, -1.0, 0.25, 0.0])
    q, s = compression.quantize(x)
    back = compression.dequantize(q, s)
    assert float((back - x).abs().max()) <= float(s) / 2 + 1e-9


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [(1000, 16, 4, 0), (49152, 33, 3, 5)])
def test_pipeline_equals_reference(cfg):
    jp, tp = JPipeline(JDataConfig(*cfg)), SyntheticPipeline(
        DataConfig(*cfg), device="cpu")
    for step in (0, 1, 2, 7, 1000):
        want, got = jp.batch(step), tp.batch(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            assert got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# -- the int8 MoE wire -----------------------------------------------------------

def _int8(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_int8=True))


def test_moe_int8_grads_equal_reference_custom_vjp():
    """The case of ``tests/test_perf_opts.py::
    test_moe_dispatch_int8_quality_and_grads``: the wire's gradients are
    the reference's straight-through VJP, not autograd through the
    rounding (whose only path is the scale)."""
    jcfg = jconfigs.get_config("granite-moe-1b-a400m", smoke=True)
    tcfg = tconfigs.get_config("granite-moe-1b-a400m", smoke=True)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    toks = jax.random.randint(jax.random.key(1), (2, 16), 0, jcfg.vocab)
    mb = {"tokens": np.asarray(toks, np.int32),
          "targets": np.asarray(jnp.roll(toks, -1, 1), np.int32)}
    (jl, _), jg = _j_value_and_grad(_int8(jcfg), jp, _j(mb))
    tl, _, tg = _value_and_grad(_int8(tcfg), tp, _t(mb))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    got = convert.model_params_to_numpy(tg, tcfg)
    _assert_trees_close(got, _np(jg))
    assert float(np.abs(got["layers"]["slot0"]["ffn"]["w1"]).sum()) > 0
    # rounding alone would send the experts' gradient only through the
    # scales: the straight-through wire differs from that.
    _, _, plain = _value_and_grad(tcfg, tp, _t(mb))
    assert not torch.equal(tg["layers"][0]["ffn"]["w1"],
                           plain["layers"][0]["ffn"]["w1"])


def test_dispatch_q8_backward_is_the_reference_vjp():
    """``_DispatchQ8``/``_CombineQ8`` alone: forward as the port's int8
    wire, backward the gather and the kept-slot scatter."""
    from repro_torch.models import moe as tmoe
    rng = np.random.default_rng(4)
    E, cap, d, n = 4, 3, 8, 14
    flat_e = torch.as_tensor(rng.integers(0, E, n))
    pos, keep, safe = tmoe.dispatch_positions(flat_e, E, cap)
    src = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)
                          ).requires_grad_(True)
    buf = tmoe._dispatch_q8(src, flat_e, pos, keep, E, cap)
    torch.testing.assert_close(
        buf, tmoe._dispatch_q8_fwd(src.detach(), flat_e, pos, keep, E, cap),
        atol=0, rtol=0)
    g = torch.as_tensor(rng.standard_normal((E, cap, d)).astype(np.float32))
    (gs,) = torch.autograd.grad(buf, src, g)
    want = torch.where(keep[:, None], g[flat_e, safe], 0)
    assert torch.equal(gs, want)
    ob = torch.as_tensor(rng.standard_normal((E, cap, d)).astype(np.float32)
                         ).requires_grad_(True)
    out = tmoe._combine_q8(ob, flat_e, safe, keep)
    gy = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    (gb,) = torch.autograd.grad(out, ob, gy)
    want = torch.zeros((E, cap, d))
    want[flat_e[keep], safe[keep]] = gy[keep]
    assert torch.equal(gb, want)
    assert (~keep).any(), "the case must drop a slot"


# -- the trainer -----------------------------------------------------------------

def _tiny_trainer(ckdir, steps=10, lr=1e-3, seq=16, batch=4, **kw):
    tcfg = tconfigs.get_config("smollm-360m", smoke=True)
    params = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ocfg = adamw.OptimConfig(peak_lr=lr, warmup_steps=max(2, steps // 15),
                             total_steps=steps)
    dcfg = DataConfig(vocab=tcfg.vocab, seq_len=seq, global_batch=batch)
    return Trainer(tcfg, ocfg, TrainerConfig(steps=steps, ckpt_every=4,
                                             ckpt_dir=ckdir, **kw),
                   None, params, dcfg, device="cpu")


def test_failure_resume_bitwise(tmp_path):
    ckdir = str(tmp_path / "ck")
    t1 = _tiny_trainer(ckdir)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        t1.run(fail_at=6)
    t1.saver.wait()
    t2 = _tiny_trainer(ckdir)
    t2.run()
    assert t2.metrics_log[0]["step"] == 4
    shutil.rmtree(ckdir)
    t3 = _tiny_trainer(ckdir)
    t3.run()
    assert len(t3.metrics_log) == 10
    for a, b in zip(leaves(t2.state), leaves(t3.state)):
        assert torch.equal(a, b)


def test_keep_gc_and_latest_valid(tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    import os
    ckdir = str(tmp_path / "gc")
    t = _tiny_trainer(ckdir, steps=13, keep=2)
    t.run()
    # the last save's collection may run before its file lands, as in
    # the reference: the next one removes the surplus.
    assert "step_12.ckpt" in os.listdir(ckdir)
    assert "step_4.ckpt" not in os.listdir(ckdir) or \
        len(os.listdir(ckdir)) == 3
    t._gc(12)
    assert sorted(os.listdir(ckdir)) == ["step_12.ckpt", "step_8.ckpt"]
    assert ckpt.latest_valid(ckdir).endswith("step_12.ckpt")


def test_straggler_detection(tmp_path):
    t = _tiny_trainer(str(tmp_path / "ck2"), steps=10)
    res = t.run(delay_at=8)
    assert any(e["step"] == 8 for e in res["stragglers"]), res["stragglers"]


def test_loss_decreases(tmp_path):
    t = _tiny_trainer(str(tmp_path / "ck3"), steps=80, lr=5e-3, seq=32,
                      batch=8)
    t.run()
    first = np.mean([m["loss"] for m in t.metrics_log[:5]])
    last = np.mean([m["loss"] for m in t.metrics_log[-5:]])
    assert last < first - 0.5, (first, last)


@pytest.mark.parametrize("mode", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b", "rwkv6-3b",
                                  "whisper-small"])
def test_make_train_step_on_one_rank_equals_train_step(arch, mode):
    """``make_train_step`` on a mesh of one CPU rank: the tensor-parallel
    model code on a group of one runs the unsharded code, and every
    collective is a copy, so two steps equal ``train_step``'s bit for
    bit (loss, lr, grad norm and every leaf), as phase 13 of
    ``chip_smoke.py`` holds them on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import close, make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, make_train_step, train_step
    from repro_torch.tree import leaves
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(2):
        b = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "targets")}
        if cfg.encoder is not None:
            b["frames"] = torch.randn((4, cfg.encoder.n_frames, cfg.d_model),
                                      generator=g)
        batches.append(b)
    ocfg = OptimConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    axes = ("data", "model") if mode == "2d" else ("pod", "data", "model")
    mesh = make_local_mesh(axes, device="cpu")
    try:
        step = make_train_step(cfg, ocfg, mesh, params, 1,
                               sharding_mode=mode)
        want, got = init_state(params), init_state(params)
        for b in batches:
            want, wm = train_step(cfg, ocfg, 1, want, b)
            got, gm = step(got, b)
            for k in wm:
                assert torch.equal(wm[k], gm[k]), k
        for a, b in zip(leaves(want), leaves(got)):
            assert torch.equal(a, sh.local(b))
    finally:
        close()
