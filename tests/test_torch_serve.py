"""The port's serving substrate against ``repro.serve``, on the CPU.

``serve/quantize.py`` bit for bit (``q`` and ``s`` of every leaf; both
packages round half to even) on six smoke configs, MoE, RWKV6 and
whisper's encoder and cross-attention among them, the quantized ``mm``
at 2e-4 in fp32, ``ServeEngine.generate``'s tokens equal to the
reference's on four smoke configs, plain and int8 (the reference's
``jax.random`` parameters carried across by
``convert.model_params_to_torch``; granite-moe's int8 experts against the
reference with the scale of ``qeinsum`` over the capacity axis, since
the reference's own raises), and the
``CoherentPrefixTier``'s lookups and protocol traffic equal to the
reference's at one reader and three.  The port's decode writes its state
in place: a pooled state must survive any number of decodes.
"""
import contextlib
import functools
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import CoherentPrefixTier as JTier  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro.serve import quantize as jq  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import coherent_kv_serving  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.serve import (CoherentPrefixTier, ServeEngine,  # noqa: E402
                               decode_state_specs, make_serve_step,
                               quantize_params)
from repro_torch.serve import quantize as tq  # noqa: E402

ARCHS = ["smollm-360m", "recurrentgemma-9b", "granite-moe-1b-a400m",
         "rwkv6-3b"]
#: ``quantize_params``'s configs: the served ones and two more families.
QUANT_ARCHS = ARCHS + ["qwen3-moe-235b-a22b", "whisper-small"]
B, PROMPT, NEW, MAX_SEQ = 2, 8, 6, 24


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    """{path: tensor} over the port's nested dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}[{i}]"))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = j_init_params(jax.random.key(5), jcfg)
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, prompts


@pytest.mark.parametrize("shape", [(64, 32), (3, 16, 8), (8, 1), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_exact(shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    w = rng.standard_normal(shape).astype(np.float32) * 3.0
    w[..., 0] = 0.0                       # an all-zero column: the floor
    jw = jnp.asarray(w, dtype)
    tw = torch.as_tensor(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want, got = jq.quantize_weight(jw), tq.quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy().view(np.int32),
                                  np.asarray(want["s"]).view(np.int32))
    assert tq.is_quantized(got) and not tq.is_quantized({"q": 1})


@pytest.mark.parametrize("min_size", [64, 1 << 12, 1 << 13])
@pytest.mark.parametrize("arch", QUANT_ARCHS)
def test_quantize_params_equal_reference(arch, min_size):
    """The same leaves quantized, to the same bits, whether the reference
    decides on its stacked leaves and the port on its per-layer ones (at
    ``1 << 13`` a smoke ``[64, 64]`` weight is quantized only where it is
    stacked twice: superlayer slots, encoder layers, cross blocks)."""
    jcfg, tcfg, jp, _ = _model(arch)
    want = convert.model_params_to_torch(
        _np(jq.quantize_params(jp, min_size=min_size)), tcfg, "cpu")
    got = quantize_params(convert.model_params_to_torch(_np(jp), tcfg, "cpu"),
                          min_size=min_size, cfg=tcfg)
    lw, lg = _leaves(want), _leaves(got)
    assert lw.keys() == lg.keys()
    assert any(k.endswith(".q") for k in lg)
    for k in lw:
        assert lg[k].dtype == lw[k].dtype, k
        assert torch.equal(lg[k], lw[k]), k


def test_quantize_params_leaves_the_rest_alone():
    _, tcfg, jp, _ = _model("recurrentgemma-9b")
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    qp = quantize_params(tp, min_size=64, cfg=tcfg)
    assert qp["embed"]["tok"] is tp["embed"]["tok"]
    assert qp["layers"][0]["mixer"]["lam"] is tp["layers"][0]["mixer"]["lam"]
    assert tq.is_quantized(qp["layers"][0]["mixer"]["w_a"])
    assert not tq.is_quantized(tp["layers"][0]["mixer"]["w_a"])


def test_quantized_mm_equals_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = {k: torch.as_tensor(np.array(v)) for k, v in jw.items()}
    np.testing.assert_allclose(tL.mm(torch.as_tensor(x), tw).numpy(),
                               np.asarray(jL.mm(jnp.asarray(x), jw)),
                               atol=2e-4, rtol=2e-4)


def _expanded_qeinsum(spec, x, w):
    """The reference's ``qeinsum`` with the scale over the capacity axis
    (``s[..., None, :]``), as the port's: the reference's own multiplies
    ``[E, C, f]`` by ``[E, f]`` and raises."""
    if isinstance(w, dict):
        return jnp.einsum(spec, x, w["q"].astype(x.dtype)) * \
            w["s"].astype(x.dtype)[..., None, :]
    return jnp.einsum(spec, x, w)


@functools.lru_cache(maxsize=None)
def _generated(arch, quantized):
    jcfg, tcfg, jp, prompts = _model(arch)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    if quantized:
        jp, tp = jq.quantize_params(jp), quantize_params(tp, cfg=tcfg)
    with mock.patch.object(jmoe, "qeinsum", _expanded_qeinsum):
        want, _ = JServe(jcfg, jp, max_seq=MAX_SEQ).generate(
            jnp.asarray(prompts), NEW)
    engine = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, device="cpu")
    got, _ = engine.generate(torch.as_tensor(prompts), NEW)
    return np.asarray(want), got, engine, prompts


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch, quantized):
    want, got, _, _ = _generated(arch, quantized)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pooled_state_survives_two_decodes():
    """The tier hands out one state object; the port's decode writes KV
    caches in place, so ``decode`` copies on entry: two decodes from the
    pooled state give the same tokens, and the pool is unchanged."""
    _, _, engine, prompts = _generated("smollm-360m", False)
    state, idx, lg = engine.prefill(torch.as_tensor(prompts))
    tier = CoherentPrefixTier(n_lines=16, device="cpu")
    prefix = tuple(int(t) for t in prompts.reshape(-1))
    tier.publish(prefix, (state, idx, lg))
    before = [{k: v.clone() for k, v in layer.items()} for layer in state]
    outs = []
    for _ in range(2):
        s, i, last = tier.lookup(prefix)
        outs.append(engine.decode(s, last.argmax(-1), i, NEW)[0])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(before, state):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # and prefill from a given state leaves that state alone too.
    engine.prefill(torch.as_tensor(prompts[:, :2]), state=state,
                   start_index=idx)
    for a, b in zip(before, state):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n_readers", [1, 3])
def test_prefix_tier_equals_reference(n_readers):
    """Publish, look up from each reader, republish (invalidating the
    readers that hold the line), look up again, miss on an unpublished
    prefix: the same pool entries, hit rate and protocol traffic."""
    jt = JTier(n_lines=32, n_readers=n_readers)
    tt = CoherentPrefixTier(n_lines=32, n_readers=n_readers, device="cpu")
    rng = np.random.default_rng(n_readers)
    prefixes = [tuple(int(t) for t in rng.integers(0, 1000, 6))
                for _ in range(4)]

    def both(call, *args, **kw):
        a = getattr(jt, call)(*args, **kw)
        b = getattr(tt, call)(*args, **kw)
        assert a == b, (call, args, a, b)
        assert tt.store.interconnect_messages == \
            jt.store.interconnect_messages, call
        assert tt.hit_rate == jt.hit_rate, call

    for k, p in enumerate(prefixes[:3]):
        both("publish", p, f"state{k}")
    for reader in range(n_readers):
        for p in prefixes:
            both("lookup", p, reader=reader)
            both("lookup", p, reader=reader)
    both("publish", prefixes[0], "state0-v2")
    for reader in range(n_readers):
        both("lookup", prefixes[0], reader=reader)
    downgrades = tt.store.interconnect_messages["HOME_DOWNGRADE_I"]
    assert downgrades == n_readers
    assert tt.lookup(prefixes[3]) is None


def test_prefix_of_tensors_hashes_as_ints():
    tt = CoherentPrefixTier(n_lines=8, device="cpu")
    toks = torch.arange(5)
    tt.publish(tuple(toks), "s")
    assert tt.lookup(tuple(int(t) for t in toks)) == "s"


def test_serve_engine_accepts_and_ignores_mesh():
    """``ServeEngine(mesh=...)`` serves locally, as the reference's does:
    it clears the activation layout and generates the same tokens as with
    no mesh."""
    from repro_torch.launch.sharding import NamedSharding, P
    from repro_torch.models import transformer as T
    want, _, _, prompts = _generated("smollm-360m", False)
    _, tcfg, jp, _ = _model("smollm-360m")
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    T.set_activation_spec(NamedSharding(object(), P("data", None, None)))
    engine = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, mesh=object(),
                         device="cpu")
    assert T._ACT_SPEC is None
    got, _ = engine.generate(torch.as_tensor(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B_", [2, 3])
@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m"])
def test_make_serve_step_on_one_rank_equals_decode_step(arch, B_):
    """``make_serve_step`` on a mesh of one CPU rank: logits and state of
    ``decode_step`` bit for bit, token by token; the logits a DTensor,
    the state's leaves DTensors under ``decode_state_specs``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import close, make_local_mesh
    from repro_torch.models import transformer as T
    _, tcfg, jp, _ = _model(arch)
    tp = convert.model_params_to_torch(_np(jp), tcfg, "cpu")
    mesh = make_local_mesh(("pod", "data", "model"), device="cpu")
    try:
        s1 = T.init_decode_state(tcfg, B_, 8, "cpu")
        s2 = T.init_decode_state(tcfg, B_, 8, "cpu")
        step = make_serve_step(tcfg, mesh, s2, tp, global_batch=B_)
        specs = decode_state_specs(tcfg, mesh, s2)
        tok = torch.arange(B_, dtype=torch.int32)
        for i in range(4):
            l1, s1 = T.decode_step(tp, tcfg, tok, i, s1)
            l2, s2 = step(tp, tok, i, s2)
            assert isinstance(l2, DTensor)
            assert torch.equal(l2.full_tensor(), l1)
            tok = l1.argmax(-1).to(torch.int32)
        for (a, b), spec in zip(zip(s1, s2), specs):
            for k in a:
                assert isinstance(b[k], DTensor)
                assert spec[k][0] == ("pod", "data")
                assert torch.equal(b[k].full_tensor(), a[k])
    finally:
        close()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, _ = _model("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tcfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoherentPrefixTier()


def test_example_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        coherent_kv_serving.main(["--device", "cpu"])
    text = out.getvalue()
    assert "identical outputs: True" in text
    assert "'HOME_DOWNGRADE_I': 1" in text
    assert "token agreement" in text
