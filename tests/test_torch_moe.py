"""The port's MoE block against ``repro.models.moe``, on the CPU.

The same numpy inputs and the reference's ``jax.random`` parameters go
through ``repro.models.moe.moe_block`` and ``repro_torch.models.moe``:
the output and the Switch aux loss at 2e-4 in fp32 (capacity 1.25, and
0.5 where slots are dropped), the slot positions bit for bit
(``dispatch_positions`` against the reference's one-hot cumsum), the int8
dispatch and combine (``dispatch_int8=True``), quantized expert weights
(``qeinsum`` with the scale over the capacity axis, against the
reference's block with that ``qeinsum``: the reference's own raises), and
decode against prefill at full capacity (``capacity_factor=8.0``, as
``tests/test_models.py`` does).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import quantize as jq  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 2e-4
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch, **moe):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return jcfg, tcfg


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _block(arch, key=1, B=2, S=8, **moe):
    jcfg, tcfg = _cfgs(arch, **moe)
    p = jmoe.moe_params(jax.random.key(key), jcfg, jnp.float32)
    p["ln"] = p["ln"] + 0.2                       # a nonzero norm gain
    x = np.random.default_rng(key).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


def _ref_positions(flat_e, n_experts, cap):
    """The reference's slot positions (``moe_block``'s one-hot cumsum)."""
    flat_e = jnp.asarray(flat_e)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(flat_e.shape[0]),
                                                flat_e]
    keep = pos < cap
    return (np.asarray(pos), np.asarray(keep),
            np.asarray(jnp.where(keep, pos, cap - 1)))


def _dropped(tcfg, x, p):
    """Slots the port's router drops for ``x`` (its own positions)."""
    m = tcfg.moe
    xn = tL.rms_norm(torch.as_tensor(x), p["ln"]).reshape(-1, tcfg.d_model)
    probs = torch.softmax(xn.float() @ p["router"], dim=-1)
    flat_e = torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)
    cap = tmoe.capacity(xn.shape[0], tcfg)
    return int((~tmoe.dispatch_positions(flat_e, m.n_experts, cap)[1]).sum())


@pytest.mark.parametrize("n,E,cap", [(64, 4, 20), (64, 4, 2), (512, 32, 12),
                                     (1000, 128, 8), (7, 3, 7)])
def test_dispatch_positions_bit_exact(n, E, cap):
    rng = np.random.default_rng(n + E)
    # a skewed draw: some experts overflow, some stay empty
    flat_e = np.minimum(rng.geometric(0.3, n) - 1, E - 1).astype(np.int32)
    pos, keep, safe = tmoe.dispatch_positions(
        torch.as_tensor(flat_e).long(), E, cap)
    want = _ref_positions(flat_e, E, cap)
    for got, w in zip((pos, keep, safe), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert pos.dtype == torch.int64 and keep.dtype == torch.bool


@pytest.mark.parametrize("n_tok,E,k,cf", [(32, 4, 2, 1.25), (1, 4, 2, 1.25),
                                          (8192, 32, 8, 1.25),
                                          (8, 128, 8, 1.25),
                                          (24, 4, 2, 8.0), (13, 5, 3, 0.7)])
def test_capacity_equals_reference_arithmetic(n_tok, E, k, cf):
    """The reference's ``max(int(n_tok * top_k / E * cf), top_k)``."""
    _, tcfg = _cfgs("granite-moe-1b-a400m", n_experts=E, top_k=k,
                    capacity_factor=cf)
    assert tmoe.capacity(n_tok, tcfg) == max(int(n_tok * k / E * cf), k)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_equals_reference(arch, cf):
    jcfg, tcfg, p, x = _block(arch, capacity_factor=cf, S=16)
    tp = _t(p)
    if cf < 1:
        assert _dropped(tcfg, x, tp) > 0          # the case drops slots
    want_y, want_aux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    got_y, got_aux = tmoe.moe_block(tp, tcfg, torch.as_tensor(x))
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    assert got_aux.shape == () and got_aux.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_aux, want_aux)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_dispatch_int8_equals_reference(arch, cf):
    jcfg, tcfg, p, x = _block(arch, key=2, capacity_factor=cf, S=16,
                              dispatch_int8=True)
    want_y, want_aux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    got_y, got_aux = tmoe.moe_block(_t(p), tcfg, torch.as_tensor(x))
    _close(got_y, want_y)
    _close(got_aux, want_aux)


def test_dispatch_int8_changes_the_output():
    """The int8 wire is not a no-op: its output differs from the plain
    dispatch's by the codes' rounding, and no more."""
    _, tcfg, p, x = _block("granite-moe-1b-a400m", key=3)
    tp, tx = _t(p), torch.as_tensor(x)
    plain, _ = tmoe.moe_block(tp, tcfg, tx)
    q8, _ = tmoe.moe_block(tp, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dispatch_int8=True)), tx)
    diff = float((plain - q8).abs().max())
    assert 0 < diff < 0.05 * float((plain - tx).abs().max())


def test_moe_block_decode_routes_batch_as_tokens():
    """Decode (S = 1): the B tokens of the step are the router's n_tok."""
    jcfg, tcfg, p, x = _block("qwen3-moe-235b-a22b", key=4, B=3, S=1)
    want_y, want_aux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    got_y, got_aux = tmoe.moe_block(_t(p), tcfg, torch.as_tensor(x))
    _close(got_y, want_y)
    _close(got_aux, want_aux)


def _fixed_qeinsum(spec, x, w):
    """The reference's ``qeinsum`` with the scale over the capacity axis:
    what the port's ``qeinsum`` computes."""
    if isinstance(w, dict):
        return jnp.einsum(spec, x, w["q"].astype(x.dtype)) * \
            w["s"].astype(x.dtype)[..., None, :]
    return jnp.einsum(spec, x, w)


def test_qeinsum_equals_scale_over_capacity_axis():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(rng.standard_normal((4, 16, 24)),
                                        jnp.float32))
    assert jw["s"].shape == (4, 24)
    tw = _t(jw)
    for spec in ("ecd,edf->ecf",):
        _close(tL.qeinsum(spec, torch.as_tensor(x), tw),
               _fixed_qeinsum(spec, jnp.asarray(x), jw))
    # a dense weight is a plain einsum
    w = rng.standard_normal((4, 16, 24)).astype(np.float32)
    _close(tL.qeinsum("ecd,edf->ecf", torch.as_tensor(x),
                      torch.as_tensor(w)),
           jnp.einsum("ecd,edf->ecf", x, w))


def test_reference_int8_moe_raises():
    """The reference's ``qeinsum`` multiplies the ``[E, C, f]`` product by
    the ``[E, f]`` scale unexpanded: its int8 MoE does not run (a fault
    of the reference; the port expands the scale)."""
    jcfg, _, p, x = _block("granite-moe-1b-a400m", key=6)
    qp = jq.quantize_params(p, min_size=64)
    assert jq.is_quantized(qp["w1"])
    with pytest.raises((ValueError, TypeError)):
        jmoe.moe_block(qp, jcfg, jnp.asarray(x))


@pytest.mark.parametrize("dispatch_int8", [False, True],
                         ids=["bf16wire", "int8wire"])
def test_quantized_experts_equal_reference_with_fixed_qeinsum(dispatch_int8):
    jcfg, tcfg, p, x = _block("granite-moe-1b-a400m", key=7,
                              dispatch_int8=dispatch_int8)
    qp = jq.quantize_params(p, min_size=64)
    with mock.patch.object(jmoe, "qeinsum", _fixed_qeinsum):
        want_y, want_aux = jmoe.moe_block(qp, jcfg, jnp.asarray(x))
    got_y, got_aux = tmoe.moe_block(_t(qp), tcfg, torch.as_tensor(x))
    _close(got_y, want_y)
    _close(got_aux, want_aux)


def test_moe_params_layout():
    """The port's own draw: the reference's keys, shapes, dtypes and
    scales (router fp32 whatever the model's dtype)."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        want = jmoe.moe_params(jax.random.key(0), jcfg, jdt)
        got = tmoe.moe_params(torch.Generator().manual_seed(0), tcfg, tdt,
                              "cpu")
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == \
                str(want[k].dtype), k
        assert bool((got["ln"] == 0).all())
        assert abs(float(got["w2"].float().std()) *
                   tcfg.moe.expert_d_ff ** 0.5 - 1) < 0.1


@pytest.fixture
def mesh1():
    """A mesh of one CPU rank (a world of one, ended afterwards)."""
    from repro_torch.launch.mesh import close, make_local_mesh
    yield make_local_mesh(("data", "model"), device="cpu")
    close()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_local_one_shard_equals_reference(arch, mesh1):
    """``moe_block_local`` on a mesh of one rank: one DP shard routes
    every token, so it is the reference's ``moe_block``, its output a
    DTensor with the batch over ``data``; ``moe_block_global`` on a group
    of one is ``moe_block`` itself."""
    from torch.distributed.tensor import DTensor
    jcfg, tcfg, p, x = _block(arch)
    jy, jaux = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    y, aux = tmoe.moe_block_local(_t(p), tcfg, torch.from_numpy(x), mesh1,
                                  ("data",))
    assert isinstance(y, DTensor) and tuple(y.shape) == x.shape
    _close(y.full_tensor(), jy)
    _close(aux, jaux)
    gy, gaux = tmoe.moe_block_global(_t(p), tcfg, torch.from_numpy(x),
                                     mesh1.get_group("data"))
    assert torch.equal(gy, y.full_tensor()) and torch.equal(gaux, aux)


def test_ep_spec_leaves_plain_tensors(mesh1):
    """With the expert layout set, a block on plain tensors computes what
    it computes without one (the reference's constraint outside a mesh
    context)."""
    from repro_torch.launch.sharding import NamedSharding, P
    _, tcfg, p, x = _block(ARCHS[0])
    want = tmoe.moe_block(_t(p), tcfg, torch.from_numpy(x))
    tmoe.set_ep_spec(NamedSharding(mesh1, P("model", None, None)))
    try:
        got = tmoe.moe_block(_t(p), tcfg, torch.from_numpy(x))
    finally:
        tmoe.set_ep_spec(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """fp32 decode against prefill at 2e-4, capacity 8.0 so that neither
    drops a slot (``tests/test_models.py::test_decode_matches_prefill``)."""
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(2)
    params = T.init_params(cfg, generator=gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    want = T.forward(params, cfg, toks)[:, -1]
    state = T.init_decode_state(cfg, 2, 12, "cpu")
    for t in range(12):
        got, state = T.decode_step(params, cfg, toks[:, t], t, state)
    _close(got, want.numpy())


def test_forward_aux_is_the_sum_over_layers():
    """``forward_body``'s aux: the blocks' aux losses summed in layer
    order, as the reference's scan carries it."""
    from repro.models import init_params as j_init_params
    from repro.models.transformer import forward_hidden
    from repro_torch import convert
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jp = j_init_params(jax.random.key(9), jcfg)
    tp = convert.model_params_to_torch(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 16))
    want_x, want_aux = forward_hidden(jp, jcfg, jnp.asarray(toks))
    got_x, got_aux = T.forward_body(tp, tcfg, torch.as_tensor(toks))
    _close(got_x, want_x)
    _close(got_aux, want_aux)
    assert float(got_aux) > 0
