"""The PyTorch port stands alone: no ``jax``, no ``repro``, no silent CPU.

``repro_torch`` must import on a machine without JAX (the card's), so
neither its modules nor ``chip_smoke.py`` may import ``jax`` or anything
of ``repro``; and an entry point left at its default device must raise
when no GPU is present instead of running the plain path on the CPU.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_level_imports(tree):
    """Import statements outside any function body."""
    out = []
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
        stack.extend(ast.iter_child_nodes(node))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_msgpack_or_zstandard_on_import(path):
    """The card's machine has neither ``msgpack`` nor ``zstandard``: no
    module of the port imports them when it is imported, and only the
    checkpoint codec imports ``zstandard``, inside the function that
    reads a compressed block."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [m for m in _module_level_imports(tree)
           if m.split(".")[0] in ("msgpack", "zstandard")]
    assert not top, f"{path.relative_to(ROOT)} imports {top}"
    anywhere = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names if a.name.split(".")[0] == "msgpack"]
    assert not anywhere, f"{path.relative_to(ROOT)} imports msgpack"


def test_sources_found():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(SOURCES) > 10


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_engine_raises_without_cuda(no_cuda):
    from repro_torch.core.engine_mn import EngineMN
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineMN(torch.zeros((16, 2)), n_remotes=2)


def test_default_config_build_raises_without_cuda(no_cuda):
    from repro_torch.traffic import EngineConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineConfig(remotes=2, lines=16).build()


def test_default_convert_raises_without_cuda(no_cuda):
    import numpy as np
    from repro_torch import convert
    from repro_torch.core.engine_mn import make_engine_mn_state
    st = convert.engine_state_to_numpy(
        make_engine_mn_state(torch.zeros((4, 2)), 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.engine_state_to_torch(st)
    assert isinstance(st.txn_msg, np.ndarray)


def test_default_training_entry_points_raise_without_cuda(no_cuda,
                                                         tmp_path):
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.optim import OptimConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config("smollm-360m", smoke=True)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    calls = [lambda: SyntheticPipeline(DataConfig(16, 4, 2)),
             lambda: Trainer(cfg, OptimConfig(), TrainerConfig(), None,
                             params, DataConfig(16, 4, 2)),
             lambda: ck.load(ck.save(str(tmp_path / "a.ckpt"),
                                     {"a": torch.zeros(2)}),
                             {"a": torch.zeros(2)})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    batch = SyntheticPipeline(DataConfig(16, 4, 2), device="cpu").batch(0)
    assert batch["tokens"].device.type == "cpu"


def test_default_mesh_raises_without_cuda(no_cuda):
    """``make_local_mesh()`` and the drivers' mesh default to the card:
    with no GPU they raise before any process group starts; a CPU mesh is
    asked for by name."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close, make_local_mesh, make_mesh
    for call in (make_local_mesh, lambda: make_mesh((1, 1),
                                                    ("data", "model"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        assert mesh.device_type == "cpu"
        assert dist.get_backend() == "gloo"
    finally:
        close()


def test_cuda_mesh_never_falls_back_to_gloo(monkeypatch):
    """A CUDA mesh without NCCL raises; so does a CUDA mesh in a gloo
    world."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs NCCL"):
        M.make_local_mesh(device="cuda")
    assert not dist.is_initialized()
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    M.make_local_mesh(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="needs nccl"):
            M.make_local_mesh(device="cuda")
    finally:
        M.close()


def test_kernel_wrappers_refuse_dtensors():
    """A kernel wrapper refuses a DTensor (it would read one rank's block)
    before it dispatches, on any device."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import coherency_step as C
    from repro_torch.kernels import models as MK
    from repro_torch.kernels import nmp as N
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import close, make_local_mesh
    mesh = make_local_mesh(device="cpu")
    try:
        def d(t):
            return sh.distribute(t, mesh, sh.P())
        b = torch.zeros((2, 8), dtype=torch.bool)
        i32 = torch.zeros((2, 8), dtype=torch.int32)
        f = torch.zeros((1, 2, 64, 32))
        calls = {"credit_rank": lambda: C.credit_rank(d(b), b),
                 "arb_winner": lambda: C.arb_winner(b, d(i32[0])),
                 "count_fold": lambda: C.count_fold(b, d(b.to(torch.int8)),
                                                    b),
                 "lat_hist": lambda: C.lat_hist(d(i32), b),
                 "packed_any": lambda: C.packed_any(d(i32)),
                 "packed_fanout": lambda: C.packed_fanout(
                     i32, d(i32), i32[:, 0], b[:, 0], b[:, 0]),
                 "select_scan": lambda: N.select_scan(
                     d(torch.zeros((256, 8))), 0.0, 1.0),
                 "regex_dfa": lambda: N.regex_dfa(
                     torch.zeros((2, 256), dtype=torch.int32),
                     torch.zeros(2, dtype=torch.bool),
                     d(torch.zeros((4, 8), dtype=torch.uint8))),
                 "hash_probe": lambda: N.hash_probe(
                     i32[0], i32[0], i32[0], d(i32[0]), 4),
                 "flash_attention": lambda: MK.flash_attention(f, d(f), f),
                 "rglru_scan": lambda: MK.rglru_scan(
                     d(torch.zeros((2, 16, 8))), torch.zeros((2, 16, 8)))}
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name}: a DTensor"):
                call()
        assert isinstance(d(b), DTensor)
    finally:
        close()


def test_default_counters_raise_without_cuda(no_cuda):
    from repro_torch.traffic.counters import make_counters
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_counters(4)
    ctr = make_counters(4, "cpu")
    assert ctr.lat_hist.shape == (4, 10)
    for leaf in ctr:
        assert leaf.device.type == "cpu"
        assert not bool(leaf.any())


def test_default_channel_and_agent_raise_without_cuda(no_cuda):
    from repro_torch.core.agent import make_agent
    from repro_torch.core.transport import make_channel
    for make in (make_channel, make_agent):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(16, 2)
    ch = make_channel(16, 2, device="cpu", lead=(3,))
    ag = make_agent(16, 2, device="cpu", lead=(3,))
    assert ch.msg.shape == ag.remote_state.shape == (3, 16)
    for leaf in (*ch, *ag):
        assert leaf.device.type == "cpu"
        assert not bool(leaf.any())


def test_explicit_cpu_runs_without_cuda(no_cuda):
    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, run_stream)
    run = run_stream(EngineConfig(remotes=2, lines=8).build("cpu"),
                     StreamConfig(workload=WorkloadSpec(ops=4)))
    assert run.completed
    assert run.state.txn_msg.device.type == "cpu"


def test_non_cpu_tensor_never_takes_plain_path(monkeypatch):
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device takes the kernel path, whose checks refuse it."""
    from repro_torch.kernels import coherency_step as K
    from repro_torch.kernels import ref

    called = []
    for name in ("credit_rank_ref", "arb_winner_ref", "count_fold_ref",
                 "lat_hist_ref"):
        monkeypatch.setattr(ref, name,
                            lambda *a, _n=name: called.append(_n))
    b = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    i32 = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    before = dict(K.launches)
    calls = [lambda: K.credit_rank(b, b),
             lambda: K.arb_winner(b, i32[0]),
             lambda: K.count_fold(b, b.to(torch.int8), b),
             lambda: K.lat_hist(i32, b)]
    for call in calls:
        with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
            call()
    assert called == []
    assert K.launches == before


def test_wrappers_have_no_fallback():
    """No ``try`` in the kernel wrappers: a failed build or launch is
    never swallowed into the plain path."""
    path = ROOT / "src" / "repro_torch" / "kernels" / "coherency_step.py"
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
