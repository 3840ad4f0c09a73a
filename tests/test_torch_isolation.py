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
