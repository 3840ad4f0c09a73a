"""What the harness and the reference may import: never JAX or the JAX
package (``repro``), compared by whole top-level names; and the
reference nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(p for p in (HERE / sub).rglob("*.py")
                  if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference") + [
    HERE / "check.py", HERE / "roofline.py"], ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_program(path):
    assert not set(_tops(path)) & (FORBIDDEN | {"repro_torch"})


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join("
         "sorted({n.split('.')[0] for n in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_whole_run_loads_no_jax(tmp_path):
    code = f"""
import time, torch
torch.set_num_threads(1)
from pathlib import Path
from eci_bench import control, harness, tinycells
import eci_bench.run
root = tinycells.tiny_root(Path({str(tmp_path)!r}))
out = harness.run("tiny", 3, 0, True, "cpu", time.perf_counter(), root=root)
assert out["correct"], out
"""
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_program():
    loaded = _loaded_after(
        "import eci_bench.check, eci_bench.roofline, "
        "eci_bench.reference.engine, eci_bench.reference.workloads")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from eci_bench import harness
    mods = dict.fromkeys(["repro_torch", "repro_torch.traffic", "jaxtyping",
                          "torch", "repro.core", "jax", "flax.linen"])
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == ["flax.linen", "jax", "repro.core"]
