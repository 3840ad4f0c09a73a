"""Tiny cells for the CPU tests: a copy of the benchmark (this directory
and ``BENCHMARK.json``) in a temporary directory, with a configuration
and a traffic mix small enough for the CPU added as new files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_CONFIG = {"name": "tiny", "remotes": 8, "lines": 32, "block": 4,
               "word_bytes": 4, "homes": 1, "protocol": "full_moesi",
               "packed": False, "credits_per_vc": 64}
TINY_TRAFFIC = {"name": "tiny-fleet4", "loop": "closed", "members": 4,
                "generator": "zipfian",
                "params": {"alpha": 0.99, "store_frac": 0.5}, "ops": 4,
                "width": 1, "check_members": 3}


def copy_benchmark(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and a copy of this directory
    (no caches); returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(HERE, dest / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return dest


def add_cell(root: Path, name: str, config: dict, traffic: dict) -> None:
    """Add a configuration file, a traffic file and a one-chip cell of
    the two to the copy at ``root``."""
    (root / HERE.name / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (root / HERE.name / "traffic" / f"{traffic['name']}.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": config["name"], "source": "tiny",
            "file": f"{HERE.name}/configs/{config['name']}.json",
            "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": traffic["name"], "chips": 1,
                               "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_root(dest: Path, packed: bool = False) -> Path:
    """A copy with the cell ``tiny`` (dense, or ``packed``)."""
    root = copy_benchmark(dest)
    add_cell(root, "tiny", dict(TINY_CONFIG, packed=packed), TINY_TRAFFIC)
    return root
