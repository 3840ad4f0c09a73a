"""Cells are data: a configuration, a traffic mix and a per-layer metric
added as new files to a copy of the benchmark are found and run by it,
with no file that was there edited.  And BENCHMARK.json keeps to the
benchmark's contract."""
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from eci_bench import harness, tinycells

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_added_files_make_a_cell(tmp_path):
    root = tinycells.copy_benchmark(tmp_path)
    before = _digests(root / HERE.name)
    tinycells.add_cell(root, "tiny-seq", dict(tinycells.TINY_CONFIG,
                                              name="tiny-seq-config"),
                       dict(tinycells.TINY_TRAFFIC, name="tiny-seq",
                            generator="sequential", params={}))
    (root / HERE.name / "metrics" / "budget_steps.py").write_text(
        "def read(ctx):\n    return ctx['budget']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "budget_steps", "unit": "steps", "better": "lower",
        "source": "program_counter", "layer": "driver loop",
        "moves": "ops_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root / HERE.name)
    assert all(after[p] == d for p, d in before.items())
    code = (f"import sys, time, json, torch; sys.path[:0] = "
            f"[{str(root)!r}, {str(ROOT / 'src')!r}]; "
            "torch.set_num_threads(1); "
            "from eci_bench import harness; "
            f"assert harness.HERE.parent == __import__('pathlib').Path("
            f"{str(root)!r}); "
            "print(json.dumps(harness.run('tiny-seq', 5, 0, True, 'cpu', "
            "time.perf_counter())))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    # 2 * 4 ops * 8 remotes + 12 * 4 + 64 steps
    assert res["metrics"]["budget_steps"] == {"value": 176, "unit": "steps"}
    assert "useful_steps_pct" in res["metrics"]


def test_run_without_a_card_prints_no_result():
    bench = harness.load_benchmark()
    out = subprocess.run(
        [sys.executable, "eci_bench/run.py", "--workload",
         bench["workloads"][0]["name"], "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == [HERE.name]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg.get("reduced", {}))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        harness.Cell(bench, w["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(harness._metric(ROOT, m["name"]).read)
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("part, change", [
    ("config", {"homes": 2}),
    ("config", {"protocol": "enhanced_mesi"}),
    ("config", {"word_bytes": 8}),
    ("config", {"lines_per_home": 16}),
    ("config", {"credits_per_vc": None}),
    ("traffic", {"loop": "open"}),
    ("traffic", {"steps": 100}),
    ("traffic", {"width": None}),
])
def test_a_key_the_harness_does_not_run_is_refused(tmp_path, part, change):
    root = tinycells.copy_benchmark(tmp_path)
    cfg, mix = dict(tinycells.TINY_CONFIG), dict(tinycells.TINY_TRAFFIC)
    d = cfg if part == "config" else mix
    for k, v in change.items():
        if v is None:
            del d[k]
        else:
            d[k] = v
    tinycells.add_cell(root, "tiny-odd", cfg, mix)
    with pytest.raises(SystemExit):
        harness.Cell(json.loads((root / "BENCHMARK.json").read_text()),
                     "tiny-odd", root)
