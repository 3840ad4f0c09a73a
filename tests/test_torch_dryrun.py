"""The production-mesh dry run (``repro_torch.launch.dryrun``) and the
counters of ``repro_torch.roofline.count``, on fake worlds.

A process group is process-global, so each world that traces runs in a
subprocess, and the three run together (``worlds``); only
``start_fake_world``'s own checks start and end a world in this process.

* a fake world of 8 ranks as ``(2, 4)`` ("data", "model") and one as
  ``(2, 2, 2)`` ("pod", "data", "model") (``_world``): every smoke config
  through ``run_cell`` at each shape kind at a small size, each record
  ``ok`` or ``skipped`` exactly where ``cell_applicable`` says; the
  sharded train step's counted flops of smollm-360m and gemma2-9b times
  the data-parallel and tensor-parallel sizes against the unsharded
  ``train_step``'s on the global batch, and its all-gathers (none larger
  than one layer's FSDP shards, all of them together less than the
  parameters); hand-issued collectives of known shapes (``c10d`` and
  functional) against their output bytes; ``MemTracker``'s peak against
  a closed form; ``mesh_desc`` and the backend of a ``DeviceMesh`` on
  the fake group; a cell whose batch does not divide recorded
  ``FAILED`` with its traceback;
* the CLI on one production cell at full width, smollm-360m
  ``decode_32k`` on the (16, 16) mesh of a fake 256-rank world: exit 0,
  an ``ok`` record that ``benchmarks/run.py::roofline_rows`` reads, then
  ``--skip-existing`` skips it.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = ("chameleon-34b", "gemma2-9b", "granite-34b", "granite-moe-1b-a400m",
         "nemotron-4-340b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
         "rwkv6-3b", "smollm-360m", "whisper-small")
#: the four shape kinds at a small size (the names, and so
#: ``cell_applicable``'s verdicts, are the production cells').
SMALL = (("train_4k", 16, 8, "train"), ("prefill_32k", 16, 8, "prefill"),
         ("decode_32k", 16, 8, "decode"), ("long_500k", 32, 1, "decode"))
DENSE = ("smollm-360m", "gemma2-9b")
CLI_ARCH, CLI_SHAPE = "smollm-360m", "decode_32k"
TIMEOUT = 600


# -- a world's subprocess -----------------------------------------------------

def _hand_collectives(mesh):
    """Collectives of known shapes over the mesh's ``model`` group, by
    ``torch.distributed`` and by the functional API: their counted bytes
    and the bytes each writes on this rank."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from repro_torch.roofline.count import trace_step
    g = mesh.get_group("model")
    n = dist.get_world_size(g)

    def hand(x, y, z, w):
        gathered = x.new_empty((n * x.numel(),))
        dist.all_gather_into_tensor(gathered, x.reshape(-1), group=g)
        scattered = y.new_empty((y.numel() // n,))
        dist.reduce_scatter_tensor(scattered, y.reshape(-1), group=g)
        dist.all_reduce(z, group=g)
        swapped = torch.empty_like(w)
        dist.all_to_all_single(swapped, w, group=g)
        got = torch.empty_like(x)
        dist.send(x, dst=1, group=g)
        dist.recv(got, src=1, group=g)
        return (fc.all_gather_tensor(x, 0, g), fc.reduce_scatter_tensor(
            y, "sum", 0, g), fc.all_reduce(z, "sum", g),
            fc.all_to_all_single(w, None, None, g))

    c = trace_step(hand, lambda: (
        torch.empty(6, 5), torch.empty(8, 4, dtype=torch.bfloat16),
        torch.empty(7, dtype=torch.float64), torch.empty(16, 3)))
    want = {"all-gather": 2 * n * 30 * 4, "reduce-scatter": 2 * 32 * 2 // n,
            "all-reduce": 2 * 7 * 8, "all-to-all": 2 * 48 * 4,
            "collective-permute": 30 * 4}      # the recv; a send lands none
    return {"got": c.collective_bytes, "calls": c.collective_calls,
            "want": want}


def _mem_pattern():
    """``MemTracker``'s peak over a known pattern: an external argument
    of A bytes, then b and c live together, b freed, d allocated; the
    peak is A + b + c (c + d is smaller; A + b + c + d had b not been
    freed)."""
    from repro_torch.roofline.count import trace_step

    def pattern(a):
        b = torch.empty(4096)
        c = torch.empty(1024)
        del b
        d = torch.empty(2048)
        return c, d

    c = trace_step(pattern, lambda: (torch.empty(512, dtype=torch.float64),))
    return {"peak": c.peak_bytes, "argument": c.argument_bytes,
            "output": c.output_bytes,
            "want": {"peak": 512 * 8 + 4096 * 4 + 1024 * 4,
                     "argument": 512 * 8, "output": (1024 + 2048) * 4}}


class _Gathers:
    """The bytes each all-gather writes on this rank, call by call: a
    dispatch mode entered inside ``trace_step``'s (``wrap``)."""

    def __init__(self):
        self.sizes = []

    def wrap(self, fn):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.roofline import count as C
        sizes = self.sizes

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                name = func._schema.name.split("::")[-1]
                if func.namespace in C._COMM_NAMESPACES and \
                        C._KIND.get(name) == "all-gather":
                    sizes.append(sum(C._nbytes(t) for t in
                                     C._written(func, name, args, out)))
                return out

        def run(*args):
            with Mode():
                return fn(*args)
        return run


def _dense_flops(mesh, arch):
    """Counted flops of the sharded train step (rank 0) and of the
    unsharded ``train_step`` on the global batch; the step's all-gather
    bytes (all, and the largest call), the parameters' bytes, the
    largest layer's FSDP shards gathered (this rank's ``model`` shard of
    each leaf whole over ``data``), its peak and its argument bytes."""
    import math

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import input_specs
    from repro_torch.optim import OptimConfig
    from repro_torch.roofline.count import trace_step
    from repro_torch.train import init_state, train_step
    from repro_torch.tree import leaves, leaves_with_path, tree_map
    cfg = get_config(arch, smoke=True)
    cell = ShapeCell("train_4k", 16, 8, "train")
    fn, args = D.lower_cell(cfg, cell, mesh)
    gathers = _Gathers()
    sharded = trace_step(gathers.wrap(fn), args)
    spec = input_specs(cfg, cell)

    def plain():
        fake = lambda t: torch.empty(t.shape, dtype=t.dtype)
        return (init_state(tree_map(fake, spec["state"].params)),
                {k: fake(x) for k, x in spec["batch"].items()})

    whole = trace_step(lambda s, b: train_step(cfg, OptimConfig(), 1, s, b),
                       plain)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def gathered(path, t):
        """A leaf's bytes once its layer's FSDP gather has run."""
        split = math.prod(sizes[a] for a in sh.spec_axes(
            sh.param_spec(path, t)) if a != "data")
        return t.numel() * t.element_size() // split

    layers = spec["state"].params["layers"]
    return {"sharded": sharded.flops, "unsharded": whole.flops,
            "dp": sh.axes_size(mesh, sh.dp_axes(mesh)),
            "tp": sizes["model"],
            "all_gather": sharded.collective_bytes["all-gather"],
            "largest_gather": max(gathers.sizes),
            "layer_shards": max(sum(gathered(p, t) for p, t in
                                    leaves_with_path(layer))
                                for layer in layers),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in leaves(spec["state"].params)),
            "peak": sharded.peak_bytes,
            "argument": sharded.argument_bytes}


def _world(name: str, root: str) -> None:
    """A fake world of 8 ranks on ``MESHES[name]``: every check of the
    world, its results to ``root/<name>.json`` and its records under
    ``root/<name>/``."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import close, make_mesh, start_fake_world
    from repro_torch.roofline.analytic import mesh_desc
    shape, axes = MESHES[name]
    out_dir = os.path.join(root, name)
    res = {}
    start_fake_world(8)
    try:
        mesh = make_mesh(shape, axes, "cpu")
        res["backend"] = str(dist.get_backend())
        res["mesh_desc"] = dataclasses.astuple(mesh_desc(mesh))
        res["status"] = {}
        for arch in ARCHS:
            for cell in SMALL:
                rec = D.run_cell(arch, ShapeCell(*cell), len(shape) == 3,
                                 out_dir, mesh=mesh, smoke=True)
                res["status"][f"{arch}/{cell[0]}"] = [
                    rec["status"], rec.get("error", "")]
        res["flops"] = {a: _dense_flops(mesh, a) for a in DENSE}
        res["hand"] = _hand_collectives(mesh)
        res["mem"] = _mem_pattern()
        bad = D.run_cell("smollm-360m", ShapeCell("train_4k", 16, 3, "train"),
                         len(shape) == 3, os.path.join(root, name + "_bad"),
                         mesh=mesh, smoke=True)
        res["bad"] = {k: bad.get(k) for k in ("status", "error", "traceback")}
    finally:
        close()
    res["closed"] = not dist.is_initialized()
    with open(os.path.join(root, name + ".json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(world name -> its results, the CLI's (returncodes, outputs, the
    record directory))."""
    root = str(tmp_path_factory.mktemp("dryrun"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    logs = {k: open(os.path.join(root, k + ".log"), "w")
            for k in (*MESHES, "cli")}
    cli_out = os.path.join(root, "cli")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           CLI_ARCH, "--shape", CLI_SHAPE, "--mesh", "single", "--out",
           cli_out]
    procs = {k: subprocess.Popen([sys.executable, "-c", textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {here!r})
        from test_torch_dryrun import _world
        _world({k!r}, {root!r})
        """)], env=env, stdout=logs[k], stderr=subprocess.STDOUT)
        for k in MESHES}
    try:
        first = subprocess.run(cli, env=env, capture_output=True, text=True,
                               timeout=TIMEOUT)
        again = subprocess.run(cli + ["--skip-existing"], env=env,
                               capture_output=True, text=True, timeout=120)
        for k, p in procs.items():
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            p.kill()
        for f in logs.values():
            f.close()
    out = {}
    for k, p in procs.items():
        with open(os.path.join(root, k + ".log")) as f:
            assert p.returncode == 0, f.read()[-4000:]
        with open(os.path.join(root, k + ".json")) as f:
            out[k] = json.load(f)
    return out, (first, again, cli_out), root


# -- the worlds' results ------------------------------------------------------

def test_fake_world_starts_only_by_name():
    """``start_fake_world`` makes this process rank 0 of a world of N;
    a mesh of N devices builds on it, a second start is refused, and
    ``close`` ends it (no launcher, gloo or NCCL world is touched)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (close, make_mesh, mesh_devices,
                                         start_fake_world)
    start_fake_world(16)
    try:
        assert (dist.get_rank(), dist.get_world_size()) == (0, 16)
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        assert mesh_devices(mesh) == 16
        assert list(mesh.get_coordinate()) == [0, 0]
        with pytest.raises(RuntimeError, match="without a process group"):
            start_fake_world(16)
        with pytest.raises(ValueError, match="needs 8 ranks"):
            make_mesh((2, 4), ("data", "model"), "cpu")
    finally:
        close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", MESHES)
def test_fake_world_builds_the_mesh(worlds, name):
    res = worlds[0][name]
    shape, axes = MESHES[name]
    sizes = dict(zip(axes, shape))
    assert res["backend"] == "fake"
    assert res["mesh_desc"] == [sizes["model"], sizes["data"],
                                sizes.get("pod", 1)]
    assert res["closed"]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_cell_ok_or_skipped_as_applicable(worlds, name, arch):
    from repro_torch.configs import ShapeCell, cell_applicable, get_config
    cfg = get_config(arch, smoke=True)
    res = worlds[0][name]["status"]
    for cell in SMALL:
        status, err = res[f"{arch}/{cell[0]}"]
        want = "skipped" if cell_applicable(cfg, ShapeCell(*cell)) else "ok"
        assert status == want, (cell[0], err)


@pytest.mark.parametrize("name", MESHES)
def test_smoke_records_hold_the_counted_block(worlds, name):
    from repro_torch.configs import ShapeCell, cell_applicable, get_config
    root = worlds[2]
    multi = len(MESHES[name][0]) == 3
    n = 0
    for arch in ARCHS:
        for cell in SMALL:
            path = os.path.join(root, name, f"{arch}__{cell[0]}__"
                                f"{'multi' if multi else 'single'}.json")
            with open(path) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                continue
            n += 1
            r = rec["roofline"]
            assert r["chips"] == 8 and rec["roofline_analytic"]["chips"] == 8
            assert r["flops_per_device"] == rec["cost_analysis"]["flops"] > 0
            assert r["bytes_per_device"] > 0
            assert r["coll_bytes_per_device"] == sum(
                r["coll_breakdown"].values()) > 0
            mem = rec["memory_analysis"]
            assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
            assert set(rec["n_collectives"]) <= set(r["coll_breakdown"])
            assert "transcendentals" not in rec["cost_analysis"]
    assert n == sum(not cell_applicable(get_config(a, smoke=True),
                                        ShapeCell(*c))
                    for a in ARCHS for c in SMALL)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_dense_per_rank_flops_times_dp_tp_equal_unsharded(worlds, name,
                                                          arch):
    """Each rank computes its share: its rows and its ``model`` shard
    (the attention every rank repeats where the heads do not divide is
    the only excess)."""
    f = worlds[0][name]["flops"][arch]
    assert f["dp"] == {"2x4": 2, "2x2x2": 4}[name]
    assert f["tp"] == {"2x4": 4, "2x2x2": 2}[name]
    assert f["sharded"] > 0
    assert 1.0 <= f["sharded"] * f["dp"] * f["tp"] / f["unsharded"] <= 1.25


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_gathers_one_layer_at_a_time(worlds, name, arch):
    """No all-gather moves more than one layer's FSDP shards, and all of
    them together less than the parameters: no whole-tree gather."""
    f = worlds[0][name]["flops"][arch]
    assert 0 < f["largest_gather"] <= f["layer_shards"]
    assert f["all_gather"] < f["param_bytes"]
    assert f["peak"] >= f["argument"] > 0


@pytest.mark.parametrize("name", MESHES)
def test_collective_counter_on_hand_issued_collectives(worlds, name):
    h = worlds[0][name]["hand"]
    assert h["got"] == h["want"]
    assert h["calls"] == {k: 2 for k in h["got"]}


@pytest.mark.parametrize("name", MESHES)
def test_mem_tracker_peak_equals_closed_form(worlds, name):
    m = worlds[0][name]["mem"]
    assert {k: m[k] for k in m["want"]} == m["want"]


@pytest.mark.parametrize("name", MESHES)
def test_failed_cell_is_recorded_with_its_traceback(worlds, name):
    bad = worlds[0][name]["bad"]
    assert bad["status"] == "FAILED"
    assert "divide" in bad["error"] or "split" in bad["error"], bad["error"]
    assert "Traceback" in bad["traceback"]


# -- the CLI on a production cell ---------------------------------------------

def test_cli_production_cell_at_full_width(worlds):
    first, _, out = worlds[1]
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-4000:]
    cid = f"{CLI_ARCH}__{CLI_SHAPE}__single"
    assert f"[ok] {cid}" in first.stdout
    assert "done, failures: 0" in first.stdout
    with open(os.path.join(out, cid + ".json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["t_build_s"] >= 0 and rec["t_trace_s"] > 0
    r = rec["roofline"]
    assert r["chips"] == 256 and r["arch"] == CLI_ARCH
    # this rank's rows: 128 sequences over 16 data-parallel ranks, its
    # shard of the weights and the caches' block of the sequence (5 kv
    # heads over 16 ranks): activation gathers and psums, a few MB a
    # token, and no weight or cache gathered.
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert 0 < r["coll_breakdown"]["all-gather"] < 115e6
    assert 0 < r["coll_bytes_per_device"] < 115e6
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
              "roofline_fraction", "useful_flops_fraction"):
        assert k in r and k in rec["roofline_analytic"]


def test_cli_record_read_by_roofline_rows(worlds, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    from benchmarks.run import roofline_rows
    (name, us, derived), = roofline_rows(worlds[1][2])
    assert name == f"roofline/{CLI_ARCH}/{CLI_SHAPE}/single"
    assert derived.startswith("bottleneck=") and "useful=" in derived


def test_cli_skip_existing(worlds):
    _, again, _ = worlds[1]
    assert again.returncode == 0, again.stderr[-4000:]
    assert f"[skip] {CLI_ARCH}__{CLI_SHAPE}__single" in again.stdout
