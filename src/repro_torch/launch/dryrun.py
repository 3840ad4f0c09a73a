"""Production-mesh dry run: build and trace every (arch x shape x mesh) cell.

The port of ``repro.launch.dryrun``.  For each cell this driver:
  1. starts a fake world of 256 ranks (single pod, a (16, 16) mesh) or
     512 (multi-pod, (2, 16, 16)) with this process as rank 0
     (``mesh.start_fake_world``: torch's fake process group, whose
     collectives move nothing);
  2. builds the step function the cell calls for (``make_train_step``, a
     prefill forward on this rank's rows and shards, or
     ``make_serve_step``) with the production layouts;
  3. traces one call under ``FakeTensorMode`` on stand-ins of rank 0's
     shards of ``specs.input_specs`` (shape and dtype only: nothing is
     allocated) and counts its flops, bytes, collectives and peak memory
     (``roofline.count``);
  4. writes the record to ``<out>/<arch>__<shape>__<single|multi>.json``
     beside the first-principles terms (``roofline.analysis``).

Failures here (a dim that does not divide its mesh axis, a collective
the sharded step cannot issue, a host read on the traced path) are
recorded as ``FAILED`` with their traceback and make the run exit 1: the
check that the mesh paths would run on the big meshes.

The numbers are rank 0's eager work: the port's sharded steps compute on
this rank's rows and on its ``model`` shard of the heads, columns,
channels, experts and vocab (``sharding.TPContext``), gathering each
layer's FSDP shards when the layer runs, so a dense model's counted
flops are about its share of the global step's.

Device: the dry run allocates nothing and launches nothing, and it is the
one entry point with no ``device=``.  Its world is typed ``"cpu"``, so the
trace takes the kernels' plain twins (a wrapper launches its kernel only
on a CUDA tensor), as the reference's host dry run runs its kernels in
interpret mode; no path that computes anything changes.

Usage (CPU only, no card needed):
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs import ARCHS, SHAPES, ShapeCell, cell_applicable, get_config
from ..models.config import ModelConfig
from ..roofline import analysis as ra
from ..roofline.count import StepCounts, trace_step
from ..tree import tree_map
from . import sharding as sh
from .mesh import close, make_production_mesh, mesh_devices, start_fake_world
from .specs import input_specs


def _shard(meta: torch.Tensor, mesh, spec):
    """A fake DTensor of ``meta``'s global shape and dtype laid out by
    ``spec``: this rank's block as its local tensor.  Call inside the
    fake mode."""
    from torch.distributed.tensor import DTensor, Shard
    pl = sh.placements(mesh, spec, meta.shape)
    shape = list(meta.shape)
    for size, p in zip(mesh.shape, pl):
        if isinstance(p, Shard):
            shape[p.dim] //= size
    return DTensor.from_local(
        torch.empty(shape, dtype=meta.dtype), mesh, pl, run_check=False,
        shape=meta.shape, stride=torch.empty(meta.shape, device="meta"
                                             ).stride())


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh
               ) -> Tuple[Callable, Callable[[], Tuple[Any, ...]]]:
    """The cell's step function, built on ``mesh`` (its groups and
    shardings made here, outside the fake mode), and a maker of its
    arguments: rank 0's shards of ``input_specs`` as fake DTensors, to be
    called inside the fake mode (``roofline.count.trace_step``)."""
    serve_cfg = dataclasses.replace(cfg, remat=False)
    dp = sh.dp_axes(mesh)
    if cell.kind == "train":
        from ..optim import OptimConfig
        from ..optim.adamw import OptState
        from ..train.train_step import TrainState, make_train_step
        spec = input_specs(cfg, cell)
        st = spec["state"]
        step = make_train_step(cfg, OptimConfig(), mesh, st.params,
                               microbatches=1, donate=True)
        pspecs = sh.param_specs(st.params)

        def args():
            put = lambda t, s: _shard(t, mesh, s)
            rep = lambda t: put(t, sh.P(*([None] * t.ndim)))
            state = TrainState(
                params=tree_map(put, st.params, pspecs),
                opt=OptState(step=rep(st.opt.step),
                             m=tree_map(put, st.opt.m, pspecs),
                             v=tree_map(put, st.opt.v, pspecs)),
                data_step=rep(st.data_step))
            batch = {k: _shard(x, mesh, sh.batch_spec(mesh, x.ndim))
                     for k, x in spec["batch"].items()}
            return state, batch
        return step, args

    if cell.kind == "prefill":
        from ..models import layers as L
        from ..models import moe as moe_mod
        from ..models import transformer as tr
        tr.set_activation_spec(sh.NamedSharding(mesh, sh.P(dp, None, None)))
        moe_mod.set_ep_spec(sh.NamedSharding(mesh, sh.P("model", None, None)))
        spec = input_specs(cfg, cell)
        pspecs = sh.param_specs(spec["params"])
        moe_group = sh.axes_group(mesh, dp) if cfg.moe is not None and \
            sh.axes_size(mesh, dp) > 1 else None
        tp = sh.TPContext(mesh, "2d")

        def prefill(params, batch):
            """``forward(..., last_only=True)`` on this rank's rows and
            shards, each layer's FSDP shards gathered as it runs; the
            logits of this rank's block of the vocab.  A MoE routes every
            rank's tokens as one batch."""
            local = tree_map(sh.local, params)
            x, _ = tr.forward_body(local, serve_cfg,
                                   sh.local(batch["tokens"]),
                                   frames=sh.local(batch.get("frames")),
                                   moe_group=moe_group, tp=tp)
            return L.logits(local["embed"], serve_cfg, x[:, -1:], tp)

        def args():
            return (tree_map(lambda t, s: _shard(t, mesh, s),
                             spec["params"], pspecs),
                    {k: _shard(x, mesh, sh.batch_spec(mesh, x.ndim))
                     for k, x in spec["batch"].items()})
        return prefill, args

    if cell.kind == "decode":
        from ..serve.engine import decode_state_specs, make_serve_step
        spec = input_specs(serve_cfg, cell)
        step = make_serve_step(serve_cfg, mesh, spec["state"],
                               spec["params"], global_batch=cell.global_batch,
                               donate=True)
        shard_batch = cell.global_batch % sh.axes_size(mesh, dp) == 0
        pspecs = sh.param_specs(spec["params"], mode="serve")
        sspecs = decode_state_specs(serve_cfg, mesh, spec["state"],
                                    shard_batch)
        tok_spec = sh.P(dp if shard_batch else None)

        def args():
            put = lambda t, s: _shard(t, mesh, s)
            # the cache's occupancy: a host int, as a server passes it.
            return (tree_map(put, spec["params"], pspecs),
                    put(spec["token"], tok_spec), cell.seq_len - 1,
                    tree_map(put, spec["state"], sspecs))
        return step, args

    raise ValueError(cell.kind)


@contextlib.contextmanager
def production_mesh(multi_pod: bool):
    """A fake world of the production mesh's size and the mesh on it;
    the world ends when the block does."""
    start_fake_world(512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        close()


def record(arch: str, cfg: ModelConfig, cell: ShapeCell, mesh_name: str,
           mesh, c: StepCounts) -> Dict[str, Any]:
    """The counted block of a cell's record."""
    roof = ra.Roofline(
        arch=arch, shape=cell.name, mesh=mesh_name,
        chips=mesh_devices(mesh), flops_per_device=float(c.flops),
        bytes_per_device=float(c.bytes_accessed),
        coll_bytes_per_device=float(sum(c.collective_bytes.values())),
        coll_breakdown=dict(c.collective_bytes),
        model_flops=ra.model_flops(cfg, cell),
        peak_mem_per_device=float(c.peak_bytes))
    return {
        "roofline_analytic": ra.analytic_roofline(cfg, cell, mesh),
        "memory_analysis": {"peak_size_in_bytes": c.peak_bytes,
                            "argument_size_in_bytes": c.argument_bytes,
                            "output_size_in_bytes": c.output_bytes},
        "cost_analysis": {"flops": float(c.flops),
                          "bytes accessed": float(c.bytes_accessed)},
        "roofline": roof.to_dict(),
        # calls of each collective (their bytes: roofline.coll_breakdown)
        "n_collectives": {k: v for k, v in c.collective_calls.items() if v},
    }


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool, out_dir: str,
             mesh=None, smoke: bool = False) -> Dict[str, Any]:
    """Build, trace and record one cell.  ``mesh``: the mesh to trace on
    (default: the production mesh, in a fake world this call starts and
    ends); ``smoke``: the config's smoke variant."""
    cfg = get_config(arch, smoke=smoke)
    mesh_name = "multi" if multi_pod else "single"
    path = os.path.join(out_dir, f"{arch}__{cell.name}__{mesh_name}.json")
    rec: Dict[str, Any] = {"arch": arch, "shape": cell.name,
                           "mesh": mesh_name, "kind": cell.kind}
    skip = cell_applicable(cfg, cell)
    if skip:
        rec.update(status="skipped", reason=skip)
        _write(path, rec)
        return rec
    world = production_mesh(multi_pod) if mesh is None else \
        contextlib.nullcontext(mesh)
    try:
        with world as m:
            t0 = time.perf_counter()
            fn, args = lower_cell(cfg, cell, m)
            t_build = time.perf_counter() - t0
            counts = trace_step(fn, args)
            t_trace = time.perf_counter() - t0 - t_build
            rec.update(status="ok", t_build_s=round(t_build, 3),
                       t_trace_s=round(t_trace, 3),
                       **record(arch, cfg, cell, mesh_name, m, counts))
    except Exception as e:      # the record is the report
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-3000:])
    _write(path, rec)
    return rec


def _write(path: str, rec: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    cells = SHAPES if args.shape == "all" else [
        s for s in SHAPES if s.name == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for cell in cells:
            for multi in meshes:
                cid = f"{arch}__{cell.name}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, cid + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[skip] {cid}")
                            continue
                t0 = time.perf_counter()
                rec = run_cell(arch, cell, multi, args.out)
                dt = time.perf_counter() - t0
                st = rec["status"]
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    peak = rec["memory_analysis"]["peak_size_in_bytes"]
                    a = rec["roofline_analytic"]
                    share = a["flops_global"] / a["chips"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" useful={r['useful_flops_fraction']:.3f}"
                             f" peak/dev={peak / 2 ** 30:.2f}GiB"
                             f" flops/share="
                             f"{r['flops_per_device'] / share:.3f}"
                             f" coll/dev={r['coll_bytes_per_device']:.4g}B"
                             f" (analytic {a['coll_bytes_dev']:.4g}B)")
                elif st == "FAILED":
                    n_fail += 1
                    extra = " " + rec["error"][:160]
                print(f"[{st}] {cid} ({dt:.1f}s){extra}", flush=True)
    print(f"done, failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
