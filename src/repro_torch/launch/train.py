"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 200 --batch 8 --seq 128 [--device cpu]

The port of ``repro.launch.train``: the sharded train step, AdamW, the
synthetic pipeline, async checkpoints, the straggler monitor and
auto-resume, on ``make_local_mesh()`` — a world of one, or every rank of
``torchrun --nproc-per-node N -m repro_torch.launch.train ...`` (NCCL on
the card, gloo with ``--device cpu``).  Parameters are drawn from a
seed; ``--device`` defaults to ``cuda``.  The driver ends the process
group it joined.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_config
from ..data import DataConfig
from ..device import resolve_device
from ..models import init_params
from ..optim import OptimConfig
from ..train import Trainer, TrainerConfig
from .mesh import close, make_local_mesh, mesh_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = make_local_mesh(device=resolve_device(args.device))
    try:
        dev = mesh_device(mesh)
        params = init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        ocfg = OptimConfig(peak_lr=args.lr,
                           warmup_steps=min(50, args.steps // 10 + 1),
                           total_steps=args.steps)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
        tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir)
        if not args.resume and dist.get_rank() == 0:
            shutil.rmtree(args.ckpt_dir, ignore_errors=True)
        dist.barrier()
        trainer = Trainer(cfg, ocfg, tcfg, mesh, params, dcfg,
                          microbatches=args.microbatches)
        result = trainer.run()
        if dist.get_rank() == 0:
            print(json.dumps({"arch": cfg.name,
                              "mesh": dict(zip(mesh.mesh_dim_names,
                                               mesh.shape)),
                              "device": str(dev),
                              "first_loss": trainer.metrics_log[0]["loss"],
                              **result}, default=str, indent=1))
    finally:
        close()


if __name__ == "__main__":
    main()
