"""End-to-end training example: a smollm-family model trained for a few
hundred steps with the port's whole stack on one device (the train step
with AdamW and its cosine schedule, the synthetic pipeline, async
checkpoints, the straggler monitor, a simulated failure and the resume).

    PYTHONPATH=src python -m repro_torch.examples.train_smollm \
        [--steps 300] [--fail-at 150] [--device cpu]

The port of ``examples/train_smollm.py``: smollm-360m's smoke config
(the full config trains on the card in ``chip_smoke.py``'s phase 12),
parameters drawn from a seed, on the card unless ``--device`` names
another device.  Checkpoints go to ``--ckpt-dir`` (a fresh temporary
directory by default), which is emptied first.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import OptimConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=150,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_example_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    cfg = get_config("smollm-360m", smoke=True)
    ocfg = OptimConfig(peak_lr=5e-3, warmup_steps=20, total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt)

    def make_trainer():
        params = init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        return Trainer(cfg, ocfg, tcfg, None, params, dcfg,
                       on_straggler=lambda e: print(f"  [straggler] {e}"),
                       device=dev)

    t = make_trainer()
    try:
        t.run(fail_at=args.fail_at, delay_at=args.steps // 3)
    except RuntimeError as e:
        print(f"!! {e} — restarting from the latest valid checkpoint")
        t.saver.wait()
        t = make_trainer()
        t.run()

    log = t.metrics_log
    print(f"\nsteps run this process: {len(log)}")
    print(f"loss: first5 {np.mean([m['loss'] for m in log[:5]]):.3f} -> "
          f"last5 {np.mean([m['loss'] for m in log[-5:]]):.3f}")
    print(f"stragglers flagged: {len(t.monitor.events)}")
    print("done — checkpoints in", ckpt)


if __name__ == "__main__":
    main()
