"""Training driver: checkpoint and restart, straggler monitoring, and the
failure-injection hooks.

The port of ``repro.train.trainer``.  Every ``ckpt_every`` steps an
``AsyncCheckpointer`` snapshots the whole ``TrainState`` (params,
optimizer, ``data_step``) in the reference's stacked layout
(``convert.stack_train_state``), so ``repro`` restores a port checkpoint
and the other way round.  On a failure the driver restarts from
``latest_valid``: the pipeline is a pure function of ``data_step``, so
the resumed run replays the same tokens and ends with the same
parameters bit for bit.  A straggler monitor flags steps slower than
``straggler_factor`` times the running median.

With a ``mesh`` the state is sharded (``make_train_step``), every rank
runs the loop, rank 0 writes the checkpoints (full logical arrays), and
a restart on any mesh distributes what every rank reads
(``runtime.elastic.resume_on_mesh``).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import convert
from ..checkpoint import checkpoint as ckpt
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..device import resolve_device
from ..models.config import ModelConfig
from ..optim.adamw import OptimConfig
from ..launch import sharding as sh
from ..tree import tree_map
from .train_step import init_state, make_train_step, train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 20


class StragglerMonitor:
    def __init__(self, factor: float, window: int):
        self.factor = factor
        self.window = window
        self.times: List[float] = []
        self.events: List[Dict[str, Any]] = []

    def record(self, step: int, dt: float) -> bool:
        flagged = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                flagged = True
        self.times.append(dt)
        return flagged


class Trainer:
    """``Trainer(cfg, ocfg, tcfg, mesh, params, data_cfg, microbatches=1,
    on_straggler=None, device=None)``: the reference's signature.  With
    ``mesh`` None the parameters move to ``device`` (the card unless the
    caller names another); with a ``DeviceMesh`` to this rank's device of
    the mesh, sharded under ``param_specs``."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimConfig,
                 tcfg: TrainerConfig, mesh, params, data_cfg: DataConfig,
                 microbatches: int = 1,
                 on_straggler: Optional[Callable[[Dict[str, Any]],
                                                 None]] = None,
                 device=None):
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.step_fn = functools.partial(train_step, cfg, ocfg,
                                             microbatches)
        else:
            from ..launch.mesh import mesh_device
            self.device = mesh_device(mesh)
            self.step_fn = make_train_step(cfg, ocfg, mesh, params,
                                           microbatches, donate=False)
        self.pipeline = SyntheticPipeline(data_cfg, mesh, device=self.device)
        self.state = self._place(init_state(tree_map(
            lambda p: p.to(self.device), params)))
        self.saver = ckpt.AsyncCheckpointer(mesh)
        self.monitor = StragglerMonitor(tcfg.straggler_factor,
                                        tcfg.straggler_window)
        self.on_straggler = on_straggler
        self.metrics_log: List[Dict[str, float]] = []

    # -- checkpoint/restart ------------------------------------------------

    def _place(self, state):
        """A whole ``TrainState`` on the mesh (params and moments under
        ``param_specs``, the counters replicated); as it is without one."""
        if self.mesh is None:
            return state
        specs = sh.param_specs(state.params)
        put = lambda tree: sh.distribute_tree(self.mesh, tree, specs)
        rep = lambda t: sh.distribute(t, self.mesh, sh.P())
        return type(state)(
            params=put(state.params),
            opt=type(state.opt)(rep(state.opt.step), put(state.opt.m),
                                put(state.opt.v)),
            data_step=rep(state.data_step))

    def maybe_restore(self) -> int:
        """Every rank reads the newest valid checkpoint, if any."""
        path = ckpt.latest_valid(self.tcfg.ckpt_dir)
        if path is None:
            return 0
        like = convert.stack_train_state(sh.stand_ins(self.state), self.cfg)
        stacked, meta = ckpt.load(path, like, device=self.device)
        self.state = self._place(convert.unstack_train_state(stacked,
                                                             self.cfg))
        return int(meta["step"])

    def _save(self, step: int) -> None:
        path = ckpt.step_path(self.tcfg.ckpt_dir, step)
        self.saver.save(path, convert.stack_train_state(
            sh.full_tree(self.state), self.cfg),
            meta={"step": step, "arch": self.cfg.name})
        if self.mesh is None or ckpt.is_writer():
            self._gc(step)

    def _gc(self, newest: int) -> None:
        if not os.path.isdir(self.tcfg.ckpt_dir):
            return
        steps = sorted(
            int(n.split("_")[1].split(".")[0])
            for n in os.listdir(self.tcfg.ckpt_dir)
            if n.startswith("step_") and n.endswith(".ckpt"))
        for s in steps[:-self.tcfg.keep]:
            try:
                os.remove(ckpt.step_path(self.tcfg.ckpt_dir, s))
            except OSError:
                pass

    # -- main loop ----------------------------------------------------------

    def run(self, fail_at: Optional[int] = None,
            delay_at: Optional[int] = None) -> Dict[str, Any]:
        """Train to ``tcfg.steps``.  ``fail_at``/``delay_at`` are the test
        hooks: raise a simulated node failure / inject a straggler
        stall."""
        start = self.maybe_restore()
        for step in range(start, self.tcfg.steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            t0 = time.monotonic()
            if delay_at is not None and step == delay_at:
                time.sleep(0.25)   # injected straggler
            batch = self.pipeline.batch(int(sh.local(self.state.data_step)))
            self.state, m = self.step_fn(self.state, batch)
            loss = float(m["loss"])           # waits for the step
            dt = time.monotonic() - t0
            if self.monitor.record(step, dt) and self.on_straggler:
                self.on_straggler(self.monitor.events[-1])
            self.metrics_log.append(
                {"step": step, "loss": loss,
                 "grad_norm": float(m["grad_norm"]), "dt": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1)
        self.saver.wait()
        return {"final_loss": self.metrics_log[-1]["loss"],
                "stragglers": self.monitor.events,
                "steps_run": len(self.metrics_log)}
