"""Meshes: ``torch.distributed`` device meshes, one process per device.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (SPMD: every rank runs the same program on its own
device).  A CUDA mesh talks over NCCL and a CPU mesh over gloo; a CUDA
mesh never falls back to gloo, and without NCCL it raises.

Single pod: (16, 16) = ("data", "model") — 256 devices.
Multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 devices.

When no process group exists, ``make_local_mesh`` starts a world of one
in this process (an in-memory ``HashStore``: no launcher, no
``MASTER_ADDR``); under ``torchrun`` (whose ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` are set) it joins the launcher's
world, one rank per process.  The caller ends a group that a mesh
function started with ``close()``.  Importing this module touches no
device and starts no group.
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

#: the backend of each device type's mesh.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(dev: torch.device) -> str:
    if dev.type not in BACKENDS:
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("repro_torch: a CUDA mesh needs NCCL, which this "
                           "PyTorch lacks; it never falls back to gloo")
    return BACKENDS[dev.type]


def _launched() -> bool:
    """Whether a launcher (``torchrun``) named this process's rank and
    world in its environment."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def _join(dev: torch.device) -> None:
    """Join the launcher's world, or start a world of one when there is
    none; check that an existing group speaks the backend of ``dev``."""
    backend = _backend(dev)
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            index = int(os.environ.get("LOCAL_RANK", dev.index or 0)) \
                if _launched() else dev.index or 0
            torch.cuda.set_device(index)
            kw["device_id"] = torch.device("cuda", index)
        if _launched():
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, **kw)
        return
    have = str(dist.get_backend())
    if backend not in have:
        raise RuntimeError(f"repro_torch: a {dev.type} mesh needs {backend}, "
                           f"the process group speaks {have}")


def make_mesh(shape: Sequence[int], axes: Tuple[str, ...],
              device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the world's ranks in rank
    order (the last axis minor).  The world must hold exactly
    ``prod(shape)`` ranks; with no process group, that is a world of
    one."""
    dev = resolve_device(device)
    if dev.type == "meta":
        raise ValueError("a mesh runs on 'cuda' or 'cpu', got meta")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    _join(dev)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: only a world of 256 or 512 ranks builds it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(axes: Tuple[str, ...] = ("data", "model"),
                    device=None) -> DeviceMesh:
    """Whatever ranks the world has, folded into the last of ``axes``
    (a world of one when no group exists).  ``device`` defaults to
    ``"cuda"`` and raises without a GPU."""
    dev = resolve_device(device)
    _join(dev)
    n = dist.get_world_size()
    return make_mesh([1] * (len(axes) - 1) + [n], axes, dev)


def mesh_devices(mesh) -> int:
    return int(math.prod(mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def close() -> None:
    """Destroy the default process group, if one exists (the end of a
    world that ``make_local_mesh`` or ``make_mesh`` started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
