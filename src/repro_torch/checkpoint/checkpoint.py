"""Integrity-checked, resumable checkpoints in the reference's format.

The port of ``repro.checkpoint.checkpoint``.  One msgpack archive per
step::

    {"meta": {...}, "leaves": {key: {"shape", "dtype", "data",
     "sha256"}}, "manifest_sha": ...}

with the reference's keys (``tree.key``: a NamedTuple field as
``.name``, a dict key as itself, a list index as its number, joined by
``/``), the reference's dtype names (``"float32"``, ``"bfloat16"``,
``"int32"``, ...), a sha256 of each leaf's raw bytes and one over the
digests in key order.  ``data`` is a zstd frame: the port writes raw
blocks (``codec.zstd_frame``), and reads raw and RLE blocks itself, so
neither ``msgpack`` nor ``zstandard`` is needed to write or read a port
checkpoint; a reference checkpoint's compressed blocks go to
``zstandard``.  A checkpoint is written to ``<path>.tmp`` and renamed,
so a partial one is never visible; a corrupted one fails ``verify`` and
``latest_valid`` skips it.

``AsyncCheckpointer.save`` copies the tree to the host in the caller;
the framing, hashing and I/O run on a thread.

On a mesh (a tree with DTensor leaves, or an ``AsyncCheckpointer(mesh)``)
every rank gathers each DTensor's whole tensor, only rank 0 writes, and
every rank then passes a barrier (at the end of ``save``, or of the
``AsyncCheckpointer``'s ``wait``); the file holds full logical arrays,
the reference's format, whatever mesh wrote it.  ``load`` runs on every
rank.
"""
from __future__ import annotations

import hashlib
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..tree import key, leaves_with_path, tree_map, unflatten_like
from . import codec

#: torch dtypes by the reference's (numpy's) dtype names.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _host(leaf) -> torch.Tensor:
    """A leaf (tensor on any device, numpy array or scalar) as a
    contiguous CPU tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").contiguous()
    a = np.asarray(leaf)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":             # ml_dtypes, if present
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _snapshot(leaf) -> torch.Tensor:
    """A host copy of a leaf that later in-place updates do not touch (a
    DTensor's whole tensor, gathered: a collective)."""
    if isinstance(leaf, DTensor):
        return leaf.full_tensor().detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return _host(np.array(leaf, copy=True))


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of a contiguous CPU tensor, without a copy."""
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _archive(tree, meta) -> list:
    """The pieces of a checkpoint file of the (host) tree."""
    flat = {key(p): _host(leaf) for p, leaf in leaves_with_path(tree)}
    leaves = {}
    manifest = hashlib.sha256()
    for k in sorted(flat):
        t = flat[k]
        raw = _raw(t)
        digest = hashlib.sha256(raw).hexdigest()
        manifest.update(digest.encode())
        leaves[k] = {"shape": list(t.shape), "dtype": _NAMES[t.dtype],
                     "data": codec.zstd_frame(raw),
                     "sha256": digest}
    return codec.packb_parts({"meta": meta or {}, "leaves": leaves,
                              "manifest_sha": manifest.hexdigest()})


def _on_mesh(tree) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in
               leaves_with_path(tree))


def is_writer() -> bool:
    """Whether this process writes a mesh's checkpoint: rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(path: str, tree, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a checkpoint of ``tree`` atomically; the final path.  A tree
    with DTensor leaves is gathered on every rank, written by rank 0, and
    every rank returns after a barrier."""
    if _on_mesh(tree):
        host = tree_map(_snapshot, tree)
        if is_writer():
            _write(path, host, meta)
        dist.barrier()
        return path
    return _write(path, tree, meta)


def _write(path: str, tree, meta: Optional[Dict[str, Any]]) -> str:
    parts = _archive(tree, meta)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    return path


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return codec.unpackb(f.read())


def verify(path: str) -> bool:
    """Integrity check: every leaf's digest and the manifest's."""
    try:
        obj = _read(path)
        manifest = hashlib.sha256()
        for k in sorted(obj["leaves"]):
            rec = obj["leaves"][k]
            raw = codec.zstd_decode(rec["data"])
            if hashlib.sha256(raw).hexdigest() != rec["sha256"]:
                return False
            manifest.update(rec["sha256"].encode())
        return manifest.hexdigest() == obj["manifest_sha"]
    except Exception:
        return False


def _tensor(raw: bytes, rec: dict) -> torch.Tensor:
    dtype = DTYPES[rec["dtype"]]
    shape = tuple(rec["shape"])
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def load(path: str, tree_like, device=None) -> Tuple[Any, Dict[str, Any]]:
    """(the tree of ``tree_like``'s structure with the checkpoint's
    leaves as tensors on ``device``, the meta dict).  A leaf whose digest
    does not match raises ``IOError``; a missing one ``KeyError``."""
    dev = resolve_device(device)
    obj = _read(path)
    flat = {}
    for k, rec in obj["leaves"].items():
        raw = codec.zstd_decode(rec["data"])
        if hashlib.sha256(raw).hexdigest() != rec["sha256"]:
            raise IOError(f"checkpoint corruption in leaf '{k}'")
        flat[k] = _tensor(raw, rec)
    tree = unflatten_like(tree_like, flat)
    return tree_map(lambda t: t.to(dev), tree), obj["meta"]


_STEP_RE = re.compile(r"step_(\d+)\.ckpt$")


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.ckpt")


def latest_valid(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint that passes ``verify`` (a corrupted or
    partial one is skipped: the restart path after a failed save)."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.search(name)
        if m:
            cands.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    for _, path in sorted(cands, reverse=True):
        if verify(path):
            return path
    return None


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one save in flight).  A save
    that failed on the thread raises in the next ``wait`` (or ``save``).
    With a ``mesh`` (or a tree with DTensor leaves) every rank calls
    ``save`` and ``wait`` at the same points: ``save`` gathers on every
    rank, rank 0 alone writes, and ``wait`` ends in a barrier."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False
        self.last_path: Optional[str] = None

    def save(self, path: str, tree, meta=None) -> None:
        self.wait()
        self._barrier = self.mesh is not None or _on_mesh(tree)
        host = tree_map(_snapshot, tree)   # device -> host in the caller
        if self._barrier and not is_writer():
            return
        self._thread = threading.Thread(
            target=self._run, args=(path, host, meta), daemon=True)
        self._thread.start()

    def _run(self, path, host, meta):
        try:
            _write(path, host, meta)
        except BaseException as e:      # handed to the caller by wait()
            self._error = e
            return
        self.last_path = path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
