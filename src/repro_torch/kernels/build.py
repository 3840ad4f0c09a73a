"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/`` at the root of the
checkout, named by a hash of its source, the ``.cuh`` headers beside it
and the flags, so an edited source or header rebuilds and an unchanged
one is loaded as it is.  The library is loaded
with ``ctypes``; nothing here runs when the module is imported.
``Library`` binds a source's C entry points and launches them on
PyTorch's current stream, counting the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

from ..spans import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build outputs live in the checkout (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def refuse_dtensor(name: str, *args) -> None:
    """Raise if an argument is a DTensor (``launch.sharding``): a kernel
    would read only this rank's block of it.  The caller passes its whole
    tensor (``full_tensor()``) or its block (``to_local()``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(a, DTensor) for a in args):
        raise TypeError(f"{name}: a DTensor argument; pass its whole tensor "
                        f"(full_tensor()) or this rank's block (to_local())")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use on a machine with the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-addressed)."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(name: str, verbose: bool = False, log=print) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; with
    ``verbose``, pass ptxas's report (registers, shared memory, spills per
    kernel) to ``log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        log(proc.stderr)
    os.replace(tmp, out)     # atomic: a concurrent build sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


class Library:
    """The C entry points of ``csrc/<name>.cu``: ``sigs`` maps each symbol
    to its ``argtypes`` before the stream, which every entry point takes
    last; each returns ``cudaGetLastError()``.  Built and bound at the
    first launch.  ``launches[kernel]`` counts the launches of each of
    ``kernels``, and ``symbol_launches[sym]`` those of each entry point,
    which tells apart the entry points that one kernel name covers."""

    def __init__(self, name: str, sigs: Dict[str, Tuple],
                 kernels: Iterable[str]):
        self.name, self.sigs = name, sigs
        self.launches: Dict[str, int] = dict.fromkeys(kernels, 0)
        self.symbol_launches: Dict[str, int] = dict.fromkeys(sigs, 0)
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    def reset_launches(self) -> None:
        for counts in (self.launches, self.symbol_launches):
            for k in counts:
                counts[k] = 0

    def call(self, sym: str, *args) -> int:
        """Call ``sym`` with ``args`` and the current stream, binding the
        library at the first call; the entry point's error code."""
        import torch
        if not self._fns:
            with span("kernels.load"):
                lib = load(self.name)
            for s, argtypes in self.sigs.items():
                fn = getattr(lib, s)
                fn.argtypes = tuple(argtypes) + (ctypes.c_void_p,)
                fn.restype = ctypes.c_int
                self._fns[s] = fn
        return self._fns[sym](*args, torch.cuda.current_stream().cuda_stream)

    def launch(self, kernel: str, sym: str, *args) -> None:
        """Call ``sym`` with ``args`` and the current stream; raise if the
        launch failed, else count one launch of ``kernel`` and of ``sym``."""
        err = self.call(sym, *args)
        if err != 0:
            raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                               f"{err}")
        self.launches[kernel] += 1
        self.symbol_launches[sym] += 1
