"""Three-term roofline at the H100's rates, and the HLO collective parse.

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

A copy of ``repro.roofline.analysis`` with the card's hardware model in
place of the reference's.  ``Roofline`` takes per-device numbers: in the
port's dry run (``launch/dryrun.py``) they are rank 0's, counted over one
eagerly traced step (``count.py``: every layer is traced, nothing is
counted once for a loop).  ``analytic_roofline`` turns the closed-form
terms of ``analytic.py`` into times.  ``collective_bytes`` parses XLA HLO
text (pure text, no JAX) and sums the output-shape bytes of every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute (output shapes are per-device shard shapes: the bytes
that land on each device's links); ``count.py`` sums the port's
collectives by the same rule.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM5, 700 W), NVIDIA's data
sheet, dense rates without sparsity:
    PEAK_FLOPS  989 TFLOP/s bf16 on the tensor cores;
    HBM_BW      3.35 TB/s;
    LINK_BW     50 GB/s: a production mesh (256 or 512 devices) spans 32
                or 64 nodes of eight GPUs, and each of its 16-wide axes
                crosses nodes, so a device's collective traffic leaves
                through its own 400 Gb/s inter-node NIC.  Inside a node
                NVLink 4 gives 450 GB/s each way, which no axis of these
                meshes keeps to.
``Roofline`` and ``analytic_roofline`` read the three constants when they
are called, so a caller may substitute another card's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores / device
HBM_BW = 3.35e12           # bytes/s / device
LINK_BW = 50e9             # bytes/s / device: one 400 Gb/s NIC

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g. "  %ag = bf16[2,128,512]{2,1,0} all-gather(...)" and tuple shapes
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\)|\S+))\s+(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)(?:-start|-done)?\(")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-type output bytes summed over the module.  ``-start``
    variants are counted once (their ``-done`` pair is skipped)."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue  # counted at -start
        m = _OP_RE.search(line)
        if not m:
            continue
        out[m.group(2)] += _shape_bytes(m.group(1))
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    model_flops: float                 # 6*N*D (active N for MoE), GLOBAL
    peak_mem_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / the flops of all devices — how much of the
        counted compute is 'useful' (catches remat/redundancy waste)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_time(self) -> float:
        """Lower bound step time under perfect overlap: max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time — the reported 'fraction of
        roofline' (1.0 = the chip could do no better even at the bound)."""
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS
        rt = self.roofline_time
        return t_useful / rt if rt else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_per_device": self.peak_mem_per_device,
        }


def analytic_roofline(cfg, cell, mesh, **variant) -> dict:
    """First-principles three-term roofline (see ``analytic`` for the
    formula derivations).  ``variant`` kwargs (weight_bytes,
    kv_bytes_elem) parameterize what-ifs; ``mesh``: anything
    ``analytic.mesh_desc`` reads."""
    from .analytic import analytic_terms, mesh_desc
    md = mesh_desc(mesh)
    t = analytic_terms(cfg, cell, md, **variant)
    t_c = t["flops_global"] / md.chips / PEAK_FLOPS
    t_m = t["mem_bytes_dev"] / HBM_BW
    t_x = t["coll_bytes_dev"] / LINK_BW
    t_useful = t["model_flops_6nd"] / md.chips / PEAK_FLOPS
    bound = max(t_c, t_m, t_x)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return {
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
        "bottleneck": max(terms, key=terms.get),
        "roofline_fraction": t_useful / bound if bound else 0.0,
        "useful_flops_fraction": (t["model_flops_6nd"]
                                  / max(t["flops_global"], 1.0)),
        "flops_global": t["flops_global"],
        "mem_bytes_dev": t["mem_bytes_dev"],
        "coll_bytes_dev": t["coll_bytes_dev"],
        "model_flops_6nd": t["model_flops_6nd"],
        "chips": md.chips,
    }


def model_flops(cfg, cell) -> float:
    """6*N*D for training; 2*N*D for a forward-only cell (per the usual
    convention), with N = active params for MoE.  D = tokens processed."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * cell.global_batch
