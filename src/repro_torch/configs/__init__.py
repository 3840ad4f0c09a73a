"""Architecture registry: the 10 assigned configs + input-shape sets.

A copy of ``repro.configs`` over the port's copy of ``models.config``.

``get_config(arch)`` returns the exact published config;
``get_config(arch, smoke=True)`` the reduced same-family smoke variant.
``SHAPES`` defines the per-arch input-shape cells of the assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.config import ModelConfig

from .nemotron_4_340b import CONFIG as _nemotron
from .granite_34b import CONFIG as _granite
from .gemma2_9b import CONFIG as _gemma2
from .smollm_360m import CONFIG as _smollm
from .recurrentgemma_9b import CONFIG as _rgemma
from .granite_moe_1b import CONFIG as _granite_moe
from .qwen3_moe_235b import CONFIG as _qwen3
from .chameleon_34b import CONFIG as _chameleon
from .rwkv6_3b import CONFIG as _rwkv6
from .whisper_small import CONFIG as _whisper

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _nemotron, _granite, _gemma2, _smollm, _rgemma,
        _granite_moe, _qwen3, _chameleon, _rwkv6, _whisper)
}

#: short aliases accepted by --arch
ALIASES = {
    "nemotron-4-340b": "nemotron-4-340b",
    "granite-34b": "granite-34b",
    "gemma2-9b": "gemma2-9b",
    "smollm-360m": "smollm-360m",
    "recurrentgemma-9b": "recurrentgemma-9b",
    "granite-moe-1b-a400m": "granite-moe-1b-a400m",
    "qwen3-moe-235b-a22b": "qwen3-moe-235b-a22b",
    "chameleon-34b": "chameleon-34b",
    "rwkv6-3b": "rwkv6-3b",
    "whisper-small": "whisper-small",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(ARCHS)}")
    cfg = ARCHS[key]
    return cfg.smoke() if smoke else cfg


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Optional[str]:
    """None if the (arch x shape) cell runs; else a skip reason (recorded in
    the roofline table per the assignment)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skipped per assignment: pure full-attention arch at 512k "
                "KV (needs sub-quadratic attention)")
    return None
