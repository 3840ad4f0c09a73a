"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

#: the device an entry point runs on when the caller names none.
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device with no GPU present raises.

    The port never falls back to the CPU on its own: the plain PyTorch
    path runs only when the caller asks for ``device="cpu"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
