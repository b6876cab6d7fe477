"""Device selection for the port's entry points.

The default device is the card. The CPU is taken only when the caller asks
for it, and a missing card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` only when asked; raise if CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepaco_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
