"""Default-device resolution for the port's entry points.

The card is the default: `resolve_device(None)` is `cuda`, and asking
for `cuda` when no card is present raises instead of silently running
on the CPU. Tests pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; anything else -> itself.
    Raises RuntimeError for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
