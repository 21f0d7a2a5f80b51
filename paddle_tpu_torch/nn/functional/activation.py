"""Activations (port of `swiglu` in
`paddle_tpu/nn/functional/activation.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(x: torch.Tensor, y=None) -> torch.Tensor:
    """silu(x) * y; with y None, x is split in half along the last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y
