"""RMSNorm (port of `rms_norm` in `paddle_tpu/nn/functional/norm.py`)."""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             residual=None) -> torch.Tensor:
    """Normalise over the last axis in fp32, cast back to the input
    dtype, THEN multiply by the weight — the reference's rounding order
    (the product runs in the weight/input dtype, not in fp32)."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
