"""Plain attention composition (port of `_sdpa_ref` in
`paddle_tpu/nn/functional/flash_attention.py`).

The serving prefill passes an explicit boolean mask, so the reference
never reaches its flash kernel there; this composition is what it runs.
The flash kernels themselves are not ported yet.
"""
from __future__ import annotations

import math

import torch

__all__ = ["sdpa_ref"]


def sdpa_ref(q, k, v, mask=None, scale=None):
    """(B, S, H, D) attention in the reference's rounding order: scores
    as a product in q's dtype times the scale, then fp32; a boolean mask
    sets excluded scores to -inf (a float mask is added); softmax in
    fp32; probabilities cast to q's dtype BEFORE the PV product.
    K/V carry as many heads as q (repeat KV heads beforehand)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # B,H,S,D
    scores = (torch.matmul(qt, kt.transpose(-1, -2)) * scale).float()
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)          # B,S,H,D
