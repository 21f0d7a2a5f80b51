"""Gradient clipping (port of `paddle_tpu/nn/clip.py`).

The three classes take an optimizer's [(param, grad), ...] list and
return a new one; an optimizer applies its `grad_clip` before it touches
any accumulator, so the clip sees the raw gradients whatever the
optimizer stores (`moment_dtype`, `fused`). The two functions clip
`p.grad` of a parameter list in place.

The global norm sums each gradient's fp32 square sum one tensor at a
time, so at most one fp32 copy of a gradient lives at once; a clipped
gradient is `(g.float() * scale).to(g.dtype)`, rounded as the
reference rounds it.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]


def _square_sum(g):
    """sum(g^2) in fp32, a 0-dim tensor on g's device."""
    flat = g.reshape(-1).float()
    return torch.dot(flat, flat)


def _norm_scale(clip, total):
    """min(clip / max(total, 1e-6), 1) in total's dtype."""
    return torch.clamp(clip / torch.clamp(total, min=1e-6), max=1.0)


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        total = _square_sum(grads[0])
        for g in grads[1:]:
            total = total + _square_sum(g).to(total.device)
        scale = _norm_scale(self.clip_norm, torch.sqrt(total))
        return [(p, g if g is None else
                 (g.float() * scale.to(g.device)).to(g.dtype))
                for p, g in params_grads]


class ClipGradByNorm:
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            scale = _norm_scale(self.clip_norm, torch.sqrt(_square_sum(g)))
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


def _param_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every p.grad by min(max_norm / max(total, 1e-6), 1), where
    total is the norm_type norm over all gradients (fp32; the largest
    |g| in the gradients' dtype for inf). Returns total."""
    params = _param_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = _norm_scale(max_norm, total)
    for p in params:
        if p.grad is not None:
            g = p.grad
            dt = torch.promote_types(g.dtype, scale.dtype)
            p.grad = (g.to(dt) * scale).to(p.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every p.grad to [-clip_value, clip_value]."""
    for p in _param_list(parameters):
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)
