"""L1Decay / L2Decay (port of `paddle_tpu/regularizer.py`).

Regularizer objects are passed as `weight_decay=` to an optimizer:
L2Decay folds coeff * w into the gradient (coupled decay), L1Decay adds
coeff * sign(w). `apply` works on tensors: the parameter is cast to the
gradient's dtype first, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __float__(self):
        return self._coeff

    def apply(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """grad + coeff * sign(w)."""

    def apply(self, param, grad):
        return grad + self._coeff * torch.sign(param.to(grad.dtype))


class L2Decay(WeightDecayRegularizer):
    """grad + coeff * w."""

    def apply(self, param, grad):
        return grad + self._coeff * param.to(grad.dtype)
