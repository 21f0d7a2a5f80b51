"""Linear and Embedding (port of `paddle_tpu/nn/layer/common.py`).

`Linear` stores its weight as (in, out) like Paddle, so state dicts
cross from the reference with no transpose. Both draw their initial
values from an explicit `torch.Generator` on the target device, so a
model is built straight on the card from a seed. Their parameters are
trainable; the serving engine runs its steps under inference mode.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """y = x @ W + b with W of shape (in, out). Initial W is Xavier
    uniform (the reference's default), b zero."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        w = torch.empty(in_features, out_features, device=device,
                        dtype=dtype)
        bound = math.sqrt(6.0 / (in_features + out_features))
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y + self.bias if self.bias is not None else y

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Row lookup; initial rows N(0, 1) (the reference's default)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids):
        return self.weight[ids]
