"""Cross entropy (port of the single-device `ParallelCrossEntropy` of
`paddle_tpu/distributed/fleet/mpu.py`)."""
from __future__ import annotations

import torch

__all__ = ["parallel_cross_entropy"]


def parallel_cross_entropy(logits, label, ignore_index=-100):
    """Per-position softmax cross entropy, shape (..., 1): log_softmax
    in fp32 over the last axis, the label's entry negated; a label equal
    to `ignore_index` gives 0 (it is looked up at class 0, never out of
    range). `label` may carry a trailing axis of 1."""
    label = label.long()
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return loss[..., None]
