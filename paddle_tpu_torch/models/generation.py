"""Token sampling (port of `_filter_logits` / `_sample_arr` in
`paddle_tpu/models/generation.py`).

Greedy is argmax. With temperature > 0 the draw is Gumbel-max over the
filtered logits, fed with noise the CALLER drew beforehand from an
explicit `torch.Generator` (`sample_noise`) — so a launch that is
retried after a transient failure replays bit-identically. The noise
stream is not JAX's: sampled tokens match the reference in
distribution, not bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["sample_noise", "_filter_logits", "_sample"]


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature + top-k + top-p (nucleus) filtering over the last
    axis; leading axes are batched. Returns float32 filtered logits
    (masked-out entries at -inf)."""
    lg = logits.float() / temperature
    V = lg.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest logit still inside the nucleus
        keep = (cum - probs) < top_p
        kth = torch.where(keep, sorted_lg,
                          torch.full_like(sorted_lg, float("inf")))
        kth = kth.amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def sample_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape` from `generator` (float32)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, temperature, top_k, top_p, noise=None):
    """(B, V) logits -> (B,) int64 token ids. `noise` (Gumbel, (B, V))
    is required when temperature > 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs pre-drawn "
                         "noise (sample_noise)")
    lg = _filter_logits(logits, temperature, top_k, top_p)
    return torch.argmax(lg + noise, dim=-1)
