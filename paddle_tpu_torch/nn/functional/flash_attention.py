"""Attention functionals (port of
`paddle_tpu/nn/functional/flash_attention.py`).

`scaled_dot_product_attention` sends a call with no mask and no dropout
to `kernels.flash_attention.flash_attention_bshd`. On the card that is
every such call: the hand-written CUDA kernels mask ragged lengths, and
a head dim or dtype they do not take raises there. On the CPU the
dispatch is the reference's: the call goes to the flash entry (its plain
versions) only when its shapes pass the reference's TPU rules
(`check_supported`), else to `sdpa_ref`. A masked call goes to `sdpa_ref`
on both, the plain composition the serving prefill also runs with its
explicit mask. Dropout is not ported (it needs a counter-based generator
in the kernel). Layout (B, S, H, D).
"""
from __future__ import annotations

import math

import torch

from ...kernels import flash_attention as flash

__all__ = ["sdpa_ref", "scaled_dot_product_attention"]


def sdpa_ref(q, k, v, mask=None, scale=None, causal=False):
    """(B, S, H, D) attention in the reference's rounding order: scores
    as a product in q's dtype times the scale, then fp32; `causal` masks
    key j > i + Sk - Sq (bottom-right aligned) to -inf; a boolean mask
    sets excluded scores to -inf (a float mask is added); softmax in
    fp32; probabilities cast to q's dtype BEFORE the PV product.
    K/V carry as many heads as q (repeat KV heads beforehand)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # B,H,S,D
    scores = (torch.matmul(qt, kt.transpose(-1, -2)) * scale).float()
    if causal:
        sq, sk = scores.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)          # B,S,H,D


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """(B, S, H, D) attention: mask-free calls to the flash kernels on
    the card; the reference's dispatch on the CPU."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported to "
                                  "paddle_tpu_torch (it needs a Philox "
                                  "generator in the kernel)")
    if attn_mask is None and dropout_p == 0.0:
        if query.is_cuda:
            return flash.flash_attention_bshd(query, key, value,
                                              causal=is_causal)
        try:
            flash.check_supported(tuple(query.shape), tuple(key.shape),
                                  query.dtype)
        except ValueError:
            pass     # unsupported shape: the plain composition below
        else:
            return flash.flash_attention_bshd(query, key, value,
                                              causal=is_causal)
    return sdpa_ref(query, key, value, attn_mask, causal=is_causal)
