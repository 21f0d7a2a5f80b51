"""Packed-QKV attention entries (port of `flash_attn_qkvpacked` and
`flash_attn_varlen_qkvpacked` in `paddle_tpu/nn/functional/extra.py`;
nothing else of that file is ported)."""
from __future__ import annotations

from .flash_attention import flash_attn_unpadded, scaled_dot_product_attention

__all__ = ["flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True, name=None):
    """qkv (B, S, 3, H, D) -> (out (B, S, H, D), None) through
    `scaled_dot_product_attention`."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = scaled_dot_product_attention(q, k, v, None, dropout, causal,
                                       training)
    return out, None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """qkv (total_tokens, 3, H, D) -> `flash_attn_unpadded` on its three
    slices: (out (total_tokens, H, D), None)."""
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale, dropout,
                               causal, return_softmax, training=training)
