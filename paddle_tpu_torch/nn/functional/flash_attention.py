"""Attention functionals (port of
`paddle_tpu/nn/functional/flash_attention.py`): SDPA, `flash_attention`,
the packed-sequence `flash_attn_unpadded` and `flashmask_attention`.

`scaled_dot_product_attention` sends a call with no mask and no dropout
to `kernels.flash_attention.flash_attention_bshd`. On the card that is
every such call: the hand-written CUDA kernels mask ragged lengths, and
a head dim or dtype they do not take raises there. The one exception is
the caller's own: inside `sdp_kernel(enable_flash=False)` mask-free
calls go to `sdpa_ref` on both devices, as in the reference (which also
turns its packed entries below to their compositions there: not
ported, they keep their kernels). On the CPU the
dispatch is the reference's: the call goes to the flash entry (its plain
versions) only when its shapes pass the reference's TPU rules
(`check_supported`), else to `sdpa_ref`. A masked call goes to `sdpa_ref`
on both, the plain composition the serving prefill also runs with its
explicit mask. Dropout is not ported (it needs a counter-based generator
in the kernel). Layout (B, S, H, D).

`flash_attn_unpadded` (sequences packed along dim 0 by cu_seqlens) and
`flashmask_attention` (per-key-column row bounds, or a sliding
`window_size`) dispatch the same way: on the card every call goes to the
varlen / flashmask kernels, and a shape they refuse raises; on the CPU
the call goes to the flash entry (its plain versions) only when the
reference's `check_supported` (and, for flashmask, its bound-count rule)
passes, else to the reference's masked composition over `sdpa_ref`.
"""
from __future__ import annotations

import math

import torch

from ...kernels import flash_attention as flash

__all__ = ["sdpa_ref", "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flashmask_attention", "sdp_kernel"]

_USE_FLASH = [True]


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


def _refuse_dropout(p, training=True):
    if p > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported to "
                                  "paddle_tpu_torch (it needs a Philox "
                                  "generator in the kernel)")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """(B, S, H, D) attention: mask-free calls to the flash kernels on
    the card; the reference's dispatch on the CPU."""
    _refuse_dropout(dropout_p, training)
    if attn_mask is None and dropout_p == 0.0 and _USE_FLASH[0]:
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


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """(B, S, H, D) attention through `scaled_dot_product_attention`.
    Returns (out, None): the softmax is never materialised."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _segment_ids_from_cu(cu, total):
    """cu_seqlens (B+1,) prefix sums -> per-token segment ids (total,)
    int32; tokens past cu[-1] form a segment of their own (id B)."""
    pos = torch.arange(total, device=cu.device)
    return torch.searchsorted(cu[1:].to(pos.dtype), pos,
                              right=True).to(torch.int32)


def _seg_pos(cq, ck, total_q, total_k):
    """Segment ids of both sides and per-sequence causal positions; the
    query's shifted by its sequence's k_len - q_len, so causal means
    key pos <= query pos + len_diff (the reference's `_seg_pos`; an
    index past the end is clipped, as jnp.take's mode="clip")."""
    segq = _segment_ids_from_cu(cq, total_q)
    segk = _segment_ids_from_cu(ck, total_k)

    def take(x, i):
        return x[i.long().clamp(0, x.shape[0] - 1)]
    pq = torch.arange(total_q, device=cq.device) - take(cq, segq)
    pk = torch.arange(total_k, device=ck.device) - take(ck, segk)
    ldiff = take(torch.diff(ck), segq) - take(torch.diff(cq), segq)
    return segq, segk, (pq + ldiff).to(torch.int32), pk.to(torch.int32)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Packed (varlen) attention: query (total_q, H, D), key/value
    (total_k, H, D), sequences packed along dim 0 by cu_seqlens_* (B+1,)
    int32 prefix sums. Returns (out (total_q, H, D), None). Causal is
    per sequence and bottom-right aligned within it."""
    _refuse_dropout(dropout, training)
    total_q, H, D = query.shape
    total_k = key.shape[0]
    cq = cu_seqlens_q.to(query.device)
    ck = cu_seqlens_k.to(query.device)
    segq, segk, pq, pk = _seg_pos(cq, ck, total_q, total_k)
    # dropout > 0 outside training sends the reference to its composition
    if query.is_cuda or (dropout == 0.0 and _flash_ok(
            (1, total_q, H, D), (1, total_k, H, D), query.dtype)):
        out = flash.flash_attention_varlen_bshd(
            query[None], key[None], value[None], segq[None], segk[None],
            causal=causal, sm_scale=scale, q_positions=pq[None],
            kv_positions=pk[None])[0]
        return out, None
    allow = segq[:, None] == segk[None, :]
    if causal:
        allow = allow & (pk[None, :] <= pq[:, None])
    out = sdpa_ref(query[None], key[None], value[None], allow[None, None],
                   scale=scale)[0]
    return out, None


def _flash_ok(q_shape, k_shape, dtype, bounds=None, causal=True):
    """The reference's CPU dispatch: `check_supported`, and for flashmask
    bounds (B, Hm, Sk, C) what its kernel entry takes (Hm 1 or H; C 1|2
    causal, 2|4 non-causal) — a ValueError there sends the reference to
    its composition."""
    try:
        flash.check_supported(q_shape, k_shape, dtype)
    except ValueError:
        return False
    return bounds is None or (
        bounds[1] in (1, q_shape[2])
        and bounds[3] in ((1, 2) if causal else (2, 4)))


def _window_bounds(window_size, b, sk, causal, device):
    """A sliding window as flashmask bounds: causal (left w) masks key
    column c for rows >= c + w + 1 (C 1); non-causal (left, right) for
    rows >= c + left + 1 or rows < c - right (C 2). (b, 1, sk, C)."""
    w = window_size if isinstance(window_size, (tuple, list)) \
        else (window_size, window_size)
    cols = torch.arange(sk, device=device)
    start = torch.clamp(cols + int(w[0]) + 1, max=sk).to(torch.int32)
    if causal:
        idx = start[None, None, :, None]
        return idx.expand(b, 1, sk, 1)
    end = torch.clamp(cols - int(w[1]), min=0).to(torch.int32)
    return torch.stack([start, end], dim=-1)[None, None].expand(b, 1, sk, 2)


def _build_mask(idx, sq, sk, causal):
    """The reference's dense flashmask composition: (B, Hm, Sk, C)
    bounds -> (B, Hm, Sq, Sk) bool, True where a score is kept."""
    rows = torch.arange(sq, device=idx.device)[None, None, :, None]
    c = idx.shape[-1]
    b = [idx[..., i][:, :, None, :] for i in range(c)]
    if causal:
        masked = rows >= b[0] if c == 1 else (rows >= b[0]) & (rows < b[1])
        cm = torch.ones(sq, sk, dtype=torch.bool, device=idx.device).tril()
        return cm[None, None] & ~masked
    if c == 2:
        masked = (rows >= b[0]) | (rows < b[1])
    else:
        masked = ((rows >= b[0]) & (rows < b[1])) | \
                 ((rows >= b[2]) & (rows < b[3]))
    return ~masked


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=True, window_size=None,
                        name=None):
    """Flashmask attention, (B, S, H, D): startend_row_indices
    (B, 1|H, Sk, C) int32 row bounds per key column (C 1|2 causal, 2|4
    non-causal), or a sliding `window_size` (w or (left, right))
    translated to bounds. Neither given: plain (causal) SDPA."""
    _refuse_dropout(dropout)
    if window_size is not None:
        if startend_row_indices is not None:
            raise ValueError(
                "pass either window_size or startend_row_indices, not both")
        startend_row_indices = _window_bounds(
            window_size, query.shape[0], key.shape[1], causal, query.device)
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal)
    B, Sq, H, D = query.shape
    if Sq != key.shape[1]:
        raise ValueError("flashmask_attention requires Sq == Sk (row bounds "
                         "index a square score matrix)")
    idx = startend_row_indices.to(query.device)
    if query.is_cuda or _flash_ok(tuple(query.shape), tuple(key.shape),
                                  query.dtype, tuple(idx.shape), causal):
        return flash.flashmask_attention_bshd(query, key, value, idx,
                                              causal=causal)
    return sdpa_ref(query, key, value, _build_mask(idx, Sq, key.shape[1],
                                                   causal))


class sdp_kernel:
    """Context manager choosing SDPA's kernel: enable_flash=False sends
    every mask-free `scaled_dot_product_attention` call inside it to
    `sdpa_ref`, on the card too. `enable_math` and
    `enable_mem_efficient` are accepted and change nothing, as in the
    reference."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self.enable_flash = enable_flash
        self._prev = None

    def __enter__(self):
        self._prev = _USE_FLASH[0]
        _USE_FLASH[0] = bool(self.enable_flash)
        return self

    def __exit__(self, *exc):
        _USE_FLASH[0] = self._prev
        return False
