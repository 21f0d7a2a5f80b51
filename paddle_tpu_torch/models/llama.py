"""Llama-family decoder LM (port of `paddle_tpu/models/llama.py`).

Ported: the configs, the rope tables, interleaved-pair rotary, the
training forward (`LlamaForCausalLM.forward(input_ids, labels)`: causal
attention through the flash kernels, then the shifted, masked-mean
cross entropy), with `LlamaConfig.recompute` (one non-reentrant
`torch.utils.checkpoint` per decoder layer: the flash forward replays
inside the backward); the KV-cache forward and `generate` (greedy or
sampled; `use_jit=True` runs `models/generation.py::jit_generate` over a
preallocated cache); and the paged decode / chunked-prefill forward
passes the serving engine runs (over full-width or int8 KV pages), with
tied or untied heads and the multi-LoRA projection hooks (`_lora`:
q/k/v of every pass, o of the paged passes, gate/up/down of the MLP);
the multi-step decode launch (`forward_paged_decode_multi`: K decode
steps with sampling and per-row freeze masks on the card, no host sync
inside) and the speculative verify forward (`forward_paged_verify`:
1 + K tokens a row, logits at every position, attention over the
gathered paged prefix as in the chunked prefill).
Tensor-parallel serving: `LlamaForCausalLM.shard_(mesh)` keeps, in
place, this rank's shard of every split weight (`distributed.fleet.mpu`:
q/k/v and gate/up column-parallel, o and down row-parallel, the
embedding and the head vocab-parallel, the head's logits gathered so
every rank samples the same token); attention runs over the rank's
H/tp query and KVH/tp KV heads (decode through
`paged_attention_decode_tp`, prefill and verify over the rank's pages).
With no mesh the model is unchanged: no collective, no extra copy.
Not ported (they raise): sequence parallelism and the pipeline model.

The KV-cache forward takes per-layer (k, v) caches of (B, S, KVH, D),
in one of two modes. Concatenated (`caches` alone, eager `generate`):
the new K/V are appended, the rope rows start at the cache's length,
and the result is the new cache. Fixed buffer (`caches` with
`cache_pos`, `jit_generate`): K/V are written in place at `cache_pos`
and the attention reads the written prefix `[:cache_pos + S]`, the
reference's mask `kpos <= cache_pos + i` over the whole buffer being
exactly bottom-right causal attention over that prefix. Either way the
KV heads are repeated after the cache and the attention is causal when
S > 1, so on the card every pass goes through the flash kernel.

Parameters keep the reference's names and layouts (`Linear` weights are
(in, out)), so `models/convert.py` moves a reference state dict across
with no transpose. The constructor builds every weight directly on the
target device (the card by default) from an explicit `torch.Generator`.

Rounding note: the reference rotates q/k in fp32 and, for a bf16
model, carries the fp32 result onward (bf16 * fp32 promotes). The port
rotates in fp32 too but casts back to the model dtype, so a bf16 model
runs bf16 activations end to end; at fp32 the two are the same. For the
same reason `generate`'s caches hold the model dtype, where the
reference's eager caches start as fp32 zeros and promote a bf16 model's
attention to fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.mpu import (ColumnParallelLinear,
                                     RowParallelLinear,
                                     VocabParallelEmbedding)
from ..distributed.fleet.utils import recompute
from ..kernels.paged_attention import (paged_attention_decode,
                                       paged_attention_decode_tp,
                                       paged_cache_write,
                                       paged_cache_write_range,
                                       paged_cache_write_span)
from ..nn import Embedding, Linear, RMSNorm
from ..nn.functional import (parallel_cross_entropy,
                             scaled_dot_product_attention, sdpa_ref, swiglu)
from . import generation

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_3_8b", "llama_step_flops", "apply_rotary",
           "apply_rotary_positions", "apply_rotary_spans"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_bias: bool = False
    sequence_parallel: bool = False
    recompute: bool = False
    dtype: str = "float32"


def llama_tiny(**kw):
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128)
    cfg.update(kw)
    return LlamaConfig(**cfg)


def llama_3_8b(**kw):
    cfg = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=8192,
               rope_theta=500000.0)
    cfg.update(kw)
    return LlamaConfig(**cfg)


def llama_step_flops(cfg, batch, seq):
    """Training FLOPs of one step (the reference's bench.py reckoning):
    6 * N_matmul * tokens for forward and backward, plus attention
    12 * L * batch * seq^2 * hidden. The embedding lookup does no matmul;
    the LM head's does. Returns (flops, n_params, attention flops)."""
    kv = cfg.num_key_value_heads * cfg.hidden_size // cfg.num_attention_heads
    n_matmul = (cfg.vocab_size * cfg.hidden_size
                + cfg.num_hidden_layers * (
                    2 * cfg.hidden_size * cfg.hidden_size
                    + 2 * cfg.hidden_size * kv
                    + 3 * cfg.hidden_size * cfg.intermediate_size))
    n_params = n_matmul + (0 if cfg.tie_word_embeddings
                           else cfg.vocab_size * cfg.hidden_size)
    tokens = batch * seq
    attn = 12.0 * cfg.num_hidden_layers * batch * seq * seq * cfg.hidden_size
    return 6.0 * n_matmul * tokens + attn, n_params, attn


def _rope_cache(head_dim, max_pos, theta, device=None):
    """fp32 (cos, sin) tables of shape (max_pos, head_dim/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def _rotate(x, c, s):
    """Rotate interleaved (even, odd) pairs of x's last axis by (c, s),
    broadcast against the (..., D/2) pair view; math in fp32."""
    xr = x.float().unflatten(-1, (-1, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.flatten(-2).to(x.dtype)


def apply_rotary(x, cos, sin):
    """x (B, S, H, D); cos/sin (S, D/2) — GPT-J/Llama interleaved pairs."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def apply_rotary_positions(x, cos_b, sin_b):
    """x (B, 1, H, D); cos_b/sin_b (B, D/2) at each row's own position."""
    return _rotate(x, cos_b[:, None, None, :], sin_b[:, None, None, :])


def apply_rotary_spans(x, cos_bs, sin_bs):
    """x (B, S, H, D); cos_bs/sin_bs (B, S, D/2) at each row's own span
    of positions (the verify step: 1 + K tokens a row, each row at its
    own offset)."""
    return _rotate(x, cos_bs[:, :, None, :], sin_bs[:, :, None, :])


def _split_kv(kv):
    """A layer's paged cache tuple -> (k, v, k_scale|None, v_scale|None):
    (k, v) full width, or the quantized (k, v, k_scale, v_scale) with
    int8 value pages and fp32 per-slot scales."""
    k, v, *scales = kv
    ks, vs = scales if scales else (None, None)
    return k, v, ks, vs


def _gather_kv(cache, bt, n_kv, hd, b, scale=None, cdt=None):
    """A block table's pages as the dense (b, S, KVH, D) view; int8
    caches dequantize during the gather (values times their per-slot
    scales in fp32, then a cast to the compute dtype `cdt`)."""
    idx = bt.long()
    g = cache[idx]                            # (..., P, KVH, page, D)
    if scale is not None:
        g = g.float() * scale[idx][..., None]
    g = g.transpose(bt.dim(), bt.dim() + 1)   # (..., P, page, KVH, D)
    g = g.reshape(b, -1, n_kv, hd)
    return g.to(cdt) if scale is not None else g


_apply_lora = None


def _lora(name, x, y):
    """Multi-LoRA serving hook: adds the active launch scope's per-row
    adapter delta to a projection output. With no scope active
    (training, lora-less serving) it returns `y` itself, at the cost of
    one thread-local read. `apply_lora` is resolved on the first call:
    the serving package imports this module, so it cannot be imported
    at the top."""
    global _apply_lora
    if _apply_lora is None:
        from ..serving.lora.runtime import apply_lora
        _apply_lora = apply_lora
    return _apply_lora(name, x, y)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        self.head_dim = h // config.num_attention_heads
        self.n_heads = config.num_attention_heads
        self.n_kv = config.num_key_value_heads
        kw = dict(bias=config.use_bias, device=device, dtype=dtype,
                  generator=generator)
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, self.n_kv * self.head_dim, **kw)
        self.v_proj = Linear(h, self.n_kv * self.head_dim, **kw)
        self.o_proj = Linear(h, h, **kw)
        self.mesh = None

    def shard_(self, mesh):
        """Keep this rank's heads: q/k/v column-parallel (H/tp and
        KVH/tp heads, so G is the same on every rank), o_proj
        row-parallel over them."""
        for name in ("q_proj", "k_proj", "v_proj"):
            full = getattr(self, name)
            setattr(self, name, ColumnParallelLinear(
                full.in_features, full.out_features, gather_output=False,
                mesh=mesh, full=full))
        self.o_proj = RowParallelLinear(
            self.o_proj.in_features, self.o_proj.out_features,
            input_is_parallel=True, mesh=mesh, full=self.o_proj)
        self.n_heads //= mesh.tp
        self.n_kv //= mesh.tp
        self.mesh = mesh

    def _qkv(self, x):
        """q, k, v of x (B, S, hidden), each through the LoRA hook."""
        b, s, _ = x.shape
        q = _lora("q_proj", x, self.q_proj(x))
        k = _lora("k_proj", x, self.k_proj(x))
        v = _lora("v_proj", x, self.v_proj(x))
        return (q.view(b, s, self.n_heads, self.head_dim),
                k.view(b, s, self.n_kv, self.head_dim),
                v.view(b, s, self.n_kv, self.head_dim))

    def forward(self, x, cos, sin, cache=None, cache_pos=None):
        """Full-sequence or KV-cache forward: x (B, S, hidden), cos/sin
        (S, D/2) at the tokens' positions. With `cache` (k, v) of
        (B, P, KVH, D): appended to (concatenated mode) or, with
        `cache_pos`, written in place at cache_pos (fixed buffer). KV
        heads are repeated to the query heads after the cache (autograd
        sums the gradient over the copies); the attention is causal,
        bottom-right aligned, whenever S > 1. Returns out, or (out,
        cache) with a cache."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if cache is not None and cache_pos is not None:
            pk, pv = cache
            pos = int(cache_pos)
            pk[:, pos:pos + s] = k
            pv[:, pos:pos + s] = v
            k, v = pk[:, :pos + s], pv[:, :pos + s]
        elif cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = scaled_dot_product_attention(q, k, v, is_causal=(s > 1))
        out = self.o_proj(out.reshape(b, s, self.n_heads * self.head_dim))
        return out if cache is None else (out, cache)

    def forward_paged(self, x, cos_b, sin_b, kv, block_tables, seq_lens):
        """One decode step over the paged KV cache. x (B, 1, hidden);
        cos_b/sin_b (B, D/2) at each row's position; kv = (k_cache,
        v_cache), or (k, v, k_scale, v_scale) for int8 KV; seq_lens (B,)
        INCLUDING the token being decoded. Writes the token's K/V at
        seq_lens-1 (quantized on write for int8), then attends through
        the paged-decode kernel. Returns (out, kv)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q = apply_rotary_positions(q, cos_b, sin_b)
        k = apply_rotary_positions(k, cos_b, sin_b)
        kc, vc, ks, vs = _split_kv(kv)
        paged_cache_write(kc, vc, k[:, 0], v[:, 0], block_tables,
                          seq_lens - 1, k_scale=ks, v_scale=vs)
        q = q.reshape(b, self.n_heads, self.head_dim)
        if self.mesh is None:
            out = paged_attention_decode(q, kc, vc, block_tables, seq_lens,
                                         k_scale=ks, v_scale=vs)
        else:
            out = paged_attention_decode_tp(q, kc, vc, block_tables,
                                            seq_lens, self.mesh, k_scale=ks,
                                            v_scale=vs)
        out = out.reshape(b, s, self.n_heads * self.head_dim)
        return _lora("o_proj", out, self.o_proj(out)), kv

    def forward_paged_prefill(self, x, cos_c, sin_c, kv, block_table,
                              cache_len, chunk_len):
        """One prompt CHUNK over the paged cache. x (1, S, hidden) holds
        tokens at positions cache_len..cache_len+S-1, the first
        chunk_len live; cos_c/sin_c (S, D/2) are the rope rows at those
        positions; block_table (P,) the sequence's page ids; kv as in
        `forward_paged`. Writes the chunk's K/V (quantized on write for
        int8), then attends over the gathered pages (cached prefix plus
        the chunk, dequantized during the gather for int8) under the
        mask kpos <= cache_len + i — the bottom-right-aligned causal mask
        written out, never a top-left `is_causal`. Returns (out, kv)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q = apply_rotary(q, cos_c, sin_c)
        k = apply_rotary(k, cos_c, sin_c)
        kc, vc, ks, vs = _split_kv(kv)
        paged_cache_write_range(kc, vc, k[0], v[0], block_table, chunk_len,
                                cache_len, k_scale=ks, v_scale=vs)
        kd = _gather_kv(kc, block_table, self.n_kv, self.head_dim, 1,
                        scale=ks, cdt=q.dtype)
        vd = _gather_kv(vc, block_table, self.n_kv, self.head_dim, 1,
                        scale=vs, cdt=q.dtype)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            kd = kd.repeat_interleave(rep, dim=2)
            vd = vd.repeat_interleave(rep, dim=2)
        sk = kd.shape[1]
        qpos = cache_len + torch.arange(s, device=x.device)
        kpos = torch.arange(sk, device=x.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None]
        out = sdpa_ref(q, kd, vd, mask)
        out = out.reshape(b, s, self.n_heads * self.head_dim)
        return _lora("o_proj", out, self.o_proj(out)), kv

    def forward_paged_verify(self, x, cos_bs, sin_bs, kv, block_tables,
                             seq_lens, draft_lens):
        """One speculative VERIFY step: each row scores 1 + K tokens (its
        last emitted token and K drafts) against its own paged prefix.
        x (B, S, hidden): row b's tokens at positions seq_lens[b]-1
        onward, the first 1 + draft_lens[b] live (the rest K-bucket
        padding); cos_bs/sin_bs (B, S, D/2) the rope rows there;
        block_tables (B, P); seq_lens (B,) counts through the FIRST
        input token (the `forward_paged` convention). Writes every live
        position's K/V (`paged_cache_write_span`, idempotent at
        seq_lens-1; quantized on write for int8), then attends over the
        gathered pages (dequantized in the gather for int8), KV heads
        repeated as in the prefill, under the mask kpos <= (seq_lens-1)
        + j. A pad row's seq_len 0 would mask its whole first row; its
        query positions are clamped at 0 so it stays finite (its output
        is discarded). Returns (out, kv)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        q = apply_rotary_spans(q, cos_bs, sin_bs)
        k = apply_rotary_spans(k, cos_bs, sin_bs)
        kc, vc, ks, vs = _split_kv(kv)
        paged_cache_write_span(kc, vc, k, v, block_tables, draft_lens + 1,
                               seq_lens - 1, k_scale=ks, v_scale=vs)
        kd = _gather_kv(kc, block_tables, self.n_kv, self.head_dim, b,
                        scale=ks, cdt=q.dtype)
        vd = _gather_kv(vc, block_tables, self.n_kv, self.head_dim, b,
                        scale=vs, cdt=q.dtype)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            kd = kd.repeat_interleave(rep, dim=2)
            vd = vd.repeat_interleave(rep, dim=2)
        sk = kd.shape[1]
        qpos = (seq_lens.long()[:, None] - 1
                + torch.arange(s, device=x.device)[None, :]).clamp_min(0)
        kpos = torch.arange(sk, device=x.device)
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        out = sdpa_ref(q, kd, vd, mask)
        out = out.reshape(b, s, self.n_heads * self.head_dim)
        return _lora("o_proj", out, self.o_proj(out)), kv


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(bias=config.use_bias, device=device, dtype=dtype,
                  generator=generator)
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def shard_(self, mesh):
        """gate/up column-parallel over the intermediate dim, down
        row-parallel over it (float or quantized whole)."""
        for name in ("gate_proj", "up_proj"):
            full = getattr(self, name)
            setattr(self, name, ColumnParallelLinear(
                full.in_features, full.out_features, gather_output=False,
                mesh=mesh, full=full))
        full = self.down_proj
        self.down_proj = RowParallelLinear(
            full.in_features, full.out_features, input_is_parallel=True,
            mesh=mesh, full=full)

    def forward(self, x):
        h = swiglu(_lora("gate_proj", x, self.gate_proj(x)),
                   _lora("up_proj", x, self.up_proj(x)))
        return _lora("down_proj", h, self.down_proj(h))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, generator=generator, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, generator=generator, **kw)

    def forward(self, x, cos, sin, cache=None, cache_pos=None):
        h = self.input_layernorm(x)
        if cache is None:
            attn = self.self_attn(h, cos, sin)
        else:
            attn, cache = self.self_attn(h, cos, sin, cache, cache_pos)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if cache is None else (x, cache)

    def forward_paged(self, x, cos_b, sin_b, kv, block_tables, seq_lens):
        attn, kv = self.self_attn.forward_paged(
            self.input_layernorm(x), cos_b, sin_b, kv, block_tables,
            seq_lens)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, kv

    def forward_paged_prefill(self, x, cos_c, sin_c, kv, block_table,
                              cache_len, chunk_len):
        attn, kv = self.self_attn.forward_paged_prefill(
            self.input_layernorm(x), cos_c, sin_c, kv, block_table,
            cache_len, chunk_len)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, kv

    def forward_paged_verify(self, x, cos_bs, sin_bs, kv, block_tables,
                             seq_lens, draft_lens):
        attn, kv = self.self_attn.forward_paged_verify(
            self.input_layernorm(x), cos_bs, sin_bs, kv, block_tables,
            seq_lens, draft_lens)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, kv


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      generator=generator, **kw)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, generator=generator, **kw)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)
        cos, sin = _rope_cache(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, caches=None, cache_pos=None):
        """input_ids (B, S) -> final-norm hidden states (B, S, hidden),
        from position 0, or with per-layer `caches` from the cache's
        length (concatenated) or `cache_pos` (fixed buffer; see the
        module docstring), then (hidden, new caches). Under
        `recompute` each decoder layer of a forward that records
        gradients is checkpointed."""
        if self.cfg.sequence_parallel:
            raise NotImplementedError("LlamaConfig.sequence_parallel=True "
                                      "is not ported to paddle_tpu_torch")
        s = input_ids.shape[1]
        if cache_pos is not None:
            past = int(cache_pos)
        else:
            past = caches[0][0].shape[1] if caches is not None else 0
        cos = self.rope_cos[past:past + s]
        sin = self.rope_sin[past:past + s]
        x = self.embed_tokens(input_ids)
        if caches is not None:
            new_caches = []
            for layer, cache in zip(self.layers, caches):
                x, cache = layer(x, cos, sin, cache, cache_pos)
                new_caches.append(cache)
            return self.norm(x), new_caches
        ckpt = self.cfg.recompute and torch.is_grad_enabled()
        for layer in self.layers:
            x = recompute(layer, x, cos, sin) if ckpt else layer(x, cos, sin)
        return self.norm(x)

    def forward_paged_decode(self, input_ids, paged_caches, block_tables,
                             seq_lens):
        """One batched decode step. input_ids (B, 1); paged_caches: per
        layer (k_cache, v_cache); seq_lens counts the token being decoded
        (its position is seq_lens-1; a pad row's 0 gathers rope row -1,
        which wraps, exactly as in the reference — the row is
        discarded); an int8 cache is the per-layer 4-tuple (k, v,
        k_scale, v_scale). Returns (hidden (B, 1, H), paged_caches)."""
        pos = seq_lens.long() - 1
        cos_b, sin_b = self.rope_cos[pos], self.rope_sin[pos]
        x = self.embed_tokens(input_ids)
        for layer, kv in zip(self.layers, paged_caches):
            x, _ = layer.forward_paged(x, cos_b, sin_b, kv, block_tables,
                                       seq_lens)
        return self.norm(x), paged_caches

    def forward_paged_prefill(self, input_ids, paged_caches, block_table,
                              cache_len, chunk_len):
        """One prefill CHUNK. input_ids (1, S) at positions
        cache_len..cache_len+S-1 (first chunk_len live); padded tail
        positions past the rope table are clipped to its last row (they
        are masked out of attention); paged_caches as in
        `forward_paged_decode`. Returns (hidden (1, S, H),
        paged_caches)."""
        s = input_ids.shape[1]
        pos = cache_len + torch.arange(s, device=input_ids.device)
        pos = pos.clamp(0, self.rope_cos.shape[0] - 1)
        cos_c, sin_c = self.rope_cos[pos], self.rope_sin[pos]
        x = self.embed_tokens(input_ids)
        for layer, kv in zip(self.layers, paged_caches):
            x, _ = layer.forward_paged_prefill(x, cos_c, sin_c, kv,
                                               block_table, cache_len,
                                               chunk_len)
        return self.norm(x), paged_caches

    def forward_paged_verify(self, input_ids, paged_caches, block_tables,
                             seq_lens, draft_lens):
        """One speculative VERIFY step. input_ids (B, S): row b's [last
        emitted token, drafts] at positions seq_lens[b]-1 onward (first
        1 + draft_lens[b] live); positions off the rope table (pad rows,
        padded tails) are clipped to it (those rows are masked or
        discarded). Returns (hidden (B, S, H), paged_caches)."""
        s = input_ids.shape[1]
        pos = (seq_lens.long()[:, None] - 1
               + torch.arange(s, device=input_ids.device)[None, :])
        pos = pos.clamp(0, self.rope_cos.shape[0] - 1)
        cos_bs, sin_bs = self.rope_cos[pos], self.rope_sin[pos]
        x = self.embed_tokens(input_ids)
        for layer, kv in zip(self.layers, paged_caches):
            x, _ = layer.forward_paged_verify(x, cos_bs, sin_bs, kv,
                                              block_tables, seq_lens,
                                              draft_lens)
        return self.norm(x), paged_caches


class LlamaForCausalLM(nn.Module):
    """Causal LM over `LlamaModel`. Built on `device` (the card unless
    told otherwise) in `dtype` (default: `config.dtype`), with initial
    weights drawn from `generator` (default: seed 0 on that device)."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if dtype is None:
            dtype = getattr(torch, config.dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = config
        self.model = LlamaModel(config, device=device, dtype=dtype,
                                generator=generator)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               device=device, dtype=dtype,
                               generator=generator))
        self.mesh = None

    def shard_(self, mesh):
        """Tensor parallelism, in place: keep this rank's shard of every
        split weight (`mesh`: a `ModelParallelMesh`, as
        `serving.tp_serving_mesh` returns) and free the rest. The
        embedding is vocab-parallel, each decoder layer's attention and
        MLP as in `LlamaAttention.shard_` / `LlamaMLP.shard_`, the head
        column-parallel over the vocab with its logits gathered (a tied
        head reads the vocab-parallel embedding). A model quantized for
        serving (`wq`) is split after, with its quantized weights. At
        tp 1 nothing changes. Returns the model."""
        if self.mesh is not None:
            raise ValueError(f"the model is already split over {self.mesh}")
        if mesh.tp == 1:
            return self
        cfg = self.cfg
        # the reference's refusal of heads the model axis does not divide
        # (kernels/paged_attention.py:390-393), before anything is split
        if cfg.num_attention_heads % mesh.tp:
            raise ValueError(f"H={cfg.num_attention_heads} not divisible "
                             f"by tp={mesh.tp}")
        if cfg.num_key_value_heads % mesh.tp:
            raise ValueError(f"KVH={cfg.num_key_value_heads} not divisible "
                             f"by tp={mesh.tp}")
        emb = self.model.embed_tokens
        self.model.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, mesh=mesh, full=emb)
        del emb
        for layer in self.model.layers:
            layer.self_attn.shard_(mesh)
            layer.mlp.shard_(mesh)
        if self.lm_head is not None:
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False,
                gather_output=True, mesh=mesh, full=self.lm_head)
        self.mesh = mesh
        return self

    def _head(self, h):
        if self.lm_head is None:
            emb = self.model.embed_tokens
            if self.mesh is not None:
                return emb.attend(h)
            return torch.matmul(h, emb.weight.t())
        return self.lm_head(h)

    def forward(self, input_ids, labels=None, caches=None, cache_pos=None):
        """Without labels: logits (B, S, V), or (logits, new caches) with
        `caches` (the KV-cache forward). With labels (B, S): the
        next-token loss — logits[:, :-1] against labels[:, 1:], fp32
        cross entropy, mean over the positions whose label is not -100
        (the reference's `_head_and_loss`)."""
        if caches is not None:
            h, caches = self.model(input_ids, caches, cache_pos)
        else:
            h = self.model(input_ids)
        logits = self._head(h)
        if labels is None:
            return logits if caches is None else (logits, caches)
        shift_labels = labels[:, 1:]
        loss_t = parallel_cross_entropy(logits[:, :-1, :], shift_labels)
        valid = (shift_labels != -100).to(loss_t.dtype)
        return (loss_t[..., 0] * valid).sum() / valid.sum().clamp_min(1.0)

    def forward_paged_decode(self, input_ids, paged_caches, block_tables,
                             seq_lens):
        """Serving decode step: paged-KV transformer + LM head.
        Returns (logits (B, 1, V), paged_caches)."""
        h, caches = self.model.forward_paged_decode(
            input_ids, paged_caches, block_tables, seq_lens)
        return self._head(h), caches

    def forward_paged_prefill(self, input_ids, paged_caches, block_table,
                              cache_len, chunk_len):
        """Serving prefill chunk: paged-KV transformer + LM head at the
        chunk's LAST LIVE position only (the sole row serving consumes).
        Returns (logits (1, 1, V), paged_caches)."""
        h, caches = self.model.forward_paged_prefill(
            input_ids, paged_caches, block_table, cache_len, chunk_len)
        return self._head(h[:, chunk_len - 1:chunk_len]), caches

    def forward_paged_verify(self, input_ids, paged_caches, block_tables,
                             seq_lens, draft_lens):
        """Serving verify step: paged-KV transformer over 1 + K tokens a
        row and the LM head at EVERY position (position j's logits score
        draft j+1 and give the correction or bonus token).
        Returns (logits (B, S, V), paged_caches)."""
        h, caches = self.model.forward_paged_verify(
            input_ids, paged_caches, block_tables, seq_lens, draft_lens)
        return self._head(h), caches

    def forward_paged_decode_multi(self, input_ids, paged_caches,
                                   block_tables, seq_lens, step_caps,
                                   eos_ids, noise=None, *, k_steps,
                                   temperature=0.0, top_k=0, top_p=1.0):
        """K decode steps in ONE launch: `k_steps` calls of
        `forward_paged_decode` with sampling on the device, so a launch
        emits up to K tokens a row for one host round trip.

        input_ids (B,) — each row's last emitted token; seq_lens (B,)
        counts through it (the `forward_paged_decode` convention);
        step_caps (B,) — tokens row b may emit (0 marks a pad row);
        eos_ids (B,) — per-row EOS (-1 for none); noise — (K, B, V)
        Gumbel noise drawn by the caller before the launch (None for
        greedy), one block per step, so a retried launch replays bit for
        bit.

        Freeze masks: a row stops once it hits its cap, its EOS or
        non-finite logits on a live step. A frozen row stays in the
        batch at a fixed (ids, seq_len), rewriting the same token's K/V
        at the same slot every remaining step, and emits -1. The loop
        runs all K steps and reads nothing back: tokens, counts and
        flags stay on the device until the caller's one copy.

        Returns (tokens (B, K) int64, -1 past each row's finish; n_emit
        (B,) int32; ok (B,) bool, False iff a live step of that row had
        non-finite logits; paged_caches)."""
        ids = input_ids.reshape(-1).long()
        sl = seq_lens.to(torch.int32)
        caps = step_caps.to(torch.int32)
        eos = eos_ids.long()
        active = caps > 0
        n_emit = torch.zeros_like(sl)
        ok = torch.ones_like(active)
        minus1 = torch.full_like(ids, -1)
        toks = []
        for j in range(int(k_steps)):
            logits, _ = self.forward_paged_decode(ids[:, None], paged_caches,
                                                  block_tables, sl)
            rows = logits[:, 0]
            fin = torch.isfinite(rows).all(dim=-1)
            tok = generation._sample(rows, temperature, top_k, top_p,
                                     None if noise is None else noise[j])
            emit = active & fin
            # non-finite logits on a LIVE step poison the row; a frozen
            # row's logits are discarded
            ok = ok & (fin | ~active)
            toks.append(torch.where(emit, tok, minus1))
            n_emit = n_emit + emit.to(torch.int32)
            hit_eos = emit & (eos >= 0) & (tok == eos)
            active = emit & ~hit_eos & (n_emit < caps)
            ids = torch.where(emit, tok, ids)
            sl = sl + emit.to(torch.int32)
        return torch.stack(toks, dim=1), n_emit, ok, paged_caches

    # -------------------------------------------------------- generation
    def _new_caches(self, batch, length=0):
        """Per-layer (k, v) zeros of (batch, length, KVH, D) in the
        model's dtype, on its device: empty for the concatenated mode,
        the whole buffer for the fixed one."""
        w = self.model.embed_tokens.weight
        return [tuple(torch.zeros(batch, length, layer.self_attn.n_kv,
                                  layer.self_attn.head_dim, dtype=w.dtype,
                                  device=w.device) for _ in range(2))
                for layer in self.model.layers]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, use_jit=False,
                 seed=None):
        """Greedy (temperature 0) or sampled decode with a KV cache:
        input_ids (B, S0) -> (B, S0 + max_new_tokens) on the model's
        device. Once a row emits `eos_token_id` it emits only that; once
        every row has, the rest is padded with it. Sampling draws its
        noise from a `torch.Generator` on the model's device seeded with
        `seed` (from torch's default generator when None).
        `use_jit=True` runs `jit_generate` over a preallocated cache:
        the same tokens."""
        device = self.model.embed_tokens.weight.device
        ids = torch.as_tensor(input_ids).to(device)
        if use_jit:
            return generation.jit_generate(
                self, ids, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id, seed=seed)
        gen = generation.make_generator(seed, device)
        b = ids.shape[0]
        logits, caches = self(ids, caches=self._new_caches(b))
        out = [ids]
        done = torch.zeros(b, dtype=torch.bool, device=device)
        for i in range(max_new_tokens):
            nxt = generation.next_token(logits[:, -1], temperature, top_k,
                                        top_p, gen)
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt.to(ids.dtype)[:, None])
            if eos_token_id is not None and bool(done.all()):
                out.append(torch.full((b, max_new_tokens - i - 1),
                                      eos_token_id, dtype=ids.dtype,
                                      device=device))
                break
            if i + 1 < max_new_tokens:
                logits, caches = self(out[-1], caches=caches)
        return torch.cat(out, dim=1)
