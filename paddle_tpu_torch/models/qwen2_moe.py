"""Qwen2-MoE decoder LM (port of `paddle_tpu/models/qwen2_moe.py`).

Architecture: Llama-style GQA attention with a bias on q, k and v, the
interleaved-pair rotary of `models/llama.py`, RMSNorm; each sparse
decoder layer's FFN is `distributed.moe.MoELayer` (top-k routed SwiGLU
experts run as one batched computation) plus a shared SwiGLU expert
scaled by a sigmoid gate; a layer with `(i + 1) % decoder_sparse_step
!= 0` is a dense SwiGLU of `intermediate_size`. The loss is the
shifted cross entropy (`ParallelCrossEntropy`), its mean over labels
that are not -100, plus `router_aux_loss_coef` times the sum of the
sparse layers' load-balancing losses.

Training only, as in the reference: the model has no KV-cache or paged
forward, so neither `generate` nor the serving engine runs it. The
attention goes through `scaled_dot_product_attention` (no mask, no
dropout), so on the card every layer runs the flash kernels. The LM
head is never tied (the reference ignores `tie_word_embeddings` here).
At tp 1 the reference's tensor-parallel projections are whole linears,
and the port builds them as such; tensor and expert parallelism are not
ported.

The constructor builds every weight on `device` (the card by default)
in `dtype` (float32 by default) from an explicit `torch.Generator`; the
routed experts are built straight into their stacked parameters
(`StackedExperts.build`), each expert's projections Xavier-initialised
at their own fan. Parameter names follow the reference's, except that
the E routed experts' weights are one stacked tensor each
(`mlp.moe.experts.gate_proj.weight` of shape (E, hidden, inter));
`models/convert.py` carries a reference state dict across.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.mpu import ParallelCrossEntropy
from ..distributed.moe import MoELayer, StackedExperts, TopKGate
from ..nn import Embedding, Linear, RMSNorm
from ..nn.functional import scaled_dot_product_attention, swiglu
from .llama import _rope_cache, apply_rotary

__all__ = ["Qwen2MoeConfig", "Qwen2MoeForCausalLM", "qwen2_moe_tiny",
           "qwen2_moe_a14b"]


@dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632          # dense-layer FFN (unused if all sparse)
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 60
    num_experts_per_tok: int = 4
    decoder_sparse_step: int = 1           # every n-th layer is sparse
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 2.0
    tie_word_embeddings: bool = False


def qwen2_moe_tiny(**kw):
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, shared_expert_intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
               max_position_embeddings=128)
    cfg.update(kw)
    return Qwen2MoeConfig(**cfg)


def qwen2_moe_a14b(**kw):
    """Qwen2-57B-A14B geometry."""
    cfg = dict(vocab_size=151936, hidden_size=3584,
               moe_intermediate_size=2560,
               shared_expert_intermediate_size=20480,
               num_hidden_layers=28, num_attention_heads=28,
               num_key_value_heads=4, num_experts=64, num_experts_per_tok=8)
    cfg.update(kw)
    return Qwen2MoeConfig(**cfg)


def state_shapes(cfg: Qwen2MoeConfig, wq=None) -> dict:
    """{name: shape} of a `Qwen2MoeForCausalLM` state dict for `cfg`,
    each routed-expert weight stacked ((E, in, out)). Weight-only
    quantization of this model is not ported: `wq` must be None."""
    if wq is not None:
        raise ValueError("weight-only quantization of Qwen2-MoE is not "
                         "ported")
    h, v, E = cfg.hidden_size, cfg.vocab_size, cfg.num_experts
    kvd = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    mi, si = cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
    shapes = {"model.embed_tokens.weight": (v, h)}
    for layer in range(cfg.num_hidden_layers):
        per_layer = {
            "input_layernorm.weight": (h,),
            "self_attn.q_proj.weight": (h, h), "self_attn.q_proj.bias": (h,),
            "self_attn.k_proj.weight": (h, kvd),
            "self_attn.k_proj.bias": (kvd,),
            "self_attn.v_proj.weight": (h, kvd),
            "self_attn.v_proj.bias": (kvd,),
            "self_attn.o_proj.weight": (h, h),
            "post_attention_layernorm.weight": (h,)}
        if (layer + 1) % cfg.decoder_sparse_step == 0:
            per_layer.update({
                "mlp.moe.experts.gate_proj.weight": (E, h, mi),
                "mlp.moe.experts.up_proj.weight": (E, h, mi),
                "mlp.moe.experts.down_proj.weight": (E, mi, h),
                "mlp.moe.gate.wg.weight": (h, E),
                "mlp.shared_expert.gate_proj.weight": (h, si),
                "mlp.shared_expert.up_proj.weight": (h, si),
                "mlp.shared_expert.down_proj.weight": (si, h),
                "mlp.shared_expert.shared_expert_gate.weight": (h, 1)})
        else:
            i = cfg.intermediate_size
            per_layer.update({"mlp.gate_proj.weight": (h, i),
                              "mlp.up_proj.weight": (h, i),
                              "mlp.down_proj.weight": (i, h)})
        for name, shape in per_layer.items():
            shapes[f"model.layers.{layer}.{name}"] = shape
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (h, v)
    return shapes


def reference_expert_names(cfg: Qwen2MoeConfig) -> dict:
    """{stacked name: the reference's E per-expert names, expert e at
    index e}: `mlp.moe.experts.gate_proj.weight` is the reference's
    `mlp.moe.experts.<e>.gate_proj.weight` (the same (in, out) layout)."""
    out = {}
    for name in state_shapes(cfg):
        head, sep, tail = name.partition(".moe.experts.")
        if sep:
            out[name] = [f"{head}.moe.experts.{e}.{tail}"
                         for e in range(cfg.num_experts)]
    return out


class Qwen2MoeAttention(nn.Module):
    """GQA with a bias on q, k and v (Qwen2's convention), RoPE, causal
    attention through SDPA (the flash kernels on the card)."""

    def __init__(self, cfg: Qwen2MoeConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_attention_heads
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads
        kvd = self.n_kv * self.head_dim
        self.q_proj = Linear(h, h, bias=True, **kw)
        self.k_proj = Linear(h, kvd, bias=True, **kw)
        self.v_proj = Linear(h, kvd, bias=True, **kw)
        self.o_proj = Linear(h, h, **kw)

    def forward(self, x, cos, sin):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.n_kv, self.head_dim)
        v = self.v_proj(x).view(b, s, self.n_kv, self.head_dim)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, self.n_heads * self.head_dim))


class _ExpertMLP(nn.Module):
    """SwiGLU expert (no bias)."""

    def __init__(self, hidden: int, inter: int, **kw):
        super().__init__()
        self.gate_proj = Linear(hidden, inter, **kw)
        self.up_proj = Linear(hidden, inter, **kw)
        self.down_proj = Linear(inter, hidden, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class _SharedExpert(_ExpertMLP):
    """The always-on expert, scaled by a learned sigmoid gate."""

    def __init__(self, cfg: Qwen2MoeConfig, **kw):
        super().__init__(cfg.hidden_size,
                         cfg.shared_expert_intermediate_size, **kw)
        self.shared_expert_gate = Linear(cfg.hidden_size, 1, **kw)

    def forward(self, x):
        return torch.sigmoid(self.shared_expert_gate(x)) * super().forward(x)


class Qwen2MoeSparseBlock(nn.Module):
    """Routed experts + the shared expert."""

    def __init__(self, cfg: Qwen2MoeConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)

        def expert(**ekw):
            return _ExpertMLP(cfg.hidden_size, cfg.moe_intermediate_size,
                              **ekw)
        experts = StackedExperts.build(expert, cfg.num_experts, **kw)
        gate = TopKGate(cfg.hidden_size, cfg.num_experts,
                        topk=cfg.num_experts_per_tok,
                        capacity_factor=cfg.capacity_factor, **kw)
        self.moe = MoELayer(cfg.hidden_size, experts=experts, gate=gate,
                            topk=cfg.num_experts_per_tok,
                            capacity_factor=cfg.capacity_factor)
        self.shared_expert = _SharedExpert(cfg, **kw)

    @property
    def aux_loss(self):
        return self.moe.aux_loss

    def forward(self, x):
        return self.moe(x) + self.shared_expert(x)


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2MoeConfig, layer_idx: int, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = Qwen2MoeAttention(cfg, generator=generator, **kw)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.is_sparse = (layer_idx + 1) % cfg.decoder_sparse_step == 0
        if self.is_sparse:
            self.mlp = Qwen2MoeSparseBlock(cfg, generator=generator, **kw)
        else:
            self.mlp = _ExpertMLP(cfg.hidden_size, cfg.intermediate_size,
                                  generator=generator, **kw)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2MoeModel(nn.Module):
    def __init__(self, cfg: Qwen2MoeConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      generator=generator, **kw)
        self.layers = nn.ModuleList([
            Qwen2MoeDecoderLayer(cfg, i, generator=generator, **kw)
            for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        cos, sin = _rope_cache(cfg.hidden_size // cfg.num_attention_heads,
                               cfg.max_position_embeddings, cfg.rope_theta,
                               device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)

    def aux_losses(self):
        """The load-balancing loss of each sparse layer's last forward."""
        return [layer.mlp.aux_loss for layer in self.layers
                if layer.is_sparse and layer.mlp.aux_loss is not None]


class Qwen2MoeForCausalLM(nn.Module):
    """Causal LM over `Qwen2MoeModel`. Built on `device` (the card unless
    told otherwise) in `dtype` (default float32), with initial weights
    drawn from `generator` (default: seed 0 on that device)."""

    def __init__(self, config: Qwen2MoeConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if dtype is None:
            dtype = torch.float32
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = config
        self.model = Qwen2MoeModel(config, device=device, dtype=dtype,
                                   generator=generator)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              device=device, dtype=dtype, generator=generator)

    def forward(self, input_ids, labels=None):
        """Without labels: logits (B, S, V). With labels (B, S): the
        next-token loss — logits[:, :-1] against labels[:, 1:], fp32
        cross entropy, mean over the positions whose label is not -100 —
        plus router_aux_loss_coef x the sum of the sparse layers' aux
        losses."""
        logits = self.lm_head(self.model(input_ids))
        if labels is None:
            return logits
        shift_labels = labels[:, 1:]
        loss_t = ParallelCrossEntropy()(logits[:, :-1, :], shift_labels)
        valid = (shift_labels != -100).to(loss_t.dtype)
        loss = (loss_t[..., 0] * valid).sum() / valid.sum().clamp_min(1.0)
        aux = self.model.aux_losses()
        if aux and self.cfg.router_aux_loss_coef > 0:
            loss = loss + self.cfg.router_aux_loss_coef * sum(aux[1:],
                                                              aux[0])
        return loss
