"""Move a reference Llama or Qwen2-MoE state dict, and a Llama model's
AdamW state, into the port.

The reference's `LlamaForCausalLM.state_dict()`, exported as numpy
arrays, uses the same names as the port (`model.layers.0.self_attn.
q_proj.weight`, ...) and the same (in, out) Linear layout, so conversion
is a name/shape check and a copy. The rope tables are not parameters on
either side: the port rebuilds them from the config. The optimizer's
state crosses in its canonical per-parameter form (`moment1_<i>`,
`moment2_<i>`, `master_<i>`, `@step`), which both sides' `state_dict()`
write whether or not the update was fused, with amsgrad's
`moment2_max_<i>` and an LR scheduler's `LR_Scheduler` dict.

A state dict of a reference model converted for weight-only serving
(`quantize_for_serving`, wq="int8"/"int4") carries int8 `*.qweight` and
fp32 `*.weight_scale` in place of each target's `*.weight`; pass the
same `wq` and the result loads into a port model converted the same way.

A reference `LoRAAdapter` (numpy factors, rank, alpha) crosses as its
arrays too (`from_jax_adapter`).

Qwen2-MoE (`Qwen2MoeConfig`): the same names and layouts, except that
the reference's per-expert weights (`mlp.moe.experts.<e>.gate_proj.
weight`, ...) become one stacked tensor each (`mlp.moe.experts.
gate_proj.weight`, expert e at index e; (in, out) slices, no transpose);
`qwen2_moe.state_shapes` and `qwen2_moe.reference_expert_names` say
which, and `_FAMILIES` maps each config type to its pair.
Its optimizer state does not cross: the reference keeps moments per
expert, the port per stacked tensor, and no converter maps one onto the
other. Weight-only quantization and tensor parallelism are Llama's only.

Tensor parallelism: `shard_state_dict` cuts a converted state (any wq)
down to one rank's shard, each tensor on the axis the reference's
`mark_sharding` spec gives it, for a model split by
`LlamaForCausalLM.shard_` to load.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..distributed.fleet.mpu import shard_range
from ..nn.quant import SERVING_WQ_TARGETS, shard_weight_only
from ..serving.lora.adapter import LoRAAdapter
from . import qwen2_moe
from .llama import LlamaConfig
from .qwen2_moe import Qwen2MoeConfig

__all__ = ["expected_shapes", "from_jax_state_dict",
           "from_jax_optimizer_state", "from_jax_adapter",
           "shard_state_dict"]

_OPT_KEY = re.compile(r"(moment1|moment2|moment2_max|master)_(\d+)")


def _llama_shapes(cfg: LlamaConfig, wq=None) -> Dict[str, tuple]:
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kvd = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    shapes = {"model.embed_tokens.weight": (v, h),
              "model.norm.weight": (h,)}
    per_layer = {
        "input_layernorm.weight": (h,),
        "self_attn.q_proj.weight": (h, h),
        "self_attn.k_proj.weight": (h, kvd),
        "self_attn.v_proj.weight": (h, kvd),
        "self_attn.o_proj.weight": (h, h),
        "post_attention_layernorm.weight": (h,),
        "mlp.gate_proj.weight": (h, i),
        "mlp.up_proj.weight": (h, i),
        "mlp.down_proj.weight": (i, h),
    }
    if cfg.use_bias:
        per_layer.update({
            "self_attn.q_proj.bias": (h,), "self_attn.k_proj.bias": (kvd,),
            "self_attn.v_proj.bias": (kvd,), "self_attn.o_proj.bias": (h,),
            "mlp.gate_proj.bias": (i,), "mlp.up_proj.bias": (i,),
            "mlp.down_proj.bias": (h,)})
    for layer in range(cfg.num_hidden_layers):
        for name, shape in per_layer.items():
            shapes[f"model.layers.{layer}.{name}"] = shape
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    if wq is not None:
        for name in [n for n in shapes
                     if n.split(".")[-2:] in ([t, "weight"]
                                              for t in SERVING_WQ_TARGETS)]:
            k_in, n_out = shapes.pop(name)
            base = name[:-len("weight")]
            shapes[base + "qweight"] = (k_in // 2 if wq == "int4" else k_in,
                                        n_out)
            shapes[base + "weight_scale"] = (n_out,)
    return shapes


def _no_stacked(cfg) -> Dict[str, list]:
    return {}


# each model family's config -> ({name: shape} of its port state dict,
# {stacked port name: the reference's names of its slices, in order})
_FAMILIES = {LlamaConfig: (_llama_shapes, _no_stacked),
             Qwen2MoeConfig: (qwen2_moe.state_shapes,
                              qwen2_moe.reference_expert_names)}


def _family(cfg):
    try:
        return _FAMILIES[type(cfg)]
    except KeyError:
        raise TypeError(f"no converter for {type(cfg).__name__}") from None


def expected_shapes(cfg, wq=None) -> Dict[str, tuple]:
    """{name: shape} of the port model's state dict for `cfg` (a
    `LlamaConfig` or a `Qwen2MoeConfig`); with wq="int8"/"int4" (Llama
    only), of the model after `quantize_for_serving`: each target's
    (in, out) `weight` becomes `qweight` ((in, out) int8, (in / 2, out)
    int4) and `weight_scale` (out,)."""
    if wq not in (None, "int8", "int4"):
        raise ValueError(f"wq must be None, 'int8' or 'int4', got {wq!r}")
    return _family(cfg)[0](cfg, wq)


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                         # a writable, owned copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_state_dict(np_state, cfg, wq=None) -> Dict[str, torch.Tensor]:
    """{name: numpy array} from the reference -> the port's state dict
    (CPU tensors, the arrays' dtypes), ready for
    `LlamaForCausalLM.load_state_dict(..., strict=True)` — for wq set,
    into a port model converted by `quantize_for_serving` with the same
    wq — or, for a `Qwen2MoeConfig`, `Qwen2MoeForCausalLM`'s (each
    routed-expert weight stacked from the reference's E per-expert
    arrays). Raises ValueError on a missing or unexpected name or a
    shape mismatch."""
    want = expected_shapes(cfg, wq)
    stacked = _family(cfg)[1](cfg)
    ref_want = {}
    for name, shape in want.items():
        ref_want.update(((part, shape[1:]) for part in stacked[name])
                        if name in stacked else ((name, shape),))
    missing = sorted(set(ref_want) - set(np_state))
    extra = sorted(set(np_state) - set(ref_want))
    if missing or extra:
        raise ValueError(f"state dict does not fit the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for name, shape in ref_want.items():
        got = tuple(np.shape(np_state[name]))
        if got != shape:
            raise ValueError(f"{name}: shape {got} != {shape}")
    out = {}
    for name in want:
        if name in stacked:
            out[name] = torch.stack([_to_tensor(np_state[part])
                                     for part in stacked[name]])
        else:
            out[name] = _to_tensor(np_state[name])
    return out


# the reference's mark_sharding specs (paddle_tpu/distributed/fleet/
# mpu.py): column-parallel weights split their out dim (1) and their
# bias and quantized scales with it; row-parallel weights split their in
# dim (0) and keep bias and scales whole; the vocab-parallel embedding
# splits its rows. Everything else (norms) is whole on every rank.
_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
_ROW = ("o_proj", "down_proj")


def shard_state_dict(state, cfg: LlamaConfig, rank: int,
                     tp: int) -> Dict[str, torch.Tensor]:
    """A whole port state dict (`from_jax_state_dict`, with or without
    wq; the reference's (in, out) Linear layout, so no transpose) ->
    rank's shard of a tp-way split, as `LlamaForCausalLM.shard_(mesh)`
    leaves the model: contiguous copies, `load_state_dict`-ready."""
    out = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        module = path[-1] if path else ""
        if name == "model.embed_tokens.weight":
            a, b = shard_range(t.shape[0], rank, tp)
            t = t[a:b]
        elif module in _COLUMN and leaf in ("weight", "qweight"):
            a, b = shard_range(t.shape[1], rank, tp)
            t = t[:, a:b]
        elif module in _COLUMN and leaf in ("bias", "weight_scale"):
            a, b = shard_range(t.shape[0], rank, tp)
            t = t[a:b]
        elif module in _ROW and leaf == "weight":
            a, b = shard_range(t.shape[0], rank, tp)
            t = t[a:b]
        elif module in _ROW and leaf == "qweight":
            n_in = (cfg.intermediate_size if module == "down_proj"
                    else cfg.hidden_size)
            packed = "int4" if t.shape[0] * 2 == n_in else "int8"
            a, b = shard_range(n_in, rank, tp)
            t, _ = shard_weight_only(t, state[name[:-len("qweight")]
                                              + "weight_scale"],
                                     packed, 0, a, b)
        out[name] = t.contiguous().clone()
    return out


def from_jax_optimizer_state(np_state) -> Dict[str, object]:
    """The reference optimizer's `state_dict()`, exported as {key: numpy
    array} plus the int `@step` and the `LR_Scheduler` dict -> the same
    keys as CPU tensors (dtypes kept, bf16 included; the scheduler's
    dict copied), ready for the port's `set_state_dict`. Raises
    ValueError on a key the port does not take."""
    out: Dict[str, object] = {}
    for key, val in np_state.items():
        if key == "@step":
            out[key] = int(val)
        elif key == "LR_Scheduler":
            out[key] = {k: (list(v) if isinstance(v, (list, tuple)) else v)
                        for k, v in dict(val).items()}
        elif _OPT_KEY.fullmatch(key):
            out[key] = _to_tensor(val)
        else:
            raise ValueError(f"optimizer state key {key!r} is not ported")
    return out


def from_jax_adapter(adapter) -> LoRAAdapter:
    """The reference's `LoRAAdapter` -> the port's: the same name, rank
    and alpha, and a copy of every module's fp32 (A, B) arrays."""
    return LoRAAdapter(adapter.name, adapter.rank,
                       {m: (np.array(a, np.float32), np.array(b, np.float32))
                        for m, (a, b) in adapter.weights.items()},
                       alpha=adapter.alpha)
