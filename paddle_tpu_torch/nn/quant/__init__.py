"""Weight-only int8/int4 linear (port of `paddle_tpu/nn/quant/__init__.py`).

Weights live on the device as int8 (or int4 packed two per byte along
the in dim) with per-output-channel fp32 scales. An int8 linear runs
`kernels/quant_matmul.py`: on the card the hand-written dequant-matmul
kernel for every shape; on the CPU the kernel's numerics where the
reference's dispatch would take its Pallas kernel, else the scale-first
composition the reference falls back to, so CPU results follow the
reference's. An int4 linear unpacks and takes the scale-first
composition on both devices (the reference has no int4 kernel either).

`quantize_for_serving` is what `ServingEngine(wq=...)` calls: it swaps
the MLP and LM-head linears for `WeightOnlyLinear` in place. Under
tensor parallelism a weight is quantized whole, as at tp 1, and then
split (`shard_weight_only`): a column shard takes its columns' scales, a
row shard keeps the whole scale vector. Not ported:
`llm_int8_linear`, the QAT gradient of the int8 matmul, and the
quantization-aware layers (`Stub`, `quant_layers`).
"""
from __future__ import annotations

import torch
from torch import nn

from ...kernels.quant_matmul import (dequant_matmul, quant_matmul,
                                     quant_matmul_supported)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_serving", "SERVING_WQ_TARGETS",
           "shard_weight_only"]

_ALGOS = ("weight_only_int8", "weight_only_int4")


def _in_dtype(fn, *args, dtype):
    """One elementwise op computed in fp32 and rounded to `dtype`: how
    the reference's XLA evaluates a bf16 op, so the port gives the same
    bytes (a no-op round for fp32)."""
    return fn(*(a.float() for a in args)).to(dtype)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """(in, out) weight -> (quantized weight, per-out-channel fp32 scale).

    algo 'weight_only_int8': int8 (in, out); 'weight_only_int4': two
    4-bit values packed per int8 byte along the in dim (in / 2, out). As
    in the reference, the absmax, the scale and round(w / scale) are
    computed in the weight's own dtype (each op rounded to it); only the
    scale is stored as fp32."""
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    w = x.detach()
    dt = w.dtype
    absmax = torch.maximum(w.abs().amax(dim=0),
                           torch.tensor(1e-10, dtype=dt, device=w.device))
    if algo == "weight_only_int8":
        scale = _in_dtype(lambda a: a / 127.0, absmax, dtype=dt)
        q = _in_dtype(lambda a, s: a / s[None, :], w, scale, dtype=dt)
        q = torch.round(q).clamp_(-127, 127)
        return q.to(torch.int8), scale.float()
    s4 = _in_dtype(lambda a: a / 7.0, absmax, dtype=dt).float()
    qi = torch.round(w.float() / s4[None, :]).clamp_(-7, 7).to(torch.int8)
    if qi.shape[0] % 2:
        raise ValueError("int4 packing needs even in-features")
    lo = qi[0::2] & 0x0F
    hi = (qi[1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8), s4


def _unpack_int4(packed):
    """(K/2, N) int8 -> (K, N) int8 of signed 4-bit values (row 2i the
    low nibble of packed row i, row 2i + 1 its high nibble)."""
    lo = (packed << 4) >> 4                  # sign-extend the low nibble
    hi = packed >> 4                         # arithmetic shift: high
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n)


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float32"):
    """Inverse of weight_quantize: q * scale in fp32, cast to out_dtype."""
    q = _unpack_int4(x) if algo == "weight_only_int4" else x
    dt = getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype
    return (q.float() * scale.float()[None, :]).to(dt)


def _wint8_supported(M, K, N):
    """The reference's CPU dispatch: shapes with a legal Pallas tiling
    take its kernel (whose numerics `quant_matmul_ref` has), the rest
    the scale-first composition."""
    if K % 8 != 0 or N % 128 != 0:
        return False
    return quant_matmul_supported(M, K, N)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x @ dequant(weight, weight_scale) + bias, in x's dtype. int8 on a
    CUDA tensor always launches the kernel (`quant_matmul`)."""
    if weight_scale is None:
        raise ValueError("weight_scale is required")
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"unknown weight_dtype {weight_dtype!r}")
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2d = x.reshape(-1, K)
    wq = _unpack_int4(weight) if weight_dtype == "int4" else weight
    M, N = x2d.shape[0], wq.shape[1]
    if weight_dtype == "int8" and (x2d.device.type != "cpu"
                                   or _wint8_supported(M, K, N)):
        out = quant_matmul(x2d.contiguous(), wq, weight_scale)
    else:
        out = dequant_matmul(x2d, wq, weight_scale)
    if bias is not None:
        out = out + bias
    return out.reshape(*lead, N)


class WeightOnlyLinear(nn.Module):
    """Inference linear with int8/int4 weights: buffers `qweight` (int8:
    (in, out); int4: (in / 2, out)) and `weight_scale` (out,) fp32, plus
    the optional `bias` — the reference's names, so state dicts match.
    Built from a float (in, out) weight, quantized once here."""

    def __init__(self, weight, bias=None, algo="weight_only_int8"):
        super().__init__()
        if algo not in _ALGOS:
            raise ValueError(f"unknown algo {algo!r}")
        self.weight_dtype = "int8" if algo.endswith("int8") else "int4"
        self.in_features, self.out_features = (int(weight.shape[0]),
                                               int(weight.shape[1]))
        with torch.no_grad():
            qw, scale = weight_quantize(weight, algo=algo)
        self.register_buffer("qweight", qw)
        self.register_buffer("weight_scale", scale)
        if bias is not None:
            self.register_buffer("bias", bias.detach().clone())
        else:
            self.bias = None

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.bias,
                                  self.weight_scale, self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"weight_dtype={self.weight_dtype}")


# The decode-regime projections whose weights dominate the decode bytes
# (MLP + LM head); attention q/k/v/o stay full width, as in the
# reference.
SERVING_WQ_TARGETS = ("gate_proj", "up_proj", "down_proj", "lm_head")


def shard_weight_only(qweight, weight_scale, weight_dtype, dim, start,
                      stop):
    """One tensor-parallel shard of a weight quantized whole: rows
    [start, stop) of the (in, out) weight (dim 0, a row-parallel shard;
    int4 rows are packed in pairs, so both ends must be even) with the
    whole scale vector, or columns [start, stop) (dim 1) with their
    scales. Returns contiguous copies (qweight, weight_scale)."""
    if dim == 1:
        return (qweight[:, start:stop].contiguous().clone(),
                weight_scale[start:stop].contiguous().clone())
    if weight_dtype == "int4":
        if start % 2 or stop % 2:
            raise ValueError(f"int4 rows are packed in pairs: shard rows "
                             f"[{start}, {stop}) must start and end even")
        start, stop = start // 2, stop // 2
    return (qweight[start:stop].contiguous().clone(),
            weight_scale.contiguous().clone())


def quantize_for_serving(model, algo="weight_only_int8",
                         targets=SERVING_WQ_TARGETS):
    """Replace every `targets`-named submodule with a 2-D `weight` (by
    its attribute name, anywhere in the tree) by a WeightOnlyLinear, IN
    PLACE; the float weights are released. A tied head (`lm_head` None)
    is left alone. Returns the number of layers converted. A
    tensor-parallel shard raises: a row shard's scales need the whole
    weight, so weights are quantized before they are split."""
    converted = 0
    stack = [model]
    while stack:
        module = stack.pop()
        for name, sub in list(module.named_children()):
            w = getattr(sub, "weight", None)
            if name in targets and getattr(sub, "tp_sharded", False):
                raise ValueError(f"{name} is a tensor-parallel shard: "
                                 f"quantize the whole model before it is "
                                 f"split")
            if (name in targets and isinstance(w, torch.Tensor)
                    and w.dim() == 2
                    and not isinstance(sub, WeightOnlyLinear)):
                setattr(module, name, WeightOnlyLinear(
                    w, bias=getattr(sub, "bias", None), algo=algo))
                converted += 1
            else:
                stack.append(sub)
    return converted
