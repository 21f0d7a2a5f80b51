"""Fused multi-tensor AdamW over packed buckets (port of
`paddle_tpu/kernels/fused_optimizer.py`).

Geometry is the reference's, line for line (`build_bucket_layout`):
every parameter of an update group flattens into one 1-D bucket,
zero-padded to a (rows, 128) view whose rows are 64-aligned. Zero
padding is update-invariant: g = m = v = w = 0 stays 0.

`fused_adamw_bucket` launches the hand-written Hopper kernel of
`csrc/fused_adamw.cu` for every CUDA bucket, whatever its size (the
reference's `PALLAS_MIN_ROWS` was a TPU dispatch-cost cut-off), counted
in `.launches`, or raises; a CPU bucket runs the plain version,
`_adamw_math` — the only update expression, written token for token
like the per-parameter `AdamW._apply_one`. The kernel rounds every
operation as that chain of separate PyTorch ops does, so on the card it
is bitwise equal to the plain version.

Unlike the reference (immutable arrays), the port updates the weight
(master or fp32 parameter) bucket and both moment buckets IN PLACE; the
returned tuple aliases them. The nine scalars of `adamw_scalars` reach
the kernel as a 9-element fp32 tensor on the bucket's device, so a
changing step needs no host sync and no rebuild.

Not ported: `fused_adamw_zero1` (ZeRO-1 needs the 'sharding' mesh) and
`pick_block_rows_fused` (a TPU VMEM estimator).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

__all__ = ["BucketLayout", "build_bucket_layout", "pack_bucket",
           "unpack_bucket", "adamw_scalars", "adamw_update_bytes",
           "fused_adamw_bucket", "fused_adamw_bucket_ref",
           "fused_adamw_zero1", "LANES", "ROW_ALIGN", "N_SCALARS",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "fused_adamw.cu"
LANES = 128          # lane width of the 2-D bucket view
ROW_ALIGN = 64       # row alignment of the reference's (8, 128) tiling
N_SCALARS = 9        # lr, wd_factor, b1, 1-b1, b2, 1-b2, bc1, bc2, eps
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class BucketLayout(NamedTuple):
    """Geometry of one packed bucket.

    entries: tuple of (param_index, flat_offset, size, shape) per leaf;
    rows:    padded row count of the (rows, LANES) bucket view.
    """
    entries: Tuple[Tuple[int, int, int, Tuple[int, ...]], ...]
    rows: int

    @property
    def padded_size(self) -> int:
        return self.rows * LANES

    @property
    def used_size(self) -> int:
        return sum(e[2] for e in self.entries)


def build_bucket_layout(shapes: Sequence[Tuple[int, Tuple[int, ...]]],
                        sharding_degree: int = 1) -> BucketLayout:
    """Layout for leaves [(param_index, shape), ...]: contiguous flat
    offsets, rows padded to lcm(ROW_ALIGN, sharding_degree)."""
    entries = []
    off = 0
    for idx, shape in shapes:
        size = int(math.prod(shape)) if shape else 1
        entries.append((int(idx), off, size, tuple(int(d) for d in shape)))
        off += size
    align = math.lcm(ROW_ALIGN, max(1, int(sharding_degree)))
    rows = -(-max(off, 1) // LANES)          # ceil div
    rows = -(-rows // align) * align
    return BucketLayout(tuple(entries), rows)


def pack_bucket(arrays: Sequence[torch.Tensor], layout: BucketLayout,
                dtype) -> torch.Tensor:
    """Concatenate leaves (layout order) + zero pad -> (rows, LANES).
    Each leaf is cast while it is copied into its slice, so packing needs
    no memory beyond the bucket."""
    out = torch.empty(layout.padded_size, dtype=dtype,
                      device=arrays[0].device if arrays else None)
    for a, (_, off, size, _) in zip(arrays, layout.entries):
        out[off:off + size].copy_(a.reshape(-1))
    out[layout.used_size:].zero_()
    return out.view(layout.rows, LANES)


def unpack_bucket(bucket: torch.Tensor,
                  layout: BucketLayout) -> List[torch.Tensor]:
    """Views of a (rows, LANES) bucket as the leaves (layout order)."""
    flat = bucket.reshape(-1)
    return [flat[off:off + size].view(shape)
            for (_, off, size, shape) in layout.entries]


def adamw_scalars(lr: float, beta1: float, beta2: float, eps: float,
                  weight_decay: float, step: int,
                  device=None) -> torch.Tensor:
    """The kernel's nine scalars as a fp32 tensor on `device` (CPU by
    default). Every entry is rounded f64 -> f32 exactly where the
    per-parameter path's Python floats round when they meet an fp32
    tensor, so fused and per-parameter round identically."""
    lr = float(lr)
    host = np.array([
        lr,
        1.0 - lr * float(weight_decay),      # decoupled-decay factor
        beta1, 1.0 - beta1,
        beta2, 1.0 - beta2,
        1.0 - beta1 ** int(step),            # bias correction 1
        1.0 - beta2 ** int(step),            # bias correction 2
        eps,
    ], np.float32)
    t = torch.from_numpy(host)
    return t if device is None else t.to(device, non_blocking=True)


def adamw_update_bytes(n_elems: int, param_width: int = 4,
                       moment_width: int = 4, has_master: bool = False,
                       grad_width: Optional[int] = None) -> int:
    """Bytes one fused update moves (single read, single write): read
    grad + (master | param) + m + v, write param (+ master) + m + v."""
    gw = param_width if grad_width is None else grad_width
    reads = gw + (4 if has_master else param_width) + 2 * moment_width
    writes = param_width + (4 if has_master else 0) + 2 * moment_width
    return int(n_elems) * (reads + writes)


def _adamw_math(g, w, m, v, lr, wdf, b1, omb1, b2, omb2, bc1, bc2, eps):
    """THE AdamW expression, in `AdamW._apply_one`'s association order
    (`omb2 * g * g` is ((omb2*g)*g), `lr * mhat / (...)` is
    ((lr*mhat)/(...))); fp32 throughout. Returns fp32 (w, m, v)."""
    g = g.float()
    w = w.float() * wdf
    m = b1 * m.float() + omb1 * g
    v = b2 * v.float() + omb2 * g * g
    mhat = m / bc1
    vhat = v / bc2
    w = w - lr * mhat / (torch.sqrt(vhat) + eps)
    return w, m, v


def _has_master(weights, param_dtype) -> bool:
    return param_dtype is not None and param_dtype != weights.dtype


def fused_adamw_bucket_ref(grads, weights, m, v, scalars, param_dtype=None):
    """Plain version, out of place: (param_new, weights_new, m_new,
    v_new) in their storage dtypes (param_new is weights_new without a
    master)."""
    w_new, m_new, v_new = _adamw_math(grads, weights, m, v,
                                      *scalars.to(grads.device).unbind())
    w_out = w_new.to(weights.dtype)
    p_out = w_new.to(param_dtype) if _has_master(weights, param_dtype) \
        else w_out
    return p_out, w_out, m_new.to(m.dtype), v_new.to(v.dtype)


# the C entry of csrc/fused_adamw.cu: grads, w, m, v, p_out, scalars, n,
# grad_dtype, moment_dtype, stream
C_ARGTYPES = ([ctypes.c_void_p] * 6
              + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])


def _kernel_fn():
    fn = build.load(KERNEL_SOURCE).fused_adamw
    if fn.argtypes is None:
        fn.argtypes = C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(grads, weights, m, v, scalars, has_master):
    if weights.dtype != torch.float32:
        raise ValueError(f"the weight bucket must be float32 (a master or "
                         f"fp32 parameters), not {weights.dtype}")
    if grads.dtype not in _DTYPE_CODE or m.dtype not in _DTYPE_CODE \
            or v.dtype != m.dtype:
        raise ValueError(f"fused_adamw takes bfloat16/float32 grads and "
                         f"moments, not {grads.dtype}/{m.dtype}/{v.dtype}")
    if has_master != (grads.dtype == torch.bfloat16):
        raise ValueError("a master weight bucket goes with bfloat16 "
                         "parameters, fp32 parameters have none")
    for name, t in (("weights", weights), ("m", m), ("v", v)):
        if t.shape != grads.shape:
            raise ValueError(f"{name} bucket {tuple(t.shape)} != grads "
                             f"{tuple(grads.shape)}")
    if scalars.dtype != torch.float32 or scalars.numel() != N_SCALARS:
        raise ValueError(f"scalars must be {N_SCALARS} float32 values")
    for t in (grads, weights, m, v, scalars):
        if t.device != grads.device:
            raise ValueError(f"tensors on {t.device} and {grads.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_adamw needs contiguous, 16-byte "
                             "aligned buckets")


def fused_adamw_bucket(grads, weights, m, v, scalars, param_dtype=None):
    """One fused AdamW pass over a (rows, LANES) bucket, IN PLACE on
    `weights`, `m` and `v`.

    weights is the fp32 master bucket when `param_dtype` names a
    narrower parameter dtype (multi_precision), else the fp32 parameter
    bucket itself. Returns (param_new, weights, m, v); param_new is a new
    bucket in `param_dtype` with a master, else `weights`.
    """
    rows, lanes = grads.shape
    if lanes != LANES:
        raise ValueError(f"bucket lane dim must be {LANES}, got {lanes}")
    has_master = _has_master(weights, param_dtype)
    if grads.device.type == "cpu":
        p_new, w_new, m_new, v_new = fused_adamw_bucket_ref(
            grads, weights, m, v, scalars, param_dtype)
        weights.copy_(w_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return (p_new if has_master else weights), weights, m, v
    if grads.device.type != "cuda":
        raise ValueError(f"fused_adamw_bucket runs on cuda or cpu tensors, "
                         f"not {grads.device}")
    if has_master and param_dtype != torch.bfloat16:
        raise ValueError(f"parameter dtype {param_dtype} is not ported "
                         "(bfloat16 or float32)")
    scalars = scalars.to(grads.device, non_blocking=True)
    _check_cuda_args(grads, weights, m, v, scalars, has_master)
    p_new = torch.empty_like(grads) if has_master else weights
    with torch.cuda.device(grads.device):
        err = _kernel_fn()(
            grads.data_ptr(), weights.data_ptr(), m.data_ptr(), v.data_ptr(),
            p_new.data_ptr() if has_master else None, scalars.data_ptr(),
            grads.numel(), _DTYPE_CODE[grads.dtype], _DTYPE_CODE[m.dtype],
            torch.cuda.current_stream(grads.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: "
                           f"cudaError {err}")
    fused_adamw_bucket.launches += 1
    return p_new, weights, m, v


fused_adamw_bucket.launches = 0


def fused_adamw_zero1(*args, **kwargs):
    raise NotImplementedError("fused_adamw_zero1 (ZeRO-1 over a 'sharding' "
                              "mesh) is not ported to paddle_tpu_torch")
