"""RMSNorm over rows (port of `paddle_tpu/kernels/fused_norm.py`).

`rms_norm_rows(x, weight, residual=None, eps=1e-6)` normalises each row
of a 2-D (R, H) array in fp32, in the reference kernel's op order: x
(plus the residual, added in fp32), var = mean(x²), y = x · rsqrt(var +
eps), then (y · weight.float()) cast to x's dtype. That differs from
`nn/functional/norm.py::rms_norm`, which casts before the weight product.
On a CUDA tensor it launches the hand-written Hopper kernel of
`csrc/fused_norm.cu` (counted in `.launches`) for any H, or raises; on a
CPU tensor it runs the plain version `rms_norm_rows_ref`, after the
reference's `check_supported_rms` (H % 128 == 0, bf16 or fp32 — a TPU
tiling rule, applied on the CPU only). The reference's `pick_block_rows`
sizes TPU VMEM blocks and is not ported.

Forward only, as in the reference: no backward is registered, so a call
whose input requires a gradient raises rather than drop it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["rms_norm_rows", "rms_norm_rows_ref", "check_supported_rms",
           "KERNEL_SOURCE", "C_ARGTYPES"]

KERNEL_SOURCE = "fused_norm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, residual, weight, out, R, H, eps, dtype, wdtype, stream
C_ARGTYPES = [_P] * 4 + [_I, _I, _F, _I, _I, _P]


def check_supported_rms(shape, dtype):
    """The reference's rule: H a multiple of 128, bf16 or fp32. Raises
    ValueError otherwise."""
    r, h = shape
    if h % 128 != 0:
        raise ValueError(f"pallas rms_norm needs H % 128 == 0, got {h}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {dtype}")


def rms_norm_rows_ref(x, weight, residual=None, eps=1e-6):
    """The plain version, in the reference kernel's fp32 op order."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _entry():
    fn = build.load(KERNEL_SOURCE).rms_norm_rows
    if fn.argtypes is None:
        fn.argtypes = C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(x, weight, residual):
    if x.dim() != 2:
        raise ValueError(f"rms_norm_rows takes a 2-D (R, H) array, not "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm_rows takes bfloat16 or float32, not "
                         f"x {x.dtype} / weight {weight.dtype}")
    R, H = x.shape
    if tuple(weight.shape) != (H,):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit H {H}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual {residual.dtype} {tuple(residual.shape)}"
                         f" does not match x {x.dtype} {tuple(x.shape)}")
    if R >= 2 ** 31 or H >= 2 ** 31:
        raise ValueError(f"({R}, {H}) is more than the kernel's int32 "
                         f"rows and columns take")
    for t in (x, weight) + ((residual,) if residual is not None else ()):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("rms_norm_rows needs contiguous tensors")


def rms_norm_rows(x, weight, residual=None, eps=1e-6):
    """x (R, H) -> (R, H) in x's dtype (see the module docstring)."""
    tensors = (x, weight) + ((residual,) if residual is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("rms_norm_rows has no backward (the reference "
                           "registers none); call it under torch.no_grad() "
                           "or on tensors that do not require grad")
    if x.device.type == "cpu":
        check_supported_rms(tuple(x.shape), x.dtype)
        return rms_norm_rows_ref(x, weight, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_rows runs on cuda or cpu tensors, not "
                         f"{x.device}")
    _check_cuda_args(x, weight, residual)
    out = torch.empty_like(x)
    R, H = x.shape
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(),
                       residual.data_ptr() if residual is not None else None,
                       weight.data_ptr(), out.data_ptr(), R, H, float(eps),
                       _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm_rows kernel launch failed: "
                           f"cudaError {err}")
    rms_norm_rows.launches += 1
    return out


rms_norm_rows.launches = 0
