"""Flash attention forward and backward (port of
`paddle_tpu/kernels/flash_attention.py`, the plain-causal core).

Layout: the public `flash_attention_bshd` takes (B, S, H, D) like the
reference; the three kernel entries work on (B*H, S, D) contiguous.
Causal is bottom-right aligned (key j visible to query i iff
j <= i + Sk - Sq), never torch's top-left `is_causal`. The forward
returns the output and the fp32 logsumexp (B*H, Sq); the backward
recomputes probabilities from that lse, with delta = rowsum(dO * O)
computed as a plain op outside the kernels, as in the reference.

Each entry — `flash_fwd`, `flash_dq`, `flash_dkv` — launches its
hand-written Hopper kernel from `csrc/flash_attention.cu` on a CUDA
tensor (counted in `.launches`) or raises; on a CPU tensor it runs the
plain PyTorch version beside it (`flash_fwd_ref`, `flash_dq_ref`,
`flash_dkv_ref`: fp32 math, a masked score is NEG_INF and contributes
exactly 0, the softmax sum clamped at 1e-30, so a row that sees no key
gives zeros). `FlashAttention` is the autograd Function over them.

Not ported: the varlen (segment-id) and flashmask variants, and the
reference's TPU block autotuner (the CUDA kernels pick their own tiles).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

__all__ = ["flash_attention_bshd", "FlashAttention", "flash_fwd", "flash_dq",
           "flash_dkv", "flash_fwd_ref", "flash_dq_ref", "flash_dkv_ref",
           "flash_delta", "check_supported", "NEG_INF", "KERNEL_SOURCE"]

KERNEL_SOURCE = "flash_attention.cu"
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_supported(q_shape, k_shape, dtype):
    """The reference's TPU rules: head_dim a multiple of 8 and at most
    256, sequence lengths multiples of 8, and above 1024 multiples of
    128. Raises ValueError otherwise (the CPU's SDPA dispatch then takes
    the plain composition). Applied to CPU tensors only: the CUDA kernels
    take any length, and `_check_cuda_args` holds their own limits."""
    B, Sq, H, D = q_shape
    Sk = k_shape[1]
    if D > 256 or D % 8 != 0:
        raise ValueError(f"head_dim {D} unsupported")
    if Sq % 8 != 0 or Sk % 8 != 0:
        raise ValueError("seq len must be multiple of 8")
    if Sq % 128 != 0 and Sq > 1024:
        raise ValueError("long Sq must be a multiple of 128")
    if Sk % 128 != 0 and Sk > 1024:
        raise ValueError("long Sk must be a multiple of 128")


# ------------------------------------------------------- plain versions
def _probs(q, k, lse, sm_scale, causal):
    """fp32 scores (BH, Sq, Sk) with the causal mask as NEG_INF, and the
    visibility mask (None when nothing is masked). With `lse` given,
    also exp(s - lse) with masked entries exactly 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    keep = None
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        keep = kpos <= qpos + (Sk - Sq)
        s = s.masked_fill(~keep, NEG_INF)
    if lse is None:
        return s, keep
    p = torch.exp(s - lse[..., None])
    return (p if keep is None else p.masked_fill(~keep, 0.0)), keep


def flash_fwd_ref(q, k, v, sm_scale, causal):
    """(BH, Sq, D), (BH, Sk, D) x2 -> out (BH, Sq, D) in q's dtype and
    lse (BH, Sq) fp32."""
    s, keep = _probs(q, k, None, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_delta(out, dout):
    """delta = rowsum(dO * O) in fp32, (BH, Sq) — a plain op, as in the
    reference's backward."""
    return (dout.float() * out.float()).sum(dim=-1)


def _dscores(q, k, v, dout, lse, delta, sm_scale, causal):
    p, _ = _probs(q, k, lse, sm_scale, causal)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_dq_ref(q, k, v, dout, lse, delta, sm_scale, causal):
    """dQ (BH, Sq, D) in q's dtype, from the saved lse and delta."""
    _, ds = _dscores(q, k, v, dout, lse, delta, sm_scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_dkv_ref(q, k, v, dout, lse, delta, sm_scale, causal):
    """(dK, dV), each (BH, Sk, D) in k's / v's dtype."""
    p, ds = _dscores(q, k, v, dout, lse, delta, sm_scale, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernels
# the C entries of csrc/flash_attention.cu (pointers and the stream as
# c_void_p: a bare int would be cut to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
C_ARGTYPES = {
    # q, k, v, out, lse, BH, Sq, Sk, D, scale, causal, dtype, stream
    "flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D, scale, causal, dtype,
    # stream
    "flash_attention_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, D, scale, causal,
    # dtype, stream
    "flash_attention_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P],
}


def _entry(name):
    fn = getattr(build.load(KERNEL_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = C_ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k, v, *rest):
    """What the kernels take: one card, bf16 or fp32 throughout (lse and
    delta fp32), contiguous (BH, S, D) with 16-byte aligned storage."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention kernels take bfloat16 or float32, "
                         f"not {q.dtype}")
    BH, Sq, D = q.shape
    if k.dim() != 3 or k.shape[0] != BH or k.shape[2] != D \
            or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if D > 256 or D % 8 != 0:
        raise ValueError(f"head_dim {D} unsupported (multiple of 8, <= 256)")
    if BH > 65535:
        raise ValueError(f"B*H = {BH} > 65535 blocks")
    for t in (q, k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous "
                             "tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernels need 16-byte aligned "
                             "storage")
    for t in (k, v) + rest[:1]:          # dout shares q's dtype
        if t.dtype != q.dtype:
            raise ValueError(f"dtype {t.dtype} != q dtype {q.dtype}")
    for t in rest[1:]:                   # lse, delta
        if t.dtype != torch.float32 or tuple(t.shape) != (BH, Sq):
            raise ValueError("lse/delta must be float32 (B*H, Sq)")


def _device_kind(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return q.device.type


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, sm_scale, causal):
    """Forward: (out (BH, Sq, D), lse (BH, Sq) fp32)."""
    if _device_kind(q, "flash_fwd") == "cpu":
        return flash_fwd_ref(q, k, v, sm_scale, causal)
    _check_cuda_args(q, k, v)
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _entry("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), BH, Sq, k.shape[1], D, float(sm_scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, sm_scale, causal):
    """dQ (BH, Sq, D) in q's dtype."""
    if _device_kind(q, "flash_dq") == "cpu":
        return flash_dq_ref(q, k, v, dout, lse, delta, sm_scale, causal)
    _check_cuda_args(q, k, v, dout, lse, delta)
    BH, Sq, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry("flash_attention_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, Sq,
            k.shape[1], D, float(sm_scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_dq kernel launch failed: "
                           f"cudaError {err}")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, sm_scale, causal):
    """(dK, dV), each (BH, Sk, D) in k's dtype."""
    if _device_kind(q, "flash_dkv") == "cpu":
        return flash_dkv_ref(q, k, v, dout, lse, delta, sm_scale, causal)
    _check_cuda_args(q, k, v, dout, lse, delta)
    BH, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _entry("flash_attention_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, Sq, k.shape[1], D, float(sm_scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_dkv kernel launch failed: "
                           f"cudaError {err}")
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention over (BH, S, D) with the flash backward: the forward
    saves (q, k, v, out, lse); the backward runs the dQ and dK/dV
    entries (the reference's `_flash_core` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        out, lse = flash_fwd(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        args = (q, k, v, dout, lse, delta, ctx.sm_scale, ctx.causal)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return dq, dk, dv, None, None


def _to_bhsd(x):
    B, S, H, D = x.shape
    # at B == 1 the reshape is a strided view, so ask for the copy
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None):
    """q (B, Sq, H, D), k/v (B, Sk, H, D) -> out (B, Sq, H, D), with the
    flash backward under autograd. CPU tensors must pass the reference's
    `check_supported`; CUDA tensors the kernels' own limits."""
    B, Sq, H, D = q.shape
    if not q.is_cuda:
        check_supported(tuple(q.shape), tuple(k.shape), q.dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = FlashAttention.apply(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v),
                               float(sm_scale), bool(causal))
    return out.reshape(B, H, Sq, D).transpose(1, 2)
