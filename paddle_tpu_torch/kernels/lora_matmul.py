"""Batched heterogeneous-adapter LoRA delta (port of
`paddle_tpu/kernels/lora_matmul.py`), the delta GEMM of multi-LoRA
serving: every row of one launch applies its OWN adapter,

    delta_b = (x_b @ A[id_b]) @ Bs[id_b]

x (rows, H) bf16/fp32, ids (rows,) int32 slot ids, A (S, H, R) fp32, Bs
(S, R, N) fp32 with the per-slot alpha/rank scaling folded in by the
caller (`serving/lora/runtime.py`) -> (rows, N) fp32. Slot 0 is the null
adapter: its rows (and rows whose id names no slot) get exact 0.0.

`lora_matmul` launches, on CUDA tensors, the two hand-written Hopper
kernels of `csrc/lora_matmul.cu` (they replace the Pallas `_kernel`; the
source note says what bounds them and how the design answers):
`lora_shrink` (x @ A[id] as fp32 partial sums over H chunks) then
`lora_expand` (the chunk sums @ Bs[id]), each counted in its own
`.launches`, for every shape with R <= MAX_KERNEL_RANK, or raises. On
CPU tensors it runs `lora_matmul_ref`, the plain version of the TPU
kernel: for every slot the full x @ A[s] @ Bs[s] in fp32, kept on the
rows whose id is s. Either way a row's delta depends on nothing but its
own x and its own slot's weights, bit for bit.

`lora_matmul_gathered` is the reference's `lora_matmul_xla` (gather each
row's A and Bs, two batched contractions), which the reference's CPU
dispatch takes for prefill chunks and untileable shapes.
`pick_lora_blocks` keeps the reference's tiling rule only so that the
CPU dispatch (`serving/lora/runtime.py`) picks the same composition as
the reference; its VMEM sizing is the TPU's and plays no part on the
card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

__all__ = ["lora_matmul", "lora_matmul_ref", "lora_matmul_gathered",
           "lora_shrink", "lora_shrink_ref", "lora_expand",
           "lora_expand_ref", "lora_chunks", "pick_lora_blocks",
           "lora_matmul_supported", "MAX_KERNEL_RANK", "HCHUNK",
           "KERNEL_SOURCE", "C_SHRINK_ARGTYPES", "C_EXPAND_ARGTYPES"]

KERNEL_SOURCE = "lora_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# ranks past this have left low-rank territory (the reference's ceiling;
# also the kernels' block width)
MAX_KERNEL_RANK = 256
# H elements one lora_shrink block reduces (the kernels' partial sums)
HCHUNK = 512

# the reference's tiling rule (kernels/lora_matmul.py): divisor search
# ceilings and its scoped-VMEM budget and estimator (analysis/vmem.py)
_BK_MAX = 2048
_BN_MAX = 2048
_VMEM_BUDGET_BYTES = 16 * 1024 * 1024
_WIDTH = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _fits(b, bk, r, bn, x_dtype) -> bool:
    """The reference's VMEM estimate of one grid step: double-buffered x,
    A, Bs, id-row and out blocks, the (B, R) fp32 accumulator and two
    fp32 copies of the largest block, against its 16 MiB budget."""
    blocks = [(b * bk, _WIDTH[x_dtype]), (bk * r, 4), (r * bn, 4), (b, 4),
              (b * bn, 4)]
    total = sum(2 * math.ceil(n * w) for n, w in blocks)
    total += b * r * 4
    total += 2 * max(n for n, _ in blocks) * 4
    return total <= _VMEM_BUDGET_BYTES


def _divisor_block(dim, cap, step):
    blk = (min(dim, cap) // step) * step
    while blk >= step:
        if dim % blk == 0:
            return blk
        blk -= step
    return None


def pick_lora_blocks(B, H, R, N, x_dtype=torch.float32):
    """The reference's (bk, bn) tiling of the TPU grid, or None when it
    has no legal one (then the reference takes `lora_matmul_xla`)."""
    if R > MAX_KERNEL_RANK:
        return None
    bk = H if H <= _BK_MAX else _divisor_block(H, _BK_MAX, 128)
    bn = N if N <= _BN_MAX else _divisor_block(N, _BN_MAX, 128)
    if bk is None or bn is None:
        return None
    while not _fits(B, bk, R, bn, x_dtype):
        for dim, cur in (("k", bk), ("n", bn)):
            if cur <= 128:
                continue
            cand = _divisor_block(H if dim == "k" else N, cur // 2, 128)
            if cand is None:
                continue
            if dim == "k":
                bk = cand
            else:
                bn = cand
            break
        else:
            return None
    return bk, bn


def lora_matmul_supported(B, H, R, N, x_dtype=torch.float32) -> bool:
    """True when the reference's Pallas path has a legal tiling."""
    return pick_lora_blocks(B, H, R, N, x_dtype) is not None


def lora_chunks(H: int) -> int:
    """How many H chunks `lora_shrink` splits a row's reduction into."""
    return -(-int(H) // HCHUNK)


def _valid(ids, S):
    """Rows whose id names a real slot (not the null slot 0)."""
    return (ids > 0) & (ids < S)


# ---------------------------------------------------------- plain versions
def lora_matmul_ref(x2d, ids, a_stack, b_stack):
    """Plain version of the TPU kernel: for every slot s >= 1 the full
    (x.float() @ A[s]) @ Bs[s], kept on the rows whose id is s; every
    other row (slot 0, no slot) stays exact 0.0. A row's result does not
    depend on the other rows' ids or the other slots' weights."""
    xf = x2d.float()
    out = torch.zeros((x2d.shape[0], b_stack.shape[2]), dtype=torch.float32,
                      device=x2d.device)
    for s in range(1, a_stack.shape[0]):
        contrib = (xf @ a_stack[s]) @ b_stack[s]
        out = torch.where((ids == s)[:, None], contrib, out)
    return out


def lora_matmul_gathered(x2d, ids, a_stack, b_stack):
    """The reference's gathered composition (`lora_matmul_xla`): each
    row's A and Bs gathered, x @ A[id] then @ Bs[id] in fp32. ids must
    lie in [0, S)."""
    idx = ids.long()
    xa = torch.einsum("bh,bhr->br", x2d.float(), a_stack[idx])
    return torch.einsum("br,brn->bn", xa, b_stack[idx])


def lora_shrink_ref(x2d, ids, a_stack):
    """Plain version of the shrink kernel: (rows, lora_chunks(H), R) fp32
    partial sums of x[b, chunk] @ A[id_b][chunk]; zeros for rows whose id
    names no real slot."""
    S = a_stack.shape[0]
    valid = _valid(ids, S)
    a_g = a_stack[torch.where(valid, ids, 0).long()]
    xf = x2d.float()[:, None, :]
    part = torch.stack([torch.bmm(xf[..., c:c + HCHUNK],
                                  a_g[:, c:c + HCHUNK])[:, 0]
                        for c in range(0, x2d.shape[1], HCHUNK)], dim=1)
    return torch.where(valid[:, None, None], part, 0.0)


def lora_expand_ref(part, ids, b_stack):
    """Plain version of the expand kernel: the chunk sums (in chunk order)
    @ Bs[id_b] in fp32; zeros for rows whose id names no real slot."""
    S = b_stack.shape[0]
    valid = _valid(ids, S)
    xa = part[:, 0]
    for c in range(1, part.shape[1]):
        xa = xa + part[:, c]
    out = torch.bmm(xa[:, None], b_stack[torch.where(valid, ids, 0).long()])
    return torch.where(valid[:, None], out[:, 0], 0.0)


# ------------------------------------------------------------ the kernels
# the C entries of csrc/lora_matmul.cu:
#   lora_shrink(x, ids, a, part, rows, H, R, S, hchunk, dtype, stream)
#   lora_expand(part, ids, bs, out, rows, N, R, S, chunks, stream)
C_SHRINK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
C_EXPAND_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


def _kernel_lib():
    lib = build.load(KERNEL_SOURCE)
    if lib.lora_shrink.argtypes is None:
        lib.lora_shrink.argtypes = C_SHRINK_ARGTYPES
        lib.lora_shrink.restype = ctypes.c_int
        lib.lora_expand.argtypes = C_EXPAND_ARGTYPES
        lib.lora_expand.restype = ctypes.c_int
    return lib


def _check_common(name, ids, stack, rows, dev):
    if ids.dim() != 1 or ids.shape[0] != rows or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be ({rows},) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError(f"{name}: the slot stack must be 3-D float32, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    for what, t in (("ids", ids), ("stack", stack)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, input on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if max(stack.shape) >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"{name}: dimensions must fit in int32")


def _check_rank(name, R):
    if not 1 <= R <= MAX_KERNEL_RANK:
        raise ValueError(f"{name}: rank {R} outside [1, {MAX_KERNEL_RANK}]: "
                         f"the kernel takes ranks up to {MAX_KERNEL_RANK}")


def _on_cuda(name, t):
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{t.device}")
    return False


def lora_shrink(x2d, ids, a_stack):
    """(rows, lora_chunks(H), R) fp32 partial sums of x @ A[id]. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted in `.launches`) or raise."""
    if not _on_cuda("lora_shrink", x2d):
        return lora_shrink_ref(x2d, ids, a_stack)
    rows, H = x2d.shape
    _check_common("lora_shrink", ids, a_stack, rows, x2d.device)
    S, Ha, R = a_stack.shape
    if Ha != H:
        raise ValueError(f"lora_shrink: x {tuple(x2d.shape)} does not fit "
                         f"A {tuple(a_stack.shape)}")
    if x2d.dtype not in _DTYPE_CODE or not x2d.is_contiguous():
        raise ValueError(f"lora_shrink: x must be contiguous bfloat16 or "
                         f"float32, got {x2d.dtype}")
    _check_rank("lora_shrink", R)
    part = torch.empty((rows, lora_chunks(H), R), dtype=torch.float32,
                       device=x2d.device)
    if rows == 0 or H == 0:
        return part.zero_()
    lib = _kernel_lib()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.lora_shrink(x2d.data_ptr(), ids.data_ptr(),
                              a_stack.data_ptr(), part.data_ptr(), rows, H,
                              R, S, HCHUNK, _DTYPE_CODE[x2d.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lora_shrink kernel launch failed: cudaError "
                           f"{err}")
    lora_shrink.launches += 1
    return part


def lora_expand(part, ids, b_stack):
    """(rows, N) fp32: lora_shrink's chunk sums @ Bs[id]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    `.launches`) or raise."""
    if not _on_cuda("lora_expand", part):
        return lora_expand_ref(part, ids, b_stack)
    if part.dim() != 3 or part.dtype != torch.float32 or \
            not part.is_contiguous():
        raise ValueError("lora_expand: partial sums must be contiguous "
                         "(rows, chunks, R) float32")
    rows, chunks, R = part.shape
    _check_common("lora_expand", ids, b_stack, rows, part.device)
    S, Rb, N = b_stack.shape
    if Rb != R:
        raise ValueError(f"lora_expand: rank {R} does not fit Bs "
                         f"{tuple(b_stack.shape)}")
    _check_rank("lora_expand", R)
    out = torch.empty((rows, N), dtype=torch.float32, device=part.device)
    if rows == 0 or N == 0:
        return out
    if chunks == 0:
        return out.zero_()
    lib = _kernel_lib()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = lib.lora_expand(part.data_ptr(), ids.data_ptr(),
                              b_stack.data_ptr(), out.data_ptr(), rows, N, R,
                              S, chunks, stream)
    if err != 0:
        raise RuntimeError(f"lora_expand kernel launch failed: cudaError "
                           f"{err}")
    lora_expand.launches += 1
    return out


lora_shrink.launches = 0
lora_expand.launches = 0


def lora_matmul(x2d, ids, a_stack, b_stack):
    """x2d (rows, H) bf16/fp32; ids (rows,) int32 slot ids; a_stack
    (S, H, R) fp32; b_stack (S, R, N) fp32 with the scaling folded in ->
    (rows, N) fp32 delta. CPU tensors take `lora_matmul_ref`; CUDA
    tensors launch lora_shrink then lora_expand, or raise (R above
    MAX_KERNEL_RANK included: there is no fallback)."""
    if not _on_cuda("lora_matmul", x2d):
        return lora_matmul_ref(x2d, ids, a_stack, b_stack)
    if a_stack.shape[:1] != b_stack.shape[:1] or \
            a_stack.shape[2:] != b_stack.shape[1:2]:
        raise ValueError(f"lora_matmul: A {tuple(a_stack.shape)} and Bs "
                         f"{tuple(b_stack.shape)} do not share (S, R)")
    return lora_expand(lora_shrink(x2d, ids, a_stack), ids, b_stack)
