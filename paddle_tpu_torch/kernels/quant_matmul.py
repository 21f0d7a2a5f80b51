"""Weight-only int8 dequant-matmul (port of
`paddle_tpu/kernels/quant_matmul.py`), the decode-path GEMM of
`wq="int8"` serving.

`quant_matmul(x2d, qw, scale)` computes x2d (M, K) @ dequant(qw (K, N)
int8, scale (N,) fp32) -> (M, N) in x2d's dtype. On CUDA tensors it
launches a hand-written Hopper kernel (each replaces the Pallas
`_kernel`; the source notes say what bounds it and how the design
answers) or raises. `quant_matmul_route` picks the kernel before the
launch, from the shape, the dtype and the alignment alone, and each
kernel counts its own launches:
  * bf16 decode rows (M <= 16) that TMA can address: the weight stream
    of `csrc/quant_decode_sm90.cu`, one balanced launch a call
    (`quant_decode_plan` sizes its grid, `quant_decode_split` is its
    split of the work in Python), in `.decode_launches`;
  * bf16 prefill rows (M > 16) that TMA can address: the wgmma kernel of
    `csrc/quant_matmul_sm90.cu` (`quant_prefill_plan` picks its tile
    rows and K splits), in `.prefill_launches`;
  * fp32 x, and shapes TMA cannot address at any M: `csrc/quant_matmul.cu`
    (its decode tile at M <= 16, its FMA and ragged mma.sync prefill
    tiles above), in `.launches`.
On CPU tensors it runs `quant_matmul_ref`, the plain version with the
kernels' numerics: fp32 accumulation of x.float() @ qw.float(), the
per-column scale once at the flush, then the cast.

`dequant_matmul` is the reference's scale-first composition
(`dequant_matmul_xla`): the weight is dequantized, then multiplied.
`pick_quant_blocks` keeps the reference's tiling rule only because the
reference's CPU dispatch (`nn/quant::_wint8_supported`) decides by it
which of the two compositions a shape takes; `nn/quant` asks it on the
CPU so that CPU results follow the reference's. Its VMEM sizing is the
TPU's and plays no part on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

__all__ = ["quant_matmul", "quant_matmul_ref", "dequant_matmul",
           "pick_quant_blocks", "quant_matmul_supported",
           "quant_matmul_route", "quant_prefill_plan", "quant_decode_plan",
           "quant_decode_split", "KERNEL_SOURCE", "SM90_SOURCE",
           "DECODE_SOURCE", "C_ARGTYPES", "SM90_C_ARGTYPES",
           "DECODE_C_ARGTYPES"]

KERNEL_SOURCE = "quant_matmul.cu"
SM90_SOURCE = "quant_matmul_sm90.cu"
DECODE_SOURCE = "quant_decode_sm90.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the reference's tiling rule (kernels/quant_matmul.py): divisor search
# ceilings, and its scoped-VMEM budget and estimator (analysis/vmem.py)
_BM_MAX, _BK_MAX, _BN_MAX = 256, 1024, 1024
_VMEM_BUDGET_BYTES = 16 * 1024 * 1024
_WIDTH = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _fits(bm, bk, bn, x_dtype) -> bool:
    """The reference's VMEM estimate of one grid step, double-buffered
    x / int8 weight / scale / out blocks, the fp32 accumulator and two
    fp32 copies of the largest block, against its 16 MiB budget."""
    xw = _WIDTH[x_dtype]
    blocks = [(bm * bk, xw), (bk * bn, 1), (bn, 4), (bm * bn, xw)]
    total = sum(2 * math.ceil(n * w) for n, w in blocks)
    total += bm * bn * 4
    total += 2 * max(n for n, _ in blocks) * 4
    return total <= _VMEM_BUDGET_BYTES


def _divisor_block(dim, cap, step):
    b = (min(dim, cap) // step) * step
    while b >= step:
        if dim % b == 0:
            return b
        b -= step
    return None


def pick_quant_blocks(M, K, N, x_dtype=torch.float32):
    """The reference's (bm, bk, bn) tiling for the TPU grid, or None when
    it has no legal one (whole-dim blocks, else divisors that are
    multiples of 8 / 128 / 128, shrunk K first, then N, then M, until
    the VMEM estimate fits)."""
    bm = M if M <= _BM_MAX else _divisor_block(M, _BM_MAX, 8)
    bk = K if K <= _BK_MAX else _divisor_block(K, _BK_MAX, 128)
    bn = N if N <= _BN_MAX else _divisor_block(N, _BN_MAX, 128)
    if bm is None or bk is None or bn is None:
        return None
    while not _fits(bm, bk, bn, x_dtype):
        for dim, cur, floor, step in (("k", bk, 128, 128),
                                      ("n", bn, 128, 128),
                                      ("m", bm, 8, 8)):
            if cur <= floor:
                continue
            cand = _divisor_block({"k": K, "n": N, "m": M}[dim], cur // 2,
                                  step)
            if cand is None:
                continue
            if dim == "k":
                bk = cand
            elif dim == "n":
                bn = cand
            else:
                bm = cand
            break
        else:
            return None
    return bm, bk, bn


def quant_matmul_supported(M, K, N, x_dtype=torch.float32) -> bool:
    """True when the reference's Pallas path has a legal tiling."""
    return pick_quant_blocks(M, K, N, x_dtype) is not None


def quant_matmul_ref(x2d, qw, scale):
    """Plain version with the kernel's numerics: x.float() @ qw.float()
    accumulated in fp32, the per-column scale applied once to the sum,
    then a cast to x's dtype."""
    acc = x2d.float() @ qw.float()
    return (acc * scale.float()[None, :]).to(x2d.dtype)


def dequant_matmul(x2d, qw, scale):
    """The scale-first composition (the reference's `dequant_matmul_xla`):
    materialize the fp32 weight qw * scale, then x.float() @ it, cast to
    x's dtype."""
    wf = qw.float() * scale.float()[None, :]
    return (x2d.float() @ wf).to(x2d.dtype)


def _check_cuda_args(x2d, qw, scale):
    M, K = x2d.shape
    if qw.dim() != 2 or qw.shape[0] != K or tuple(scale.shape) != \
            (qw.shape[1],):
        raise ValueError(f"shapes x {tuple(x2d.shape)}, qw "
                         f"{tuple(qw.shape)}, scale {tuple(scale.shape)} "
                         f"do not fit (M, K) @ (K, N) with (N,) scales")
    if x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"x dtype {x2d.dtype}: the kernel takes bfloat16 "
                         f"or float32")
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"qw must be int8 and scale float32, got "
                         f"{qw.dtype} / {scale.dtype}")
    for name, t in (("qw", qw), ("scale", scale)):
        if t.device != x2d.device:
            raise ValueError(f"{name} on {t.device}, x on {x2d.device}")
    for name, t in (("x", x2d), ("qw", qw), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x2d.shape + qw.shape) >= 2 ** 31 or M * qw.shape[1] >= 2 ** 31:
        raise ValueError("dimensions must fit in int32")


# decode rows (the batch bucket); more rows are a prefill chunk
DECODE_ROWS = 16
# csrc/quant_matmul_sm90.cu: output columns of a block, K depth of a stage
SM90_BN, SM90_BK = 128, 64
# csrc/quant_decode_sm90.cu: output columns and K rows of a work unit
DECODE_BN, DECODE_BK = 256, 64


def quant_matmul_route(M, K, N, x_dtype, aligned=True) -> str:
    """Which kernel a CUDA launch of (M, K) @ (K, N) takes, decided before
    the launch. bf16 x whose operands TMA can address (K a multiple of 8,
    N of 16, both bases 16-byte aligned) takes "decode_sm90" at M <= 16
    (`csrc/quant_decode_sm90.cu`) and "sm90" above
    (`csrc/quant_matmul_sm90.cu`). `csrc/quant_matmul.cu` keeps the rest:
    "decode" (M <= 16: fp32 x, or a shape TMA cannot address), "fp32"
    (fp32 x above 16 rows) and "mma" (its ragged bf16 prefill tile)."""
    addressable = x_dtype == torch.bfloat16 and K % 8 == 0 \
        and N % 16 == 0 and aligned
    if M <= DECODE_ROWS:
        return "decode_sm90" if addressable else "decode"
    if x_dtype != torch.bfloat16:
        return "fp32"
    return "sm90" if addressable else "mma"


def quant_prefill_plan(M, K, N, num_sms):
    """(bm, splits) of the sm90 route: the largest tile of bm rows (256,
    128 or 64, no larger than M needs) whose blocks fill 3/4 of the SMs;
    when even 64 rows leave the card short, K is split so the blocks come
    closer to one wave, each split at least 8 K tiles (512) deep and none
    empty."""
    cap = 64 if M <= 64 else 128 if M <= 128 else 256
    cols = -(-N // SM90_BN)
    for bm in (256, 128, 64):
        tiles = cols * -(-M // bm)
        if bm <= cap and tiles * 4 >= num_sms * 3:
            return bm, 1
    kt = -(-K // SM90_BK)
    splits = max(1, min(num_sms // tiles, kt // 8))
    per = -(-kt // splits)
    return 64, -(-kt // per)


def _decode_units(K, N):
    """(column tiles, K units a tile) of the decode_sm90 route."""
    return -(-N // DECODE_BN), -(-K // DECODE_BK)


def quant_decode_plan(M, K, N, num_sms) -> int:
    """CTAs of a decode_sm90 launch: one an SM, never more than the work
    units (column tiles x K units). Shapes only."""
    tiles, kt = _decode_units(K, N)
    return max(1, min(num_sms, tiles * kt))


def quant_decode_split(K, N, ctas):
    """The split every CTA of the decode_sm90 kernel computes, in Python:
    (runs, merges). Units are numbered column tile by column tile, K
    inside; the first U % ctas CTAs take U // ctas + 1 units, the others
    U // ctas, each a contiguous run. runs[i] lists CTA i's segments as
    (tile, first K unit, end K unit, slot): slot None for a tile it
    covers alone (flushed by it), else the workspace slot of its partial
    (0 for its first tile, 1 for its last). merges maps each shared tile
    to its parts [(cta, slot)] in the order the merging CTA adds them:
    the owners of the tile's first to last unit, that is K order."""
    tiles, kt = _decode_units(K, N)
    units = tiles * kt
    base, rem = divmod(units, ctas)

    def start(i):
        return i * base + min(i, rem)

    def owner(u):
        big = rem * (base + 1)
        return u // (base + 1) if u < big else rem + (u - big) // base

    runs = []
    for i in range(ctas):
        segs, u, u1 = [], start(i), start(i + 1)
        while u < u1:
            tile = u // kt
            end = min(u1, (tile + 1) * kt)
            whole = u == tile * kt and end == (tile + 1) * kt
            slot = None if whole else 0 if start(i) // kt == tile else 1
            segs.append((tile, u - tile * kt, end - tile * kt, slot))
            u = end
        runs.append(segs)
    merges = {}
    for tile in range(tiles):
        first, last = owner(tile * kt), owner((tile + 1) * kt - 1)
        if first != last:
            merges[tile] = [(j, 0 if start(j) // kt == tile else 1)
                            for j in range(first, last + 1)]
    return runs, merges


# the C entries of csrc/quant_matmul.cu:
#   quant_matmul(x, q, scale, out, ws, M, K, N, splits, dtype, stream)
#   quant_matmul_splits(M, K, N, num_sms)
C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
C_SPLITS_ARGTYPES = [ctypes.c_int] * 4
# csrc/quant_matmul_sm90.cu:
#   quant_matmul_sm90(x, q, scale, out, ws, M, K, N, bm, splits, stream)
SM90_C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
# csrc/quant_decode_sm90.cu:
#   quant_decode_sm90(x, q, scale, out, ws, tickets, M, K, N, ctas, stream)
DECODE_C_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# fp32 workspace of the decode_sm90 route per CTA: two slots of 256
# consumer threads x up to 16 sums
_DECODE_WS_PER_CTA = 2 * 256 * 16
# per device: the decode_sm90 route's scratch — its fp32 workspace (a
# launch reads back all it writes, so launches in one stream's order
# share it) and its merge's ticket counters, one per column tile (zeroed
# once; each launch leaves them 0). Not for concurrent launches on
# several streams.
_DECODE_SCRATCH = {}


def _kernel_lib():
    lib = build.load(KERNEL_SOURCE)
    if lib.quant_matmul.argtypes is None:
        lib.quant_matmul.argtypes = C_ARGTYPES
        lib.quant_matmul.restype = ctypes.c_int
        lib.quant_matmul_splits.argtypes = C_SPLITS_ARGTYPES
        lib.quant_matmul_splits.restype = ctypes.c_int
    return lib


def _sm90_entry():
    fn = build.load(SM90_SOURCE).quant_matmul_sm90
    if fn.argtypes is None:
        fn.argtypes = SM90_C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _decode_entry():
    fn = build.load(DECODE_SOURCE).quant_decode_sm90
    if fn.argtypes is None:
        fn.argtypes = DECODE_C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _decode_scratch(device, ctas, tiles):
    """(ws, tickets) of a decode_sm90 launch on `device`."""
    ws, tickets = _DECODE_SCRATCH.get(device, (None, None))
    if ws is None or ws.numel() < ctas * _DECODE_WS_PER_CTA:
        ws = torch.empty(ctas * _DECODE_WS_PER_CTA, dtype=torch.float32,
                         device=device)
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=device)
    _DECODE_SCRATCH[device] = (ws, tickets)
    return ws, tickets


def quant_matmul(x2d, qw, scale):
    """x2d (M, K) bf16/fp32 @ dequant(qw (K, N) int8, scale (N,) fp32)
    -> (M, N) in x2d's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel `quant_matmul_route` names or raise. Each
    kernel counts its launches: `.decode_launches` (decode_sm90),
    `.prefill_launches` (sm90), `.launches` (quant_matmul.cu)."""
    if x2d.device.type == "cpu":
        return quant_matmul_ref(x2d, qw, scale)
    if x2d.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu tensors, not "
                         f"{x2d.device}")
    _check_cuda_args(x2d, qw, scale)
    M, K = x2d.shape
    N = qw.shape[1]
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    aligned = x2d.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0
    route = quant_matmul_route(M, K, N, x2d.dtype, aligned)
    with torch.cuda.device(x2d.device):
        sms = torch.cuda.get_device_properties(x2d.device) \
            .multi_processor_count
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        if route == "decode_sm90":
            ctas = quant_decode_plan(M, K, N, sms)
            ws, tickets = _decode_scratch(x2d.device, ctas,
                                          _decode_units(K, N)[0])
            err = _decode_entry()(x2d.data_ptr(), qw.data_ptr(),
                                  scale.data_ptr(), out.data_ptr(),
                                  ws.data_ptr(), tickets.data_ptr(),
                                  M, K, N, ctas, stream)
            if err != 0:
                raise RuntimeError(f"quant_decode_sm90 kernel launch "
                                   f"failed: cudaError {err}")
            quant_matmul.decode_launches += 1
            return out
        if route == "sm90":
            bm, splits = quant_prefill_plan(M, K, N, sms)
            ws = (torch.empty((splits, M, N), dtype=torch.float32,
                              device=x2d.device) if splits > 1 else None)
            err = _sm90_entry()(x2d.data_ptr(), qw.data_ptr(),
                                scale.data_ptr(), out.data_ptr(),
                                ws.data_ptr() if ws is not None else None,
                                M, K, N, bm, splits, stream)
            if err != 0:
                raise RuntimeError(f"quant_matmul_sm90 kernel launch "
                                   f"failed: cudaError {err}")
            quant_matmul.prefill_launches += 1
            return out
        lib = _kernel_lib()
        splits = lib.quant_matmul_splits(M, K, N, sms)
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=x2d.device) if splits > 1 else None)
        err = lib.quant_matmul(x2d.data_ptr(), qw.data_ptr(),
                               scale.data_ptr(), out.data_ptr(),
                               ws.data_ptr() if ws is not None else None,
                               M, K, N, splits, _DTYPE_CODE[x2d.dtype],
                               stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError "
                           f"{err}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = quant_matmul.prefill_launches = 0
quant_matmul.decode_launches = 0
