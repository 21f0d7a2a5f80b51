"""Batched heterogeneous-adapter LoRA delta (port of
`paddle_tpu/kernels/lora_matmul.py`), the delta GEMM of multi-LoRA
serving: every row of one launch applies its OWN adapter,

    delta_b = (x_b @ A[id_b]) @ Bs[id_b]

x (rows, H) bf16/fp32, ids (rows,) int32 slot ids, A (S, H, R) fp32, Bs
(S, R, N) fp32 with the per-slot alpha/rank scaling folded in by the
caller (`serving/lora/runtime.py`) -> (rows, N) fp32. Slot 0 is the null
adapter: its rows (and rows whose id names no slot) get exact 0.0.

`lora_apply(x2d, y2d, row_slots, buckets)` is one projection of one
launch: every rank bucket's delta summed in fp32, rounded to y's dtype
and added to y (the reference's `LoRAContext.delta` and `apply_lora`
together). On CUDA tensors it launches the hand-written Hopper kernel of
`csrc/lora_matmul.cu` once (it replaces the Pallas `_kernel` and the
composition around it; the source note says what bounds it and how the
design answers), counted in `lora_apply.launches`, or raises. On CPU
tensors it runs `lora_apply_ref`, the composition the reference runs,
with its dispatch: single-token rows on a shape its tiling rule takes go
through `lora_matmul_ref` (the plain version of the TPU kernel: for
every slot the full x @ A[s] @ Bs[s] in fp32, kept on the rows whose id
is s), everything else through `lora_matmul_gathered` (the reference's
`lora_matmul_xla`). Either way a row's result depends on nothing but its
own x, its own y and its own slot's weights, bit for bit.

`lora_matmul(x2d, ids, a_stack, b_stack)` is the delta of one bucket:
the kernel's delta-only instantiation on CUDA tensors, `lora_matmul_ref`
on CPU ones. `lora_groups` is the kernel's grouping of rows by slot in
Python and `lora_apply_plan` its grid, from the shapes alone.
`lora_shrink_ref` / `lora_expand_ref` split the delta at the rank (H in
HCHUNK chunks), as the port's first kernels did; the CPU tests hold them
against the reference. `pick_lora_blocks` keeps the reference's tiling
rule only so that the CPU dispatch picks the reference's composition; its
VMEM sizing is the TPU's and plays no part on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from . import build

__all__ = ["lora_apply", "lora_apply_ref", "lora_matmul", "lora_matmul_ref",
           "lora_matmul_gathered", "lora_shrink_ref", "lora_expand_ref",
           "lora_chunks", "pick_lora_blocks", "lora_matmul_supported",
           "LoRABuckets", "lora_groups", "lora_apply_plan", "lora_rank_pad",
           "MAX_KERNEL_RANK", "MAX_BUCKETS", "MAX_KEYS", "HCHUNK",
           "KERNEL_SOURCE", "C_APPLY_ARGTYPES"]

KERNEL_SOURCE = "lora_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# ranks past this have left low-rank territory (the reference's ceiling;
# also the kernel's thread count)
MAX_KERNEL_RANK = 256
# the kernel's limits: rank buckets a launch takes, and live (bucket,
# slot) keys plus the null key
MAX_BUCKETS = 8
MAX_KEYS = 1024
# H elements a chunk of the plain shrink reduces
HCHUNK = 512
# the kernel's plan: the largest thread-block cluster (the portable size),
# the least H a cluster rank reduces and the least columns a CTA expands
MAX_CLUSTER = 8
H_PER_CTA = 256
COLS_PER_CTA = 128
# the grid a launch aims for, in CTAs an SM: the kernel fits two an SM,
# and clusters of 8 on the card's GPCs leave room for about 1.7
CTAS_PER_SM = 1.6

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
    """How many H chunks `lora_shrink_ref` splits a row's reduction
    into."""
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
    """The delta's first half: (rows, lora_chunks(H), R) fp32 partial
    sums of x[b, chunk] @ A[id_b][chunk]; zeros for rows whose id names
    no real slot."""
    S = a_stack.shape[0]
    valid = _valid(ids, S)
    a_g = a_stack[torch.where(valid, ids, 0).long()]
    xf = x2d.float()[:, None, :]
    part = torch.stack([torch.bmm(xf[..., c:c + HCHUNK],
                                  a_g[:, c:c + HCHUNK])[:, 0]
                        for c in range(0, x2d.shape[1], HCHUNK)], dim=1)
    return torch.where(valid[:, None, None], part, 0.0)


def lora_expand_ref(part, ids, b_stack):
    """The delta's second half: the chunk sums (in chunk order) @
    Bs[id_b] in fp32; zeros for rows whose id names no real slot."""
    S = b_stack.shape[0]
    valid = _valid(ids, S)
    xa = part[:, 0]
    for c in range(1, part.shape[1]):
        xa = xa + part[:, c]
    out = torch.bmm(xa[:, None], b_stack[torch.where(valid, ids, 0).long()])
    return torch.where(valid[:, None], out[:, 0], 0.0)


class LoRABuckets:
    """The rank buckets of one projection, checked once: a sequence of
    (A (S, H, R), Bs (S, R, N), first global slot), the first slots
    ascending and the slot ranges disjoint, every stack float32,
    contiguous, on one device, with one H and one N. A launch context
    builds one per module and reuses it for every layer."""

    def __init__(self, buckets):
        self.stacks = tuple((a, b, int(first)) for a, b, first in buckets)
        if not self.stacks:
            raise ValueError("lora_apply: no rank bucket")
        a0, b0, _ = self.stacks[0]
        self.device = a0.device
        self.H = a0.shape[1] if a0.dim() == 3 else -1
        self.N = b0.shape[2] if b0.dim() == 3 else -1
        end = None
        for a, b, first in self.stacks:
            for what, t in (("A", a), ("Bs", b)):
                if t.dim() != 3 or t.dtype != torch.float32:
                    raise ValueError(f"lora_apply: the slot stack {what} "
                                     f"must be 3-D float32, got "
                                     f"{tuple(t.shape)} {t.dtype}")
                if t.device != self.device:
                    raise ValueError(f"lora_apply: slot stacks on "
                                     f"{t.device} and {self.device}")
                if not t.is_contiguous():
                    raise ValueError("lora_apply: the slot stacks must be "
                                     "contiguous")
            if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1] or \
                    a.shape[1] != self.H or b.shape[2] != self.N:
                raise ValueError(f"lora_apply: A {tuple(a.shape)} and Bs "
                                 f"{tuple(b.shape)} do not share (S, R) or "
                                 f"the buckets' (H, N)")
            if first < 0 or (end is not None and first < end):
                raise ValueError("lora_apply: bucket slot ranges must be "
                                 "ascending and disjoint")
            end = first + a.shape[0]
        self.ranks = tuple(a.shape[2] for a, _, _ in self.stacks)
        self.slots = tuple(a.shape[0] for a, _, _ in self.stacks)
        self.firsts = tuple(f for _, _, f in self.stacks)
        self._records = None

    def records(self):
        """The C interface's bucket array (device pointers, R, first, S),
        packed once."""
        if self._records is None:
            if len(self.stacks) > MAX_BUCKETS:
                raise ValueError(f"lora_apply: {len(self.stacks)} rank "
                                 f"buckets; the kernel takes up to "
                                 f"{MAX_BUCKETS}")
            if max(self.ranks) > MAX_KERNEL_RANK or min(self.ranks) < 1:
                raise ValueError(f"lora_apply: rank {max(self.ranks)} "
                                 f"outside [1, {MAX_KERNEL_RANK}]: the "
                                 f"kernel takes ranks up to "
                                 f"{MAX_KERNEL_RANK}")
            if sum(s - 1 for s in self.slots) + 1 > MAX_KEYS or \
                    max(self.H, self.N, *self.slots,
                        self.firsts[-1] + self.slots[-1]) >= 2 ** 31:
                raise ValueError("lora_apply: too many slots, or dimensions "
                                 "past int32")
            raw = b"".join(struct.pack("<qqiiii", a.data_ptr(), b.data_ptr(),
                                       a.shape[2], first, a.shape[0], 0)
                           for a, b, first in self.stacks)
            self._records = ctypes.create_string_buffer(raw, len(raw))
        return self._records


def lora_rank_pad(R: int) -> int:
    """The kernel's padded width of rank R: a power of 2, at least 4."""
    rp = 4
    while rp < R:
        rp *= 2
    return rp


@functools.lru_cache(maxsize=256)
def lora_apply_plan(M, B, H, N, ranks, slots, sms):
    """(C, K, T, HC, units) of a CUDA launch, from the shapes alone (the
    host never reads the ids): clusters of C CTAs split H (C a power of 2
    up to MAX_CLUSTER, at least H_PER_CTA of H each); K clusters a unit
    split N (at least COLS_PER_CTA columns a CTA, the grid at most
    CTAS_PER_SM CTAs an SM: one wave); units of up to T rows (64, or 16 when a
    rank pads past 64); A staged HC rows at a time; `units` bounds the
    units any ids can make, min(M, (M + G (T - 1)) // T) for G = min(B,
    live slots + 1) keys."""
    rp = max(lora_rank_pad(r) for r in ranks)
    T = 64 if rp <= 64 else 16
    HC = min(64, 4096 // rp)
    C = 1
    while C < MAX_CLUSTER and H >= 2 * C * H_PER_CTA:
        C *= 2
    keys = min(B, sum(s - 1 for s in slots) + 1)
    units = max(1, min(M, (M + keys * (T - 1)) // T))
    K = max(1, min(-(-N // (C * COLS_PER_CTA)),
                   int(CTAS_PER_SM * sms) // (units * C)))
    return C, K, T, HC, units


def lora_groups(row_slots, tokens, buckets, T):
    """The kernel's grouping of rows by slot: [(bucket, slot, rows)] in
    unit order. row_slots: the B entries' global slots, entry i owning
    rows i * tokens .. i * tokens + tokens - 1; buckets: (first, S) of
    each rank bucket. A row's key is (bucket, local slot) where its slot
    lies in a bucket at a local slot s > 0, else the null key (bucket and
    slot None). Keys in (bucket, slot) order, the null key last; a key's
    rows in row order, cut into units of up to T rows."""
    offs, k = [], 0
    for _, S in buckets:
        offs.append(k)
        k += S - 1
    null = k

    def key_of(g):
        for b, (first, S) in enumerate(buckets):
            if 0 <= g - first < S:
                return offs[b] + g - first - 1 if g > first else null
        return null

    per_key = {}
    for i, g in enumerate(row_slots):
        per_key.setdefault(key_of(int(g)), []).append(i)
    units = []
    for key in sorted(per_key):
        rows = [i * tokens + j for i in per_key[key] for j in range(tokens)]
        if key == null:
            b = s = None
        else:
            b = max(i for i, o in enumerate(offs) if o <= key
                    and key < o + buckets[i][1] - 1)
            s = key - offs[b] + 1
        units += [(b, s, rows[j:j + T]) for j in range(0, len(rows), T)]
    return units


def lora_apply_ref(x2d, y2d, row_slots, buckets):
    """Plain version of `lora_apply`: the reference's composition. Per
    rank bucket, each row's local slot (slot 0 outside the bucket) and
    its delta: single-token rows (t == 1) on a shape the reference's
    tiling rule takes through `lora_matmul_ref`, the rest through
    `lora_matmul_gathered`; the buckets summed in fp32 in order; then y +
    sum.to(y.dtype), or the fp32 sum itself when y2d is None."""
    if not isinstance(buckets, LoRABuckets):
        buckets = LoRABuckets(buckets)
    M, H = x2d.shape
    B = row_slots.shape[0]
    t = M // B
    slots = row_slots.to(torch.int32)
    if t > 1:
        slots = slots.repeat_interleave(t)
    total = None
    for a, b, first in buckets.stacks:
        S, _, R = a.shape
        local = slots - first
        local = torch.where((local >= 0) & (local < S), local,
                            0).to(torch.int32)
        if t == 1 and lora_matmul_supported(B, H, R, b.shape[2], x2d.dtype):
            d = lora_matmul_ref(x2d, local, a, b)
        else:
            d = lora_matmul_gathered(x2d, local, a, b)
        total = d if total is None else total + d
    if y2d is None:
        return total
    return y2d + total.to(y2d.dtype)


# ------------------------------------------------------------- the kernel
# the C entry of csrc/lora_matmul.cu:
#   lora_apply(x, y, out, row_slots, buckets, nb, M, H, N, B, x_dtype,
#              y_dtype, C, K, T, HC, units, stream)
C_APPLY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
    + [ctypes.c_void_p]
_SMS = {}


def _kernel_fn():
    fn = build.load(KERNEL_SOURCE).lora_apply
    if fn.argtypes is None:
        fn.argtypes = C_APPLY_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _on_cuda(name, t):
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{t.device}")
    return False


def _check(x2d, y2d, row_slots, packed, out):
    dev = x2d.device
    if x2d.dim() != 2 or x2d.dtype not in _DTYPE_CODE or \
            not x2d.is_contiguous():
        raise ValueError(f"lora_apply: x must be contiguous 2-D bfloat16 or "
                         f"float32, got {tuple(x2d.shape)} {x2d.dtype}")
    M, H = x2d.shape
    B = row_slots.shape[0] if row_slots.dim() == 1 else -1
    if row_slots.dtype != torch.int32 or B < 0 or (B == 0) != (M == 0) or \
            (B and M % B):
        raise ValueError(f"lora_apply: row slots must be (B,) int32 with B "
                         f"dividing the {M} rows, got "
                         f"{tuple(row_slots.shape)} {row_slots.dtype}")
    if packed.H != H:
        raise ValueError(f"lora_apply: x {tuple(x2d.shape)} does not fit A "
                         f"of H {packed.H}")
    want = (M, packed.N)
    for what, t in (("row slots", row_slots), ("slot stacks", packed),
                    ("y", y2d), ("out", out)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"lora_apply: {what} on {t.device}, x on {dev}")
        if what in ("y", "out") and (
                tuple(t.shape) != want or not t.is_contiguous() or
                t.dtype not in _DTYPE_CODE):
            raise ValueError(f"lora_apply: {what} must be contiguous {want} "
                             f"bfloat16 or float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if not row_slots.is_contiguous():
        raise ValueError("lora_apply: row slots must be contiguous")
    if out is not None and out.dtype != (y2d.dtype if y2d is not None
                                         else torch.float32):
        raise ValueError(f"lora_apply: out {out.dtype} is not y's dtype (or "
                         f"float32 without y)")
    if M >= 2 ** 31:
        raise ValueError("lora_apply: dimensions must fit in int32")


def lora_apply(x2d, y2d, row_slots, buckets, out=None):
    """One projection of one launch: y2d + (sum over the rank buckets of
    each row's delta).to(y2d.dtype).

    x2d (M, H) bf16/fp32; y2d (M, N) bf16/fp32, the projection's output,
    or None for the fp32 delta sum itself; row_slots (B,) int32 global
    slot ids, B dividing M, entry i owning rows i * (M // B) ... (a decode
    row, or a prefill chunk's tokens); buckets a `LoRABuckets` (or the
    sequence of (A, Bs, first slot) it takes). Row m's slot g lies in the
    bucket with first <= g < first + S at local slot g - first; local
    slot 0 or no bucket gives an exact 0.0.

    CPU tensors take `lora_apply_ref` (out unused). CUDA tensors
    launch the kernel once (counted in `.launches`) or raise: no host
    sync, nothing allocated but the output. `out` may be y2d itself: the
    kernel then writes y + delta into y in place (each element read and
    written by one thread), which the projection hook does with the
    projection's fresh output when autograd is off."""
    packed = buckets if isinstance(buckets, LoRABuckets) \
        else LoRABuckets(buckets)
    if not _on_cuda("lora_apply", x2d):
        return lora_apply_ref(x2d, y2d, row_slots, packed)
    _check(x2d, y2d, row_slots, packed, out)
    records = packed.records()
    M, H = x2d.shape
    N = packed.N
    dev = x2d.device
    if out is None:
        out = torch.empty((M, N), device=dev, dtype=torch.float32
                          if y2d is None else y2d.dtype)
    if M == 0:
        return out
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    B = row_slots.shape[0]
    C, K, T, HC, units = lora_apply_plan(M, B, H, N, packed.ranks,
                                         packed.slots, sms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            x2d.data_ptr(), None if y2d is None else y2d.data_ptr(),
            out.data_ptr(), row_slots.data_ptr(), ctypes.addressof(records),
            len(packed.stacks), M, H, N, B, _DTYPE_CODE[x2d.dtype],
            -1 if y2d is None else _DTYPE_CODE[y2d.dtype], C, K, T, HC,
            units, stream)
    if err != 0:
        raise RuntimeError(f"lora_apply kernel launch failed: cudaError "
                           f"{err}")
    lora_apply.launches += 1
    return out


lora_apply.launches = 0


def lora_matmul(x2d, ids, a_stack, b_stack):
    """x2d (rows, H) bf16/fp32; ids (rows,) int32 slot ids; a_stack
    (S, H, R) fp32; b_stack (S, R, N) fp32 with the scaling folded in ->
    (rows, N) fp32 delta. CPU tensors take `lora_matmul_ref`; CUDA
    tensors launch the kernel's delta-only instantiation (one bucket
    whose first slot is 0), or raise (R above MAX_KERNEL_RANK included:
    there is no fallback)."""
    if not _on_cuda("lora_matmul", x2d):
        return lora_matmul_ref(x2d, ids, a_stack, b_stack)
    if ids.dim() != 1 or ids.dtype != torch.int32 or \
            ids.shape[0] != x2d.shape[0]:
        raise ValueError(f"lora_matmul: ids must be ({x2d.shape[0]},) int32, "
                         f"got {tuple(ids.shape)} {ids.dtype}")
    return lora_apply(x2d, None, ids, LoRABuckets([(a_stack, b_stack, 0)]))
