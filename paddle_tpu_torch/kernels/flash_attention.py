"""Flash attention forward and backward (port of
`paddle_tpu/kernels/flash_attention.py`): the plain-causal core, and its
varlen (segment-id) and flashmask (column-bound) variants.

Layout: the public `flash_attention_bshd` takes (B, S, H, D) like the
reference; the three kernel entries work on (B*H, S, D) contiguous.
Causal is bottom-right aligned (key j visible to query i iff
j <= i + Sk - Sq), never torch's top-left `is_causal`. The forward
returns the output and the fp32 logsumexp (B*H, Sq); the backward
recomputes probabilities from that lse, with delta = rowsum(dO * O)
computed as a plain op outside the kernels, as in the reference.

Each entry — `flash_fwd`, `flash_dq`, `flash_dkv` — launches its
hand-written Hopper kernel on a CUDA tensor (counted in `.launches` in
the plain mode) or raises. `flash_route` picks each entry's kernel
before the launch from (dtype, head_dim, mode, kernel) alone: bf16 at
head_dim <= 128 takes the wgmma kernels in every mode — the forward of
`csrc/flash_fwd_sm90.cu`, dQ and dK/dV of `csrc/flash_bwd_sm90.cu`
(counted in `.sm90_launches`, and a plain forward at one query row,
generate's decode step, also in `flash_fwd.decode_launches`; the wgmma
dK/dV reads lse and delta, and
the masked wgmma kernels their segment rows or bounds, with TMA in
boxes that start 16-byte aligned, so the wrapper pads those rows to a
multiple of 4 elements when S is not one, `_tma_rows`); fp32 and
head_dim > 128 take `csrc/flash_attention.cu`. On a CPU
tensor each entry runs the plain PyTorch version beside it
(`flash_fwd_ref`, `flash_dq_ref`, `flash_dkv_ref`: fp32 math, a masked
score is NEG_INF and contributes exactly 0, the softmax sum clamped at
1e-30, so a row that sees no key gives zeros). `FlashAttention` is the
autograd Function over them.

The masked variants take the reference's extra inputs on the same
entries: `seg=(segq, segk)`, per-token (segment id, position in its
sequence) rows of shape (B, 2, S) int32 — a query sees a key only in its
own segment, and under `causal` only when pos_k <= pos_q (no global
causal mask); or `fm=`, flashmask row bounds (B*Hm, C, Sk) int32 with Hm
1 or H and C 1|2 (`fm_causal`) or 2|4, on top of the causal mask when
`causal`. `H` is the number of heads per batch row. On a CUDA tensor
they launch the segment or flashmask mode of the same kernels (counted
in `.varlen_launches` / `.flashmask_launches`, and never in `.launches`:
bf16 at head_dim <= 128 on the wgmma kernels, also in `.sm90_launches`).
The skip predicate reads per-32-row tile summaries that `tile_summary`
builds with plain torch ops (`_segment_summary`: 3 launches a side, 4
when S is not a multiple of 32; `_start_summary`, C == 1 with causal
bounds only: 2 to 4); an entry takes them as `summary=` or builds them
itself. `visits=`, a one-element int32 tensor on the card, gains the
(q, k) tile pairs a masked kernel visits (`flash_visits_ref` is its
plain version; `masked_walk` is the masked wgmma kernels' walk of their
blocks in Python). `FlashAttentionVarlen` and `FlashMask` are the
autograd Functions (`_flash_core_seg`, `_flash_core_fm`): they build the
summaries once for the three kernels of a call; the integer inputs get
no gradient. `flash_attention_varlen_bshd` and
`flashmask_attention_bshd` are the reference's public entries.

Not ported: the reference's TPU block autotuner (the CUDA kernels pick
their own tiles).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

__all__ = ["flash_attention_bshd", "flash_attention_varlen_bshd",
           "flashmask_attention_bshd", "FlashAttention",
           "FlashAttentionVarlen", "FlashMask", "flash_fwd", "flash_dq",
           "flash_dkv", "flash_fwd_ref", "flash_dq_ref", "flash_dkv_ref",
           "flash_delta", "tile_summary", "flash_visits_ref",
           "check_supported", "flash_route", "masked_walk",
           "NEG_INF", "KERNEL_SOURCE", "SM90_SOURCE", "SM90_BWD_SOURCE"]

KERNEL_SOURCE = "flash_attention.cu"
SM90_SOURCE = "flash_fwd_sm90.cu"
SM90_BWD_SOURCE = "flash_bwd_sm90.cu"
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
def _flashmask_block_mask(fm, Sq, fm_causal):
    """Flashmask bounds (N, C, Sk) -> (N, Sq, Sk) bool, True where a
    score is masked: row r of key column c per the reference's
    startend_row_indices (C 1: r >= start; C 2 causal: start <= r < end;
    C 2 non-causal: r >= start or r < end; C 4: two [start, end) bands).
    """
    rows = torch.arange(Sq, device=fm.device)[None, :, None]
    b = [fm[:, c][:, None, :] for c in range(fm.shape[1])]
    if fm_causal:
        if len(b) == 1:
            return rows >= b[0]
        return (rows >= b[0]) & (rows < b[1])
    if len(b) == 2:
        return (rows >= b[0]) | (rows < b[1])
    return ((rows >= b[0]) & (rows < b[1])) | ((rows >= b[2]) & (rows < b[3]))


def _per_head(x, BH, H):
    """Rows of a per-batch-row input (B or B*Hm leading) for each of the
    BH heads: x itself when it has BH rows, else each row H times."""
    return x if x.shape[0] == BH else x.repeat_interleave(H, dim=0)


def _apply_masks(s, causal, seg=None, fm=None, fm_causal=True, H=1):
    """Scores (BH, Sq, Sk) -> (scores with NEG_INF where masked, the
    visibility mask or None), as the reference's `_apply_masks`: the
    bottom-right causal mask only without segments; segments allow
    equal ids and, under causal, pos_k <= pos_q; flashmask bounds on top.
    """
    BH, Sq, Sk = s.shape
    keep = None
    if causal and seg is None:
        qpos = torch.arange(Sq, device=s.device)[:, None]
        kpos = torch.arange(Sk, device=s.device)[None, :]
        keep = kpos <= qpos + (Sk - Sq)
    if seg is not None:
        segq, segk = (_per_head(x, BH, H) for x in seg)
        keep = segq[:, 0, :, None] == segk[:, 0, None, :]
        if causal:
            keep = keep & (segk[:, 1, None, :] <= segq[:, 1, :, None])
    if fm is not None:
        allow = ~_flashmask_block_mask(_per_head(fm, BH, H), Sq, fm_causal)
        keep = allow if keep is None else keep & allow
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s, keep


def _masked_exp(s, ref):
    """exp(s - ref), exactly 0 for a masked (NEG_INF) score even when
    `ref` is NEG_INF too (a row that has seen no key)."""
    return torch.where(s <= NEG_INF / 2, torch.zeros((), device=s.device),
                       torch.exp(s - ref))


def _probs(q, k, lse, sm_scale, causal, seg=None, fm=None, fm_causal=True,
           H=1):
    """fp32 scores (BH, Sq, Sk) with every mask as NEG_INF, and the
    visibility mask (None when nothing is masked). With `lse` given,
    also exp(s - lse) with masked entries exactly 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s, keep = _apply_masks(s, causal, seg, fm, fm_causal, H)
    if lse is None:
        return s, keep
    ref = lse[..., None]
    return (torch.exp(s - ref) if keep is None else _masked_exp(s, ref)), keep


def flash_fwd_ref(q, k, v, sm_scale, causal, seg=None, fm=None,
                  fm_causal=True, H=1):
    """(BH, Sq, D), (BH, Sk, D) x2 -> out (BH, Sq, D) in q's dtype and
    lse (BH, Sq) fp32."""
    s, keep = _probs(q, k, None, sm_scale, causal, seg, fm, fm_causal, H)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) if keep is None else _masked_exp(s, m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_delta(out, dout):
    """delta = rowsum(dO * O) in fp32, (BH, Sq) — a plain op, as in the
    reference's backward."""
    return (dout.float() * out.float()).sum(dim=-1)


def _dscores(q, k, v, dout, lse, delta, sm_scale, causal, *masks):
    p, _ = _probs(q, k, lse, sm_scale, causal, *masks)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_dq_ref(q, k, v, dout, lse, delta, sm_scale, causal, seg=None,
                 fm=None, fm_causal=True, H=1):
    """dQ (BH, Sq, D) in q's dtype, from the saved lse and delta."""
    _, ds = _dscores(q, k, v, dout, lse, delta, sm_scale, causal, seg, fm,
                     fm_causal, H)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_dkv_ref(q, k, v, dout, lse, delta, sm_scale, causal, seg=None,
                  fm=None, fm_causal=True, H=1):
    """(dK, dV), each (BH, Sk, D) in k's / v's dtype."""
    p, ds = _dscores(q, k, v, dout, lse, delta, sm_scale, causal, seg, fm,
                     fm_causal, H)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernels
# the C entries of csrc/flash_attention.cu (pointers and the stream as
# c_void_p: a bare int would be cut to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every entry's tail after its outputs: segq, segk, qsum, ksum, fm, fmsum,
# visits, BH, Sq, Sk, D, H, fm_heads, fm_cols, scale, causal, fm_causal,
# mode, dtype, stream
_TAIL = [_P] * 7 + [_I] * 7 + [_F] + [_I] * 4 + [_P]
C_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + _TAIL,    # q, k, v, out, lse
    # q, k, v, dout, lse, delta, dq
    "flash_attention_dq": [_P] * 7 + _TAIL,
    # q, k, v, dout, lse, delta, dk, dv
    "flash_attention_dkv": [_P] * 8 + _TAIL,
}
# the wgmma entries: their tensors (fwd: q, k, v, out, lse; dq: q, k, v,
# dout, lse, delta, dq; dkv: the same with dk, dv), then BH, Sq, Sk, D,
# scale, causal, stream; the masked entries take `_TAIL` less dtype
_SM90_TAIL = [_I] * 4 + [_F, _I, _P]
_SM90_MASKED_TAIL = _TAIL[:-2] + _TAIL[-1:]
SM90_C_ARGTYPES = {
    "flash_attention_fwd_sm90": (SM90_SOURCE, [_P] * 5 + _SM90_TAIL),
    "flash_attention_fwd_sm90_masked": (SM90_SOURCE,
                                        [_P] * 5 + _SM90_MASKED_TAIL),
    "flash_attention_dq_sm90": (SM90_BWD_SOURCE, [_P] * 7 + _SM90_TAIL),
    "flash_attention_dkv_sm90": (SM90_BWD_SOURCE, [_P] * 8 + _SM90_TAIL),
    "flash_attention_dq_sm90_masked": (SM90_BWD_SOURCE,
                                       [_P] * 7 + _SM90_MASKED_TAIL),
    "flash_attention_dkv_sm90_masked": (SM90_BWD_SOURCE,
                                        [_P] * 8 + _SM90_MASKED_TAIL),
}
_MODE = {"plain": 0, "varlen": 1, "flashmask": 2}
GROUP = 32      # rows of one tile-summary entry (csrc: kGroup)


FLASH_KERNELS = ("fwd", "dq", "dkv")


def flash_route(dtype, D, mode="plain", kernel="fwd") -> str:
    """Which kernel a CUDA forward ("fwd"), dQ ("dq") or dK/dV ("dkv")
    takes, decided before the launch from (dtype, head_dim, kernel)
    alone: "sm90" for bf16 at head_dim <= 128 in every mode — the forward
    of `csrc/flash_fwd_sm90.cu`, dQ and dK/dV of
    `csrc/flash_bwd_sm90.cu` — else "mma" (`csrc/flash_attention.cu`:
    fp32 and head_dim > 128). `mode` names the call's mask mode; no mode
    changes the route."""
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"kernel {kernel!r} is not one of {FLASH_KERNELS}")
    return "sm90" if dtype == torch.bfloat16 and D <= 128 else "mma"


def _entry(name):
    source, argtypes = SM90_C_ARGTYPES.get(
        name, (KERNEL_SOURCE, C_ARGTYPES.get(name)))
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _check_masks(q, k, seg, fm, H, visits):
    """What only the wrapper can see of the masked modes' inputs: contiguous
    int32 tensors on q's device with the rows the kernels read — segments
    (B, 2, Sq) / (B, 2, Sk), flashmask bounds (B or B*H, C, Sk), `visits`
    (1,). The C entry refuses the rest (flashmask with Sq != Sk, C)."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    if seg is not None and fm is not None:
        raise ValueError("segment ids and flashmask bounds do not combine")
    if H < 1 or BH % H:
        raise ValueError(f"H = {H} does not divide B*H = {BH}")
    B = BH // H
    want = ([("segq", seg[0], (B, 2, Sq)), ("segk", seg[1], (B, 2, Sk))]
            if seg is not None else [])
    if fm is not None:
        if fm.dim() != 3 or fm.shape[0] not in (B, BH) or fm.shape[2] != Sk:
            raise ValueError(f"flashmask bounds {tuple(fm.shape)} are not "
                             f"(B*Hm, C, {Sk}) with Hm 1 or {H}")
        want.append(("fm", fm, tuple(fm.shape)))
    if visits is not None:
        want.append(("visits", visits, (1,)))
    for name, t, shape in want:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape} on "
                             f"{q.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _group_pad(x, group=GROUP):
    """(N, R, S) -> (N, R, ceil(S/group), group), the last row repeated
    past S so a group's min and max are those of its in-range rows."""
    N, R, S = x.shape
    pad = -S % group
    if pad:
        x = torch.cat([x, x[..., -1:].expand(N, R, pad)], dim=-1)
    return x.view(N, R, -1, group)


def _segment_summary(seg):
    """(B, 2, S) segment rows -> (B, 4, ceil(S/32)) int32: min id, max
    id, min position, max position of each 32-row group."""
    x = _group_pad(seg)
    lo, hi = x.amin(dim=-1), x.amax(dim=-1)
    return torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=1)


def _start_summary(fm):
    """(N, C, Sk) bounds -> (N, 2, ceil(Sk/32)) int32: the largest and the
    smallest start (bound 0) of each 32-column group (the skip predicate
    reads the first, the wgmma backward's whole-tile test the second)."""
    x = _group_pad(fm[:, :1].contiguous())
    return torch.cat([x.amax(dim=-1), x.amin(dim=-1)], dim=1).contiguous()


def tile_summary(seg=None, fm=None, fm_causal=True):
    """The skip predicate's tile summaries for one set of masks, as a
    masked entry's `summary=`: (qsum, ksum, fmsum), None where the mode
    takes none — the segment rows' (`_segment_summary`), or the bounds'
    start summary (C == 1 with causal bounds only)."""
    if seg is not None:
        return _segment_summary(seg[0]), _segment_summary(seg[1]), None
    if fm is not None and fm.shape[1] == 1 and fm_causal:
        return None, None, _start_summary(fm)
    return None, None, None


def flash_visits_ref(BH, Sq, Sk, causal, seg=None, fm=None, fm_causal=True,
                     H=1, tile=64):
    """The plain version of a masked kernel's `visits`: the (q tile, k
    tile) pairs the reference's `_block_contributes` lets through at the
    kernels' tile (64 rows; 32 for fp32 at head_dim > 128), summed over
    the B*H heads. Segment mode: overlapping id ranges, less the
    one-sequence all-future pairs under `causal`; flashmask: the causal
    bound, less the C == 1 causal document skip."""
    x = seg[0] if seg is not None else fm
    q0 = torch.arange(0, Sq, tile, device=x.device)[:, None]
    k0 = torch.arange(0, Sk, tile, device=x.device)[None, :]
    if seg is not None:
        (qlo, qhi), (klo, khi) = ((g.amin(-1), g.amax(-1)) for g in (
            _group_pad(seg[0], tile), _group_pad(seg[1], tile)))
        ok = (qlo[:, 0, :, None] <= khi[:, 0, None, :]) \
            & (qhi[:, 0, :, None] >= klo[:, 0, None, :])
        if causal:
            one = (qlo[:, 0, :, None] == khi[:, 0, None, :]) \
                & (qhi[:, 0, :, None] == klo[:, 0, None, :])
            ok = ok & ~(one & (klo[:, 1, None, :] > qhi[:, 1, :, None]))
        return int(ok.sum()) * H
    ok = (k0 <= q0 + tile - 1 + Sk - Sq) if causal \
        else torch.ones(q0.shape[0], k0.shape[1], dtype=torch.bool,
                        device=x.device)
    ok = ok.expand(fm.shape[0], -1, -1)
    if fm.shape[1] == 1 and fm_causal:
        start = _group_pad(fm, tile).amax(dim=-1)[:, 0]     # (N, nk)
        ok = ok & (q0[None] < start[:, None, :])
    return int(ok.sum()) * (BH // fm.shape[0])


_IMAX, _IMIN = 2 ** 31 - 1, -2 ** 31


def _seg_range(summ, r0, tile=64):
    """csrc seg_range: (min id, max id, min pos, max pos) of rows [r0, r0 +
    tile) from one batch row's (4, ng) summary (numpy), over its groups."""
    g0, g1 = r0 // GROUP, min(summ.shape[1], (r0 + tile) // GROUP)
    if g0 >= g1:
        return _IMAX, _IMIN, _IMAX, _IMIN
    x = summ[:, g0:g1]
    return int(x[0].min()), int(x[1].max()), int(x[2].min()), int(x[3].max())


def masked_walk(kernel, BH, Sq, Sk, causal, seg=None, fm=None,
                fm_causal=True, H=1, summary=None):
    """The wgmma masked forward ("fwd"), dQ ("dq") or dK/dV ("dkv")
    kernel's walk, the C rule (`build_list` and `next_word` in
    csrc/flash_walk.cuh) in Python, for the tests: {(bh, first fixed
    row): [(ring tile, (warpgroup 0 computes it, warpgroup 1 does), (the
    pair is whole: no score masked, for each)), ...]}, the tiles in the
    order the ring carries them. A block's fixed rows are 128 queries
    (fwd, dq) or keys (dkv), 64 a warpgroup; a ring tile is 64 keys (fwd,
    dq) or queries (dkv): the forward walks as dQ does. A pair is
    computed when the reference's `_block_contributes` lets it through,
    read from the summaries the kernels read (`tile_summary`). (The
    kernels keep the whole bits up to 65536 ring tiles, more than these
    tests reach.)"""
    qsum, ksum, fmsum = (None if x is None else x.cpu().numpy() for x in (
        summary if summary is not None else tile_summary(seg, fm,
                                                         fm_causal)))
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"kernel {kernel!r} is not one of {FLASH_KERNELS}")
    dq = kernel != "dkv"        # the forward's walk is dQ's
    fixed_rows, ring_rows = (Sq, Sk) if dq else (Sk, Sq)
    off = Sk - Sq
    doc = fm is not None and fm.shape[1] == 1 and fm_causal
    Hm = fm.shape[0] * H // BH if fm is not None else 1
    walk = {}
    for bh in range(BH):
        b = bh // H
        fh = b if Hm == 1 else bh
        for f0 in range(0, fixed_rows, 128):
            tiles = []
            for t in range(-(-ring_rows // 64)):
                c, w = [False, False], [False, False]
                for wg in range(2):
                    r0 = f0 + 64 * wg
                    if r0 >= fixed_rows:
                        continue
                    q0, k0 = (r0, 64 * t) if dq else (64 * t, r0)
                    if seg is not None:
                        qr, kr = _seg_range(qsum[b], q0), _seg_range(ksum[b],
                                                                     k0)
                        one = qr[0] == kr[1] and qr[1] == kr[0]
                        c[wg] = (qr[0] <= kr[1] and qr[1] >= kr[0]
                                 and not (causal and one and kr[2] > qr[3]))
                        w[wg] = (qr[0] == qr[1] == kr[0] == kr[1]
                                 and (not causal or kr[3] <= qr[2]))
                    else:   # the largest and smallest start of the tile
                        if doc:
                            g = slice(k0 // GROUP, min(fmsum.shape[-1],
                                                       (k0 + 64) // GROUP))
                            smax = fmsum[fh, 0, g].max()
                            smin = fmsum[fh, 1, g].min()
                        c[wg] = ((not causal or k0 <= q0 + 63 + off)
                                 and not (doc and q0 >= smax))
                        w[wg] = (doc and (not causal or k0 + 63 <= q0 + off)
                                 and q0 + 63 < smin)
                    c[wg] = bool(c[wg])
                    w[wg] = bool(c[wg] and w[wg] and q0 + 64 <= Sq
                                 and k0 + 64 <= Sk)
                if c[0] or c[1]:
                    tiles.append((t, tuple(c), tuple(w)))
            walk[(bh, f0)] = tiles
    return walk


def _device_kind(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return q.device.type


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_sm90(fn, name, tensors, sm_scale, causal):
    """One launch of the wgmma entry `name` on its tensors (q, k first),
    counted in `fn.launches` and `fn.sm90_launches`; raises if the kernel
    refused its arguments or failed to launch."""
    q, k = tensors[:2]
    BH, Sq, D = q.shape
    with torch.cuda.device(q.device):
        err = _entry(name)(*(t.data_ptr() for t in tensors), BH, Sq,
                           k.shape[1], D, float(sm_scale),
                           int(bool(causal)), _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed or refused its "
                           f"arguments: cudaError {err}")
    fn.launches += 1
    fn.sm90_launches += 1


def _tma_rows(t):
    """t (..., S) as the wgmma backward's TMA reads it in 1-D boxes that
    start 16-byte aligned: rows padded to a multiple of 4 elements and
    16-byte aligned storage (t itself when it is so already)."""
    if t is None:
        return None
    pad = -t.shape[-1] % 4
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, name, q, k, outs, ins, sm_scale, causal, seg, fm,
            fm_causal, H, summary, visits, sm90=False):
    """One launch of `name` in the mode its masks ask for; counts it on
    `fn` (and in `.sm90_launches` for a masked wgmma entry, `sm90`, which
    takes no dtype). `outs`/`ins` are the entry's tensor arguments after
    q, k (v, dout, lse, delta; out, lse / dq / dk, dv)."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    mode, kind = _MODE["plain"], "launches"
    masks = (None,) * 7
    if seg is not None or fm is not None:
        _check_masks(q, k, seg, fm, H, visits)
        if summary is None:
            summary = tile_summary(seg, fm, fm_causal)
        if sm90:
            seg = seg and tuple(map(_tma_rows, seg))
            fm = _tma_rows(fm)
        mode = _MODE["varlen" if seg is not None else "flashmask"]
        kind = "varlen_launches" if seg is not None else "flashmask_launches"
        masks = (*(seg or (None, None)), *summary[:2], fm, summary[2],
                 visits)
    ptrs = [t.data_ptr() for t in (q, k) + ins + outs]
    dtype = [] if sm90 else [_DTYPE_CODE[q.dtype]]
    with torch.cuda.device(q.device):
        err = _entry(name)(
            *ptrs, *(None if t is None else t.data_ptr() for t in masks),
            BH, Sq, Sk, D, int(H),
            fm.shape[0] * H // BH if fm is not None else 1,
            fm.shape[1] if fm is not None else 0, float(sm_scale),
            int(bool(causal)), int(bool(fm_causal)), mode, *dtype,
            _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed or refused its "
                           f"arguments: cudaError {err}")
    setattr(fn, kind, getattr(fn, kind) + 1)
    if sm90:
        fn.sm90_launches += 1


def _mode(seg, fm):
    return "varlen" if seg is not None else \
        "flashmask" if fm is not None else "plain"


def flash_fwd(q, k, v, sm_scale, causal, seg=None, fm=None, fm_causal=True,
              H=1, summary=None, visits=None):
    """Forward: (out (BH, Sq, D), lse (BH, Sq) fp32). `summary` and
    `visits` are for the card's masked modes (the module docstring)."""
    if _device_kind(q, "flash_fwd") == "cpu":
        return flash_fwd_ref(q, k, v, sm_scale, causal, seg, fm, fm_causal,
                             H)
    _check_cuda_args(q, k, v)
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, device=q.device, dtype=torch.float32)
    mode = _mode(seg, fm)
    sm90 = flash_route(q.dtype, D, mode, "fwd") == "sm90"
    if sm90 and mode == "plain":
        _launch_sm90(flash_fwd, "flash_attention_fwd_sm90",
                     (q, k, v, out, lse), sm_scale, causal)
        if Sq == 1:
            flash_fwd.decode_launches += 1
        return out, lse
    _launch(flash_fwd, "flash_attention_fwd" + ("_sm90_masked" if sm90
                                                 else ""), q, k, (out, lse),
            (v,), sm_scale, causal, seg, fm, fm_causal, H, summary, visits,
            sm90)
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, sm_scale, causal, seg=None, fm=None,
             fm_causal=True, H=1, summary=None, visits=None):
    """dQ (BH, Sq, D) in q's dtype."""
    if _device_kind(q, "flash_dq") == "cpu":
        return flash_dq_ref(q, k, v, dout, lse, delta, sm_scale, causal, seg,
                            fm, fm_causal, H)
    _check_cuda_args(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    mode = _mode(seg, fm)
    sm90 = flash_route(q.dtype, q.shape[2], mode, "dq") == "sm90"
    if sm90 and mode == "plain":
        _launch_sm90(flash_dq, "flash_attention_dq_sm90",
                     (q, k, v, dout, lse, delta, dq), sm_scale, causal)
        return dq
    _launch(flash_dq, "flash_attention_dq" + ("_sm90_masked" if sm90
                                               else ""), q, k, (dq,),
            (v, dout, lse, delta), sm_scale, causal, seg, fm, fm_causal, H,
            summary, visits, sm90)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, sm_scale, causal, seg=None,
              fm=None, fm_causal=True, H=1, summary=None, visits=None):
    """(dK, dV), each (BH, Sk, D) in k's dtype."""
    if _device_kind(q, "flash_dkv") == "cpu":
        return flash_dkv_ref(q, k, v, dout, lse, delta, sm_scale, causal,
                             seg, fm, fm_causal, H)
    _check_cuda_args(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mode = _mode(seg, fm)
    sm90 = flash_route(q.dtype, q.shape[2], mode, "dkv") == "sm90"
    if sm90:                            # the kernel reads them with TMA
        lse, delta = _tma_rows(lse), _tma_rows(delta)
    if sm90 and mode == "plain":
        _launch_sm90(flash_dkv, "flash_attention_dkv_sm90",
                     (q, k, v, dout, lse, delta, dk, dv), sm_scale, causal)
        return dk, dv
    _launch(flash_dkv, "flash_attention_dkv" + ("_sm90_masked" if sm90
                                                 else ""), q, k, (dk, dv),
            (v, dout, lse, delta), sm_scale, causal, seg, fm, fm_causal, H,
            summary, visits, sm90)
    return dk, dv


flash_fwd.launches = flash_fwd.varlen_launches = 0
flash_fwd.sm90_launches = flash_dq.sm90_launches = 0
flash_fwd.decode_launches = 0
flash_dkv.sm90_launches = 0
flash_dq.launches = flash_dq.varlen_launches = 0
flash_dkv.launches = flash_dkv.varlen_launches = 0
flash_fwd.flashmask_launches = flash_dq.flashmask_launches = 0
flash_dkv.flashmask_launches = 0


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


class FlashAttentionVarlen(torch.autograd.Function):
    """Segment-masked attention over (BH, S, D) (the reference's
    `_flash_core_seg`): segq (B, 2, Sq) / segk (B, 2, Sk) int32 rows of
    [segment id; position in its sequence], H heads per batch row."""

    @staticmethod
    def forward(ctx, q, k, v, segq, segk, sm_scale, causal, H):
        seg = (segq, segk)
        qsum, ksum, _ = summary = tile_summary(seg)
        out, lse = flash_fwd(q, k, v, sm_scale, causal, seg=seg, H=H,
                             summary=summary)
        ctx.save_for_backward(q, k, v, out, lse, segq, segk, qsum, ksum)
        ctx.sm_scale, ctx.causal, ctx.H = sm_scale, causal, H
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segq, segk, qsum, ksum = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        args = (q, k, v, dout, lse, delta, ctx.sm_scale, ctx.causal)
        kw = dict(seg=(segq, segk), H=ctx.H, summary=(qsum, ksum, None))
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None, None


class FlashMask(torch.autograd.Function):
    """Flashmask attention over (BH, S, D) (the reference's
    `_flash_core_fm`): fm (B*Hm, C, Sk) int32 row bounds."""

    @staticmethod
    def forward(ctx, q, k, v, fm, sm_scale, causal, fm_causal, H):
        summary = tile_summary(fm=fm, fm_causal=fm_causal)
        out, lse = flash_fwd(q, k, v, sm_scale, causal, fm=fm,
                             fm_causal=fm_causal, H=H, summary=summary)
        ctx.save_for_backward(q, k, v, out, lse, fm, summary[2])
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.fm_causal, ctx.H = fm_causal, H
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, fm, fmsum = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        args = (q, k, v, dout, lse, delta, ctx.sm_scale, ctx.causal)
        kw = dict(fm=fm, fm_causal=ctx.fm_causal, H=ctx.H,
                  summary=(None, None, fmsum))
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None, None


def _to_bhsd(x):
    B, S, H, D = x.shape
    # at B == 1 the reshape is a strided view, so ask for the copy
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _from_bhsd(out, B, H, S, D):
    return out.reshape(B, H, S, D).transpose(1, 2)


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
    return _from_bhsd(out, B, H, Sq, D)


def _positions_in_segments(seg):
    """Per-token position within its (contiguous) segment: (B, S) ->
    (B, S) int32, p - the start of p's segment."""
    B, S = seg.shape
    p = torch.arange(S, dtype=torch.int32, device=seg.device)[None, :]
    boundary = torch.where(seg != torch.roll(seg, 1, dims=1), p,
                           torch.zeros_like(p))
    boundary[:, 0] = 0
    start = torch.cummax(boundary, dim=1).values
    return p - start


def flash_attention_varlen_bshd(q, k, v, q_segment_ids, kv_segment_ids,
                                causal=False, sm_scale=None,
                                q_positions=None, kv_positions=None):
    """Packed (varlen) attention via per-token segment ids: q/k/v
    (B, S, H, D), ids (B, Sq) / (B, Sk). A token attends only within its
    segment; causal is per sequence: key position <= query position
    (positions from the ids, or given — `flash_attn_unpadded` shifts the
    query's by its sequence's k_len - q_len)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if not q.is_cuda:
        check_supported(tuple(q.shape), tuple(k.shape), q.dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    ids_q = q_segment_ids.to(torch.int32).reshape(B, Sq)
    ids_k = kv_segment_ids.to(torch.int32).reshape(B, Sk)
    if causal:
        pos_q = (q_positions.to(torch.int32).reshape(B, Sq)
                 if q_positions is not None
                 else _positions_in_segments(ids_q))
        pos_k = (kv_positions.to(torch.int32).reshape(B, Sk)
                 if kv_positions is not None
                 else _positions_in_segments(ids_k))
    else:
        pos_q = torch.zeros_like(ids_q)
        pos_k = torch.zeros_like(ids_k)
    segq = torch.stack([ids_q, pos_q], dim=1)      # (B, 2, Sq)
    segk = torch.stack([ids_k, pos_k], dim=1)
    out = FlashAttentionVarlen.apply(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v),
                                     segq, segk, float(sm_scale),
                                     bool(causal), int(H))
    return _from_bhsd(out, B, H, Sq, D)


def flashmask_attention_bshd(q, k, v, startend_row_indices, causal=True,
                             sm_scale=None):
    """Flashmask attention (the reference's `flashmask_attention_bshd`):
    startend_row_indices (B, 1|H, Sk, C) int32, C 1|2 causal or 2|4
    non-causal — each key column's masked row ranges, rebuilt tile by
    tile in the kernel, never a dense (B, H, Sq, Sk) mask."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if not q.is_cuda:
        check_supported(tuple(q.shape), tuple(k.shape), q.dtype)
    if Sq != Sk:
        raise ValueError("flashmask requires Sq == Sk")
    Hm = startend_row_indices.shape[1]
    C = startend_row_indices.shape[3]
    if Hm not in (1, H):
        raise ValueError(f"flashmask heads dim {Hm} must be 1 or {H}")
    if causal and C not in (1, 2):
        raise ValueError("causal flashmask needs 1 or 2 bound columns")
    if not causal and C not in (2, 4):
        raise ValueError("non-causal flashmask needs 2 or 4 bound columns")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    # (B, Hm, Sk, C) -> (B*Hm, C, Sk)
    fm = startend_row_indices.to(torch.int32).transpose(2, 3) \
        .reshape(B * Hm, C, Sk).contiguous()
    out = FlashMask.apply(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), fm,
                          float(sm_scale), bool(causal), bool(causal),
                          int(H))
    return _from_bhsd(out, B, H, Sq, D)
