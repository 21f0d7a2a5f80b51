"""Paged-KV decode attention and the paged-cache writes (port of
`paddle_tpu/kernels/paged_attention.py`).

Cache layout (unchanged from the reference): each layer's K and V live
as (num_pages, KVH, page_size, D) tensors, page-major; sequences own
pages through an int32 block table, and page 0 is the pad page that
unused block-table slots point at (reads of it are masked by seq_lens).

`paged_attention_decode` is the one kernel of the serving path. On a
CUDA tensor it launches the hand-written Hopper kernel
`csrc/paged_attention.cu` (it replaces the Pallas `_decode_kernel`; the
source note there says what bounds it and how the design answers) or
raises; on a CPU tensor it runs `paged_attention_decode_ref`, the plain
PyTorch version beside it. The cache writes are index writes, as they
were XLA scatters in the reference. The int8 KV variant is not ported.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import resolve_device
from . import build

__all__ = ["paged_attention_decode", "paged_attention_decode_ref",
           "paged_cache_write", "paged_cache_write_range",
           "alloc_paged_cache", "check_supported_paged", "paged_page_bytes",
           "KERNEL_SOURCE", "CUDA_GROUP_SIZES", "CUDA_MAX_TABLE_PAGES"]

KERNEL_SOURCE = "paged_attention.cu"
# query heads per KV head the CUDA kernel is instantiated for, and the
# widest block table it stages in shared memory
CUDA_GROUP_SIZES = (1, 2, 4, 8)
CUDA_MAX_TABLE_PAGES = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_page_bytes(num_kv_heads, page_size, head_dim, kv_dtype=None):
    """Device bytes one page costs: K + V payload. The single source for
    the engine's pool sizing and bytes-moved accounting."""
    if kv_dtype in (None, "bf16", "bfloat16", "float16"):
        width = 2
    elif kv_dtype in ("float32", "fp32"):
        width = 4
    elif kv_dtype == "int8":
        raise ValueError("int8 KV pages are not ported to paddle_tpu_torch")
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return 2 * num_kv_heads * page_size * head_dim * width


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_supported_paged(q_shape, cache_shape, dtype, kv_dtype=None):
    """Static shape validation, the reference's rules: q head_dim equals
    the cache's, H a multiple of KVH, head_dim a multiple of 64 and at
    most 256, page_size a multiple of 8, bfloat16 or float32."""
    B, H, D = q_shape
    num_pages, KVH, page_size, Dc = cache_shape
    if D != Dc:
        raise ValueError(f"q head_dim {D} != cache head_dim {Dc}")
    if H % KVH != 0:
        raise ValueError(f"H={H} not a multiple of KVH={KVH}")
    if D % 64 != 0 or D > 256:
        raise ValueError(f"head_dim {D} unsupported (need multiple of 64, "
                         "<= 256)")
    if page_size % 8 != 0:
        raise ValueError(f"page_size {page_size} must be a multiple of 8")
    if _dtype_name(dtype) not in ("bfloat16", "float32"):
        raise ValueError(f"unsupported dtype {dtype} (bfloat16/float32)")
    if kv_dtype is not None:
        raise ValueError(f"kv_dtype {kv_dtype!r} is not ported (the cache "
                         "holds the compute dtype)")


def paged_attention_decode_ref(q, k_cache, v_cache, block_tables, seq_lens,
                               sm_scale=None):
    """Plain PyTorch version: gather each sequence's pages into a dense
    (B, KVH, P*page, D) view, score in fp32, mask positions >= seq_len,
    softmax, weight V. A row with seq_len 0 gives zeros (the sum is
    clamped at 1e-30 like the kernels)."""
    B, H, D = q.shape
    _, KVH, page, _ = k_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    bt = block_tables.long()

    def dense(cache):                      # (B, KVH, P*page, D) fp32
        g = cache[bt].float()              # (B, P, KVH, page, D)
        return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, -1, D)

    k, v = dense(k_cache), dense(v_cache)
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    live = (torch.arange(k.shape[2], device=q.device)[None, :]
            < seq_lens.long()[:, None])                       # (B, S)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / l
    return o.reshape(B, H, D).to(q.dtype)


def _check_cuda_args(q, k_cache, v_cache, block_tables, seq_lens):
    B, H, _ = q.shape
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"cache dtype {k_cache.dtype}/{v_cache.dtype} "
                         f"must equal q dtype {q.dtype}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} do not match "
                         f"batch {B}")
    if block_tables.shape[1] > CUDA_MAX_TABLE_PAGES:
        raise ValueError(f"block table width {block_tables.shape[1]} > "
                         f"{CUDA_MAX_TABLE_PAGES} pages")
    if H // k_cache.shape[1] not in CUDA_GROUP_SIZES:
        raise ValueError(f"{H // k_cache.shape[1]} query heads per KV head: "
                         f"the CUDA kernel takes {CUDA_GROUP_SIZES}")


# the C entry of csrc/paged_attention.cu: q, k_cache, v_cache,
# block_tables, seq_lens, out, B, H, KVH, D, page, max_pages, scale,
# dtype, stream -> cudaError_t
C_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _kernel_lib():
    fn = build.load(KERNEL_SOURCE).paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def paged_attention_decode(q, k_cache, v_cache, block_tables, seq_lens,
                           sm_scale=None, k_scale=None, v_scale=None):
    """One decode step of attention over a paged KV cache.

    q:            (B, H, D) — current-step queries; query head h reads
                  KV head h // (H // KVH).
    k/v_cache:    (num_pages, KVH, page_size, D), q's dtype.
    block_tables: (B, max_pages) int32 page ids; slot j covers tokens
                  [j*page_size, (j+1)*page_size); unused slots hold a
                  valid page id (0), masked by seq_lens.
    seq_lens:     (B,) int32 live tokens per sequence (including the
                  token being decoded); 0 marks a pad row -> zeros.
    Returns (B, H, D) in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in `.launches`) or raise.
    """
    if k_scale is not None or v_scale is not None:
        raise ValueError("int8 KV (k_scale/v_scale) is not ported")
    B, H, D = q.shape
    check_supported_paged(q.shape, k_cache.shape, q.dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_cache, v_cache, block_tables,
                                          seq_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda or cpu "
                         f"tensors, not {q.device}")
    _check_cuda_args(q, k_cache, v_cache, block_tables, seq_lens)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel_lib()
    _, KVH, page, _ = k_cache.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), B, H, KVH, D, page,
                 block_tables.shape[1], float(sm_scale),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed: "
                           f"cudaError {err}")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def alloc_paged_cache(num_kv_heads, num_pages, page_size, head_dim,
                      dtype=torch.bfloat16, device=None):
    """An empty (k, v) paged cache pair in the kernel's layout, on the
    card unless `device` says otherwise."""
    shape = (num_pages, num_kv_heads, page_size, head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def paged_cache_write(k_cache, v_cache, k_new, v_new, block_tables,
                      write_pos):
    """Write one step's K/V into the paged cache, IN PLACE (the caches
    are engine-owned; returning them keeps the reference's signature).

    k_new/v_new: (B, KVH, D) — the current token's key/value per head.
    write_pos:   (B,) — token index being written (seq_len - 1).

    A bucket pad row carries write_pos -1; the reference drops it (an
    out-of-bounds scatter offset), where a torch index of -1 would wrap
    into the last slot. Here such a row is dropped by construction: it
    rewrites slot 0 of pad page 0 with that slot's own contents, so the
    cache is bitwise unchanged, with no host sync. Live rows never
    address page 0 (the allocator never hands it out).
    """
    num_pages, KVH, page_size, D = k_cache.shape
    pos = write_pos.long()
    dead = pos < 0
    P = block_tables.shape[1]
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                           0, P - 1)
    pages = block_tables.long().gather(1, page_idx[:, None])[:, 0]
    pages = torch.where(dead, torch.zeros_like(pages), pages)
    off = torch.where(dead, torch.zeros_like(pos), pos % page_size)
    heads = torch.arange(KVH, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        vals = torch.where(dead[:, None, None], cache[0, :, 0][None],
                           new.to(cache.dtype))
        cache[pages[:, None], heads[None, :], off[:, None]] = vals
    return k_cache, v_cache


def paged_cache_write_range(k_cache, v_cache, k_new, v_new, block_table,
                            length, start=0):
    """Write a prefill span's K/V (one sequence) into the paged cache,
    IN PLACE.

    k_new/v_new:  (S, KVH, D) — keys/values for positions
                  start..start+S-1 (S may exceed `length`: the tail is
                  bucket padding).
    block_table:  (max_pages,) int32 — the sequence's page ids.
    length:       live tokens in this span; positions >= length are
                  routed to page 0, the pad page (duplicate writes there
                  pick an arbitrary winner, which is safe only because
                  page 0 is never read unmasked).
    start:        absolute token position of k_new[0].
    """
    num_pages, KVH, page_size, D = k_cache.shape
    S = k_new.shape[0]
    P = block_table.shape[0]
    t = torch.arange(S, device=k_cache.device)
    live = t < length
    pos = t + start
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                           0, P - 1)
    pages = torch.where(live, block_table.long()[page_idx],
                        torch.zeros_like(page_idx))
    off = pos % page_size
    heads = torch.arange(KVH, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[pages[:, None], heads[None, :], off[:, None]] = \
            new.to(cache.dtype)
    return k_cache, v_cache
