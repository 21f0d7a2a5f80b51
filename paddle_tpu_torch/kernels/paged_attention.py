"""Paged-KV decode attention and the paged-cache writes (port of
`paddle_tpu/kernels/paged_attention.py`).

Cache layout (unchanged from the reference): each layer's K and V live
as (num_pages, KVH, page_size, D) tensors, page-major; sequences own
pages through an int32 block table, and page 0 is the pad page that
unused block-table slots point at (reads of it are masked by seq_lens).

`paged_attention_decode` is the one kernel of the serving path. On a
CUDA tensor it launches the hand-written Hopper kernel
`csrc/paged_attention.cu` (it replaces the Pallas `_decode_kernel`; the
source note there says what bounds it and how the design answers: split
KV over pages within the grid `paged_decode_plan` sizes, each row split
by its own length and the launch's shapes alone (`paged_decode_splits` is
the same rule in Python), so a row's result does not depend on the rows
batched with it, fed by a ring of bulk copies, the splits merged in split
order by the last block in one launch) or raises; on a CPU tensor it runs
`paged_attention_decode_ref`, the plain PyTorch version beside it. The
cache writes are index writes, as they were XLA scatters in the
reference.

int8 KV (the reference's `kv_dtype="int8"`): value pages are int8 with
fp32 per-(page, head, slot) scales in (num_pages, KVH, page_size) scale
pages addressed by the same page ids; writes quantize on the way in
(`quantize_kv`) and the decode kernel's int8 variant dequantizes on the
way out. The zeroed pad page dequantizes to exact zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import resolve_device
from . import build

__all__ = ["paged_attention_decode", "paged_attention_decode_ref",
           "paged_attention_decode_tp",
           "paged_cache_write", "paged_cache_write_range",
           "paged_cache_write_span",
           "alloc_paged_cache", "check_supported_paged", "paged_page_bytes",
           "quantize_kv", "KV_QMAX", "KV_SCALE_DTYPE", "paged_decode_plan",
           "paged_decode_splits", "paged_split_pages", "KERNEL_SOURCE",
           "CUDA_GROUP_SIZES", "CUDA_MAX_TABLE_PAGES", "SPLIT_BLOCKS_PER_SM", "SPLIT_MIN_TOKENS",
           "SPLIT_MAX"]

KERNEL_SOURCE = "paged_attention.cu"
# query heads per KV head the CUDA kernel is instantiated for, and the
# widest block table it stages in shared memory
CUDA_GROUP_SIZES = (1, 2, 4, 8)
CUDA_MAX_TABLE_PAGES = 2048
# the split-KV plan: blocks per SM it aims at (those the kernel keeps
# resident at Llama-3-8B's widths), the fewest tokens a split holds (two
# ring stages) unless its row is shorter, and the most splits of a row
# (the kernel's merge stages that many)
SPLIT_BLOCKS_PER_SM, SPLIT_MIN_TOKENS, SPLIT_MAX = 3, 128, 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# int8 KV: symmetric, qmax 127 (the weight quantizer's convention), fp32
# per-(token, head) scales
KV_QMAX = 127.0
KV_SCALE_DTYPE = torch.float32


def quantize_kv(x):
    """Per-(token, head) symmetric int8 quantization over the head dim.

    x (..., D) float -> (int8 values (..., D), fp32 scales (...,)):
    fp32 absmax clamped at 1e-10, scale = absmax / 127, values
    round(x / scale) (half to even) clipped to +-127. dequant(q, s) =
    q * s is within scale / 2 of x per element."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1).clamp_min(1e-10)
    scale = absmax / KV_QMAX
    q = torch.round(xf / scale[..., None]).clamp_(-KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale.to(KV_SCALE_DTYPE)


def paged_page_bytes(num_kv_heads, page_size, head_dim, kv_dtype=None):
    """Device bytes one page costs: K + V payload, plus the fp32 per-slot
    scales for int8. The single source for the engine's pool sizing and
    bytes-moved accounting."""
    if kv_dtype in (None, "bf16", "bfloat16", "float16"):
        width, scale_b = 2, 0
    elif kv_dtype in ("float32", "fp32"):
        width, scale_b = 4, 0
    elif kv_dtype == "int8":
        width, scale_b = 1, 4
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return 2 * num_kv_heads * page_size * (head_dim * width + scale_b)


def paged_decode_plan(KVH, page, num_sms):
    """(chunks, min_chunk) of a CUDA launch: about `chunks` splits per KV
    head, so the grid's (KVH, chunks + B) blocks fill the card once at
    SPLIT_BLOCKS_PER_SM blocks an SM, of about `min_chunk` pages or more.
    Shapes only: the kernel splits the rows itself from seq_lens on the
    card (`paged_decode_splits`)."""
    return (max(1, SPLIT_BLOCKS_PER_SM * num_sms // KVH),
            -(-SPLIT_MIN_TOKENS // page))


def paged_split_pages(B, P, chunks, min_chunk):
    """The most pages one split takes (`split_pages` in the kernel), from
    the launch's shapes alone: Q = max(ceil(B * P / c), min_chunk,
    ceil(P / SPLIT_MAX)), capped at P, c = chunks - B when that is at
    least half of chunks, else ceil(chunks / 2). B rows at the table's
    full width P then take about c splits, and any B rows at most
    B * P / Q + B <= chunks + B."""
    c = chunks - B if chunks - B >= (chunks + 1) // 2 else (chunks + 1) // 2
    return min(max(-(-B * P // c), min_chunk, -(-P // SPLIT_MAX)), P)


def paged_decode_splits(seq_lens, page, P, chunks, min_chunk):
    """The split every block of the CUDA kernel computes from seq_lens:
    [(first block, splits, pages per split)] per row. Row r holds n_r
    pages (its length cut to the P-page table) and takes ceil(n_r / p_r)
    splits of p_r = ceil(n_r / ceil(n_r / Q)) pages (none empty; Q / 2 to
    Q when there are several), Q = `paged_split_pages(B, P, chunks,
    min_chunk)`; an empty row takes one split (which writes its zeros);
    rows in order. A row's (splits, pages per split) depend on its own
    length and the launch's shapes only, never on the other rows."""
    n = [-(-min(max(int(x), 0), P * page) // page) for x in seq_lens]
    Q = paged_split_pages(len(n), P, chunks, min_chunk)
    rows, first = [], 0
    for nr in n:
        pr, sp = 1, 1
        if nr:
            pr = -(-nr // -(-nr // Q))
            sp = -(-nr // pr)
        rows.append((first, sp, pr))
        first += sp
    return rows


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_supported_paged(q_shape, cache_shape, dtype, kv_dtype=None):
    """Static shape validation, the reference's rules: q head_dim equals
    the cache's, H a multiple of KVH, head_dim a multiple of 64 and at
    most 256, page_size a multiple of 8, bfloat16 or float32 queries.
    `kv_dtype` names a quantized cache storage: None (the query dtype)
    or "int8"."""
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
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None or "
                         "'int8')")


def paged_attention_decode_ref(q, k_cache, v_cache, block_tables, seq_lens,
                               sm_scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each sequence's pages into a dense
    (B, KVH, P*page, D) view (int8 pages dequantized during the gather,
    values times their per-slot scales in fp32, the reference kernel's
    order), score in fp32, mask positions >= seq_len, softmax, weight V.
    A row with seq_len 0 gives zeros (the sum is clamped at 1e-30 like
    the kernels)."""
    B, H, D = q.shape
    _, KVH, page, _ = k_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    bt = block_tables.long()

    def dense(cache, sc):                  # (B, KVH, P*page, D) fp32
        g = cache[bt].float()              # (B, P, KVH, page, D)
        if sc is not None:
            g = g * sc[bt][..., None]
        return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, -1, D)

    k, v = dense(k_cache, k_scale), dense(v_cache, v_scale)
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


def _check_scales(k_cache, k_scale, v_scale):
    """The reference's loud mismatch rules: scales come in pairs, only
    with an int8 cache, and an int8 cache needs them. Returns whether
    the cache is quantized."""
    quantized = k_scale is not None or v_scale is not None
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quantized and k_cache.dtype != torch.int8:
        raise ValueError(f"scales given but cache dtype is {k_cache.dtype}, "
                         f"not int8")
    if not quantized and k_cache.dtype == torch.int8:
        raise ValueError("int8 cache needs k_scale/v_scale")
    return quantized


def _check_cuda_args(q, k_cache, v_cache, block_tables, seq_lens,
                     k_scale=None, v_scale=None):
    B, H, _ = q.shape
    quantized = k_scale is not None
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("block_tables", block_tables), ("seq_lens", seq_lens)]
    if quantized:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = torch.int8 if quantized else q.dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"cache dtype {k_cache.dtype}/{v_cache.dtype} "
                         f"must be {want} (q dtype {q.dtype})")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != KV_SCALE_DTYPE or t.shape != k_cache.shape[:3]:
                raise ValueError(f"{name} must be {KV_SCALE_DTYPE} "
                                 f"{tuple(k_cache.shape[:3])}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} do not match "
                         f"batch {B}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if block_tables.shape[1] > CUDA_MAX_TABLE_PAGES:
        raise ValueError(f"block table width {block_tables.shape[1]} > "
                         f"{CUDA_MAX_TABLE_PAGES} pages")
    if H // k_cache.shape[1] not in CUDA_GROUP_SIZES:
        raise ValueError(f"{H // k_cache.shape[1]} query heads per KV head: "
                         f"the CUDA kernel takes {CUDA_GROUP_SIZES}")


# the C entry of csrc/paged_attention.cu: q, k_cache, v_cache, k_scale,
# v_scale, block_tables, seq_lens, out, ws, tickets, B, H, KVH, D, page,
# max_pages, chunks, min_chunk, scale, dtype, stream -> cudaError_t (null
# scales: full-width caches)
C_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# per device: the SM count, and the kernel's scratch — the fp32
# workspace of the splits' partials (a launch reads back all it writes,
# so launches in one stream's order share it) and the merge's ticket
# counters (zeroed once; each launch leaves the ones it used at 0). Not
# for concurrent launches on several streams.
_SCRATCH = {}


def _scratch(device, B, H, KVH, D, page):
    """(chunks, min_chunk, ws, tickets) of a launch on `device`."""
    sms, ws, tickets = _SCRATCH.get(device, (None, None, None))
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks, min_chunk = paged_decode_plan(KVH, page, sms)
    n_ws = (chunks + B) * H * (D + 2)
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < B * KVH:
        tickets = torch.zeros(B * KVH, dtype=torch.int32, device=device)
    _SCRATCH[device] = (sms, ws, tickets)
    return chunks, min_chunk, ws, tickets


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
    k/v_cache:    (num_pages, KVH, page_size, D), q's dtype — or int8
                  with k/v_scale given.
    block_tables: (B, max_pages) int32 page ids; slot j covers tokens
                  [j*page_size, (j+1)*page_size); unused slots hold a
                  valid page id (0), masked by seq_lens.
    seq_lens:     (B,) int32 live tokens per sequence (including the
                  token being decoded); 0 marks a pad row -> zeros.
    k/v_scale:    optional (num_pages, KVH, page_size) fp32 per-slot
                  dequant scales of int8 caches (both or neither).
    Returns (B, H, D) in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. Launches are counted in
    `.launches` (full-width caches) and `.int8_launches` (int8).
    """
    quantized = _check_scales(k_cache, k_scale, v_scale)
    B, H, D = q.shape
    check_supported_paged(q.shape, k_cache.shape, q.dtype,
                          kv_dtype="int8" if quantized else None)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_cache, v_cache, block_tables,
                                          seq_lens, sm_scale, k_scale,
                                          v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda or cpu "
                         f"tensors, not {q.device}")
    _check_cuda_args(q, k_cache, v_cache, block_tables, seq_lens, k_scale,
                     v_scale)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel_lib()
    _, KVH, page, _ = k_cache.shape
    P = block_tables.shape[1]
    with torch.cuda.device(q.device):
        chunks, min_chunk, ws, tickets = _scratch(q.device, B, H, KVH, D,
                                                  page)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                 B, H, KVH, D, page, P, chunks, min_chunk, float(sm_scale),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_decode kernel launch failed: "
                           f"cudaError {err}")
    if quantized:
        paged_attention_decode.int8_launches += 1
    else:
        paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
paged_attention_decode.int8_launches = 0


def paged_attention_decode_tp(q, k_cache, v_cache, block_tables, seq_lens,
                              mesh, axis="model", sm_scale=None,
                              k_scale=None, v_scale=None):
    """Tensor-parallel decode attention: query heads and the KV pages'
    head dim split over the mesh's `axis`, one rank per process.

    Page ids are global (the host-side allocator and radix tree never
    see the mesh); page contents are head-split. Each rank passes its
    own shards: q (B, H/tp, D), the caches (num_pages, KVH/tp, page, D)
    and, for int8 KV, the scale pages (num_pages, KVH/tp, page); the
    block tables and seq_lens are the same on every rank. G = H/KVH is
    the same on every shard, so each rank attends its own heads through
    `paged_attention_decode` and no collective runs here: the sum lives
    in the row-parallel o_proj that consumes the output. Returns this
    rank's (B, H/tp, D). The split of the whole head counts is checked
    where they are split (`LlamaForCausalLM.shard_`, the engine), with
    the reference's messages."""
    tp = int(dict(mesh.shape)[axis])
    H, KVH = q.shape[1], k_cache.shape[1]
    if H % KVH:
        raise ValueError(f"a shard's H={H} query heads are not whole "
                         f"groups of its KVH={KVH} kv heads (tp={tp})")
    return paged_attention_decode(q, k_cache, v_cache, block_tables,
                                  seq_lens, sm_scale=sm_scale,
                                  k_scale=k_scale, v_scale=v_scale)


def alloc_paged_cache(num_kv_heads, num_pages, page_size, head_dim,
                      dtype=torch.bfloat16, device=None, kv_dtype=None):
    """An empty paged cache in the kernel's layout, on the card unless
    `device` says otherwise: (k, v) in `dtype`, or with kv_dtype="int8"
    (k, v, k_scale, v_scale) — int8 value pages and zeroed fp32
    (num_pages, KVH, page_size) scale pages (zero scales dequantize the
    pad page to exact zeros)."""
    shape = (num_pages, num_kv_heads, page_size, head_dim)
    dev = resolve_device(device)
    if kv_dtype == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:3], dtype=KV_SCALE_DTYPE, device=dev),
                torch.zeros(shape[:3], dtype=KV_SCALE_DTYPE, device=dev))
    if kv_dtype is not None:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _maybe_quantize(cache, new, scale):
    """Quantize-on-write when the cache is int8. Returns (values to
    write, per-slot scales or None); raises on a scale/dtype mismatch so
    a mis-threaded engine config fails loudly, not as garbage KV."""
    if scale is None:
        if cache.dtype == torch.int8:
            raise ValueError("int8 cache write needs scale buffers")
        return new.to(cache.dtype), None
    if cache.dtype != torch.int8:
        raise ValueError(f"scale buffer given but cache dtype is "
                         f"{cache.dtype}, not int8")
    return quantize_kv(new)


def paged_cache_write(k_cache, v_cache, k_new, v_new, block_tables,
                      write_pos, k_scale=None, v_scale=None):
    """Write one step's K/V into the paged cache, IN PLACE (the caches
    are engine-owned; returning them keeps the reference's signature).

    k_new/v_new: (B, KVH, D) — the current token's key/value per head.
    write_pos:   (B,) — token index being written (seq_len - 1).
    k/v_scale:   optional fp32 scale pages of int8 caches: the values
                 are quantized on write and their per-slot scales land
                 at the same (page, head, slot) indices.
    Returns (k_cache, v_cache), plus (k_scale, v_scale) when given.

    A bucket pad row carries write_pos -1, and a row frozen at its cap in
    a multi-step decode launch writes one slot past its sequence, which
    may lie past the block table; the reference drops both (an
    out-of-bounds scatter offset, an out-of-range page id), where a
    torch index would wrap or clamp into a live slot. Here such a row is
    dropped by construction: it rewrites slot 0 of pad page 0 (values
    and scale) with that slot's own contents, so the cache is bitwise
    unchanged, with no host sync. Live rows never address page 0 (the
    allocator never hands it out). This is `paged_cache_write_span` at
    one position a row.
    """
    pos = write_pos.long()
    return paged_cache_write_span(k_cache, v_cache, k_new[:, None],
                                  v_new[:, None], block_tables,
                                  torch.ones_like(pos), pos,
                                  k_scale=k_scale, v_scale=v_scale)


def paged_cache_write_range(k_cache, v_cache, k_new, v_new, block_table,
                            length, start=0, k_scale=None, v_scale=None):
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
    k/v_scale:    optional fp32 scale pages of int8 caches (quantize on
                  write; scales at the values' (page, head, slot)).
    Returns (k_cache, v_cache), plus (k_scale, v_scale) when given.
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
    idx = (pages[:, None], heads[None, :], off[:, None])
    for cache, new, scale in ((k_cache, k_new, k_scale),
                              (v_cache, v_new, v_scale)):
        vals, sc = _maybe_quantize(cache, new, scale)
        cache[idx] = vals
        if sc is not None:
            scale[idx] = sc
    if k_scale is None:
        return k_cache, v_cache
    return k_cache, v_cache, k_scale, v_scale


def paged_cache_write_span(k_cache, v_cache, k_new, v_new, block_tables,
                           lengths, starts, k_scale=None, v_scale=None):
    """Write a BATCH of short spans' K/V into the paged cache, IN PLACE
    — the speculative verify write: every row lands its [last emitted
    token, draft_1..draft_K] K/V in one index write.

    k_new/v_new:  (B, S, KVH, D) — row b holds positions
                  starts[b]..starts[b]+S-1.
    block_tables: (B, max_pages) int32 — per-sequence page ids.
    lengths:      (B,) — live tokens of each row's span (1 + its draft
                  length); positions from lengths[b] on are bucket
                  padding.
    starts:       (B,) — absolute position of k_new[b, 0] (seq_len - 1:
                  the first input token rewrites its own slot, so a
                  retried launch is bitwise idempotent; int8 quantizes
                  on write, deterministically).
    k/v_scale:    optional fp32 scale pages of int8 caches.
    Returns (k_cache, v_cache), plus (k_scale, v_scale) when given.

    Padding positions, a pad row's (which starts at -1) and positions
    past the block table are dropped: each rewrites slot 0 of pad page
    0 (values and scale) with that slot's own contents, so page 0 stays
    bitwise unchanged whatever the duplicates, with no host sync — where
    the reference scatters pad values into page 0 (never read unmasked
    either way) and drops out-of-range ones.
    """
    num_pages, KVH, page_size, D = k_cache.shape
    B, S = k_new.shape[:2]
    P = block_tables.shape[1]
    dev = k_cache.device
    t = torch.arange(S, device=dev)[None, :]
    pos = t + starts.long()[:, None]                           # (B, S)
    dead = ((t >= lengths.long()[:, None]) | (pos < 0)
            | (pos >= P * page_size))
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                           0, P - 1)
    pages = block_tables.long().gather(1, page_idx)
    pages = torch.where(dead, torch.zeros_like(pages), pages)
    off = torch.where(dead, torch.zeros_like(pos), pos % page_size)
    heads = torch.arange(KVH, device=dev)
    idx = (pages[:, :, None], heads[None, None, :], off[:, :, None])
    for cache, new, scale in ((k_cache, k_new, k_scale),
                              (v_cache, v_new, v_scale)):
        vals, sc = _maybe_quantize(cache, new, scale)
        cache[idx] = torch.where(dead[:, :, None, None],
                                 cache[0, :, 0][None, None], vals)
        if sc is not None:
            scale[idx] = torch.where(dead[:, :, None],
                                     scale[0, :, 0][None, None], sc)
    if k_scale is None:
        return k_cache, v_cache
    return k_cache, v_cache, k_scale, v_scale
