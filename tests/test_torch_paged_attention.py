"""The port's paged-attention module against the reference on the CPU.

`paged_attention_decode` on CPU tensors runs its plain version
(`paged_attention_decode_ref`); it is held against the reference's
Pallas kernel, which runs in interpret mode off the TPU (as in
tests/test_serving.py). fp32, atol 1e-5: the two sum in different
orders. The cache writes are held bit-exact, including the pad-row and
dead-position contracts. The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py holds it against this plain version there.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as ref_pa
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import paged_attention as pa


def _paged_case(B, KVH, G, D, page, max_pages, seq_lens, seed):
    """Random q and a paged cache whose pages are handed out in shuffled
    (non-contiguous) order; page 0 stays the pad page."""
    rng = np.random.RandomState(seed)
    H = KVH * G
    num_pages = B * max_pages + 3
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((B, max_pages), np.int32)
    n = 0
    for b in range(B):
        for j in range(-(-int(seq_lens[b]) // page)):
            bt[b, j] = perm[n]
            n += 1
    return q, kc, vc, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("G", [1, 4])
def test_decode_matches_reference_kernel(G):
    # mid-page lengths, a full table and a seq_len-0 pad row
    args = _paged_case(B=4, KVH=2, G=G, D=128, page=16, max_pages=4,
                       seq_lens=[5, 37, 0, 64], seed=G)
    want = np.asarray(ref_pa.paged_attention_decode(
        *(jnp.asarray(a) for a in args)))
    before = pa.paged_attention_decode.launches
    got = pa.paged_attention_decode(*(torch.from_numpy(a) for a in args))
    assert pa.paged_attention_decode.launches == before  # CPU: plain path
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.all(got.numpy()[2] == 0.0)                 # pad row: zeros


def test_decode_bf16_plain_version_matches_fp32_within_rounding():
    args = _paged_case(B=3, KVH=2, G=4, D=64, page=8, max_pages=5,
                       seq_lens=[1, 19, 40], seed=5)
    q, kc, vc, bt, sl = (torch.from_numpy(a) for a in args)
    want = pa.paged_attention_decode_ref(q, kc, vc, bt, sl)
    got = pa.paged_attention_decode_ref(q.bfloat16(), kc.bfloat16(),
                                        vc.bfloat16(), bt, sl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


@pytest.mark.parametrize("bad", [
    dict(q_shape=(2, 4, 96), cache_shape=(8, 2, 16, 96)),   # D % 64
    dict(q_shape=(2, 4, 64), cache_shape=(8, 2, 12, 64)),   # page % 8
    dict(q_shape=(2, 5, 64), cache_shape=(8, 2, 16, 64)),   # H % KVH
    dict(q_shape=(2, 4, 64), cache_shape=(8, 2, 16, 128)),  # D mismatch
])
def test_check_supported_paged_rejects_like_reference(bad):
    for mod, dt in ((pa, torch.float32), (ref_pa, jnp.float32)):
        with pytest.raises(ValueError):
            mod.check_supported_paged(bad["q_shape"], bad["cache_shape"], dt)


def test_int8_kv_is_refused():
    """Scales with a full-width cache, and a float16 query, are refused
    (int8 caches with their scales: tests/test_torch_quant.py)."""
    args = [torch.from_numpy(a) for a in _paged_case(
        B=1, KVH=1, G=1, D=64, page=8, max_pages=1, seq_lens=[3], seed=0)]
    with pytest.raises(ValueError, match="int8"):
        pa.paged_attention_decode(*args, k_scale=args[1], v_scale=args[2])
    with pytest.raises(ValueError, match="float16|dtype"):
        pa.check_supported_paged((1, 1, 64), (2, 1, 8, 64), torch.float16)


def _check_write_drops_row_1(pos1):
    """Three rows writing at 12, `pos1` and 17 over 3-page tables (page
    8): the cache must equal the reference's, with exactly rows 0 and
    2's (page, slot)s changed — row 1 writes nothing."""
    rng = np.random.RandomState(1)
    num_pages, KVH, page, D = 9, 2, 8, 64
    kc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    bt = np.array([[3, 5, 0], [0, 0, 0], [7, 2, 8]], np.int32)
    pos = np.array([12, pos1, 17], np.int32)
    kn = rng.randn(3, KVH, D).astype(np.float32)
    vn = rng.randn(3, KVH, D).astype(np.float32)
    want_k, want_v = ref_pa.paged_cache_write(
        *(jnp.asarray(a) for a in (kc, vc, kn, vn, bt, pos)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pa.paged_cache_write(tk, tv, *(torch.from_numpy(a)
                                   for a in (kn, vn, bt, pos)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
    diff_slots = {(p, s) for p, h, s in np.argwhere(
        np.any(tk.numpy() != kc, axis=3)).tolist()}
    assert diff_slots == {(5, 4), (8, 1)}


def test_cache_write_matches_reference_and_drops_pad_rows():
    """A pad decode row writes at position -1. The reference drops it (an
    out-of-bounds scatter offset); a torch index of -1 would wrap into
    the last slot. The port must leave the cache unchanged for it — in
    particular not the last slot of its page 0."""
    _check_write_drops_row_1(-1)


def test_cache_write_drops_rows_past_the_table():
    """A row frozen at its cap in a multi-step decode launch writes one
    slot past its sequence, which may lie past the block table (here
    position 24: page 3 of a 3-page table). The reference drops it (an
    out-of-range page id); a clamped index would rewrite slot 0 of the
    row's last page."""
    _check_write_drops_row_1(24)


@pytest.mark.parametrize("start,length", [(0, 9), (5, 9), (13, 3)])
def test_cache_write_range_matches_reference(start, length):
    """Prefill span writes: live positions land bit-exact; dead (padding)
    positions go to page 0, the pad page, whose contents are arbitrary
    under duplicate writes and never read unmasked — so page 0 is left
    out of the comparison."""
    rng = np.random.RandomState(start)
    num_pages, KVH, page, D = 10, 2, 8, 64
    S = 16
    kc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    kn = rng.randn(S, KVH, D).astype(np.float32)
    vn = rng.randn(S, KVH, D).astype(np.float32)
    bt = np.array([6, 2, 9, 0], np.int32)
    want_k, want_v = ref_pa.paged_cache_write_range(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(bt), jnp.int32(length), jnp.int32(start))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pa.paged_cache_write_range(tk, tv, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(bt),
                               length, start)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(want_k)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(want_v)[1:])


def test_page_bytes_and_alloc_match_reference():
    for kvd in ("bfloat16", "float32"):
        assert pa.paged_page_bytes(8, 16, 128, kvd) == \
            ref_pa.paged_page_bytes(8, 16, 128, kvd)
    assert pa.paged_page_bytes(8, 16, 128, "bfloat16") == 65536
    k, v = pa.alloc_paged_cache(2, 5, 8, 64, dtype=torch.float32,
                                device="cpu")
    assert k.shape == (5, 2, 8, 64) and not k.any() and not v.any()


# ------------------------------------------------- split-KV plan and merge
def _serve_lens(seed, B=16, page=16, P=72):
    """Lengths like the serve phase's decode batch (chip_smoke.serve_lens):
    128 to P pages, the last row a seq_len-0 pad row."""
    sl = np.random.RandomState(seed).randint(128, P * page + 1, size=B)
    sl[-1] = 0
    return sl.tolist()


@pytest.mark.parametrize("name,lens,P,want", [
    # the serve batch: 16 rows of 128-1152 tokens in a 72-page table, a
    # pad row; splits of at most 35 pages (16 rows x 72 pages over 33),
    # here 27 of at most 31, 1 to 2 a row
    ("serve", _serve_lens(0), 72, (27, 2, 1, 31)),
    # one request over the widest table: 48 splits of 43 pages
    ("b1_32768", [32768], 2048, (48, 48, 48, 43)),
    # four at Llama-3's 8192-token context
    ("b4_8192", [8192] * 4, 512, (48, 12, 12, 43)),
    # a wide batch of short rows: one split each
    ("b64_128", [128] * 64, 8, (64, 1, 1, 8)),
])
def test_paged_decode_plan_table(name, lens, P, want):
    """At the H100's 132 SMs and Llama-3-8B's 8 KV heads: the grid's
    chunks and the least split, then the batch's splits per KV head, the
    most and fewest a row takes and the largest split in pages."""
    chunks, min_chunk = pa.paged_decode_plan(8, 16, 132)
    assert (chunks, min_chunk) == (49, 8)
    rows = pa.paged_decode_splits(lens, 16, P, chunks, min_chunk)
    total = sum(sp for _, sp, _ in rows)
    live = [(sp, pr) for (_, sp, pr), n in zip(rows, lens) if n]
    got = (total, max(sp for sp, _ in live), min(sp for sp, _ in live),
           max(pr for _, pr in live))
    assert got == want
    assert total <= chunks + len(lens)


def test_paged_decode_splits_cover_each_row_with_none_empty():
    """Over seeded batches, the longest row a table allows included: each
    row's splits cover its pages exactly, none empty (the last may be
    shorter), at most SPLIT_MAX of them, each at least half of min_chunk
    pages when the row has more than one (a row of n >= Q pages splits
    into ceil(n / Q) of ceil(n / ceil(n / Q)) >= Q / 2 pages, Q >=
    min_chunk); the rows' splits follow one another
    and fit the grid's chunks + B rows; an empty row takes one split."""
    rng = np.random.RandomState(0)
    for _ in range(1000):
        B, KVH = int(rng.randint(1, 65)), int(rng.choice([1, 2, 4, 8]))
        page = 8 * int(rng.randint(1, 17))
        P = int(rng.randint(1, pa.CUDA_MAX_TABLE_PAGES + 1))
        sms = int(rng.choice([1, 16, 78, 114, 132]))
        lens = rng.randint(0, P * page + 1, size=B)
        lens[rng.randint(B)] = P * page            # the longest possible
        if B > 1:
            lens[rng.randint(B)] = 0
        chunks, min_chunk = pa.paged_decode_plan(KVH, page, sms)
        rows = pa.paged_decode_splits(lens, page, P, chunks, min_chunk)
        first = 0
        for (at, sp, pr), n_tok in zip(rows, lens):
            n = -(-int(n_tok) // page)
            assert at == first
            first += sp
            assert 1 <= sp <= pa.SPLIT_MAX
            if n == 0:
                assert sp == 1
                continue
            assert pr * (sp - 1) < n <= pr * sp
            assert sp == 1 or 2 * pr >= min_chunk
        assert first <= chunks + B


def test_a_rows_splits_do_not_depend_on_the_other_rows():
    """Over seeded batches: each row's (splits, pages per split) equals
    its plan in a batch of the same B and P whose other rows are pad
    rows, and in one whose other rows have other lengths; so its merge,
    and its result, are the same alone or batched."""
    rng = np.random.RandomState(1)
    for _ in range(1000):
        B, KVH = int(rng.randint(1, 65)), int(rng.choice([1, 2, 4, 8]))
        page = 8 * int(rng.randint(1, 17))
        P = int(rng.randint(1, pa.CUDA_MAX_TABLE_PAGES + 1))
        sms = int(rng.choice([1, 16, 78, 114, 132]))
        chunks, min_chunk = pa.paged_decode_plan(KVH, page, sms)
        lens = rng.randint(0, P * page + 1, size=B)
        others = rng.randint(0, P * page + 1, size=B)
        rows = pa.paged_decode_splits(lens, page, P, chunks, min_chunk)
        for r in range(B):
            alone = np.zeros(B, dtype=np.int64)
            alone[r] = lens[r]
            mixed = others.copy()
            mixed[r] = lens[r]
            for batch in (alone, mixed):
                _, sp, pr = pa.paged_decode_splits(
                    batch, page, P, chunks, min_chunk)[r]
                assert (sp, pr) == rows[r][1:], (B, P, r)


def _split_merge_model(q, kc, vc, bt, sl, rows, scale, tile=64):
    """The CUDA kernel's split-KV arithmetic (bf16 queries' path) in plain
    PyTorch, fp32, in its order: per (row, KV head) the row's splits
    (`rows`, from paged_decode_splits), each split's stages of `tile`
    tokens shared by 4 warps of 16 tokens, each warp an online softmax in
    the log2 domain; the warps merged with weights 2^(m - max), one split
    normalised alone, several merged in split order the same way; an
    empty row gives zeros."""
    B, H, D = q.shape
    _, KVH, page, _ = kc.shape
    G, P = H // KVH, bt.shape[1]
    out = torch.zeros(B, H, D)

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        a, lsum = torch.zeros(G, D), torch.zeros(G)
        for m, l, acc in parts:
            w = torch.exp2(m - mx)
            a = a + acc * w[:, None]
            lsum = lsum + l * w
        return mx, lsum, a

    for b, (_, sp, pr) in enumerate(rows):
        n = min(max(int(sl[b]), 0), P * page)
        n_pages = -(-n // page)
        if n_pages == 0:
            continue
        pos = torch.arange(P * page)
        slots = bt[b].long()[pos // page] * page + pos % page
        for h in range(KVH):
            kk = kc[:, h].reshape(-1, D)[slots]
            vv = vc[:, h].reshape(-1, D)[slots]
            qs = q[b, h * G:(h + 1) * G]
            splits = []
            for z in range(sp):
                t0 = z * pr * page
                t1 = min(n, (z * pr + min(pr, n_pages - z * pr)) * page)
                warps = []
                for w in range(4):
                    m = torch.full((G,), -1e30)
                    l = torch.zeros(G)
                    acc = torch.zeros(G, D)
                    for a in range(t0 + 16 * w, t1, tile):
                        e = min(a + 16, t1)
                        sc = (qs @ kk[a:e].T) * (scale * math.log2(math.e))
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        p = torch.exp2(sc - m_new[:, None])
                        alpha = torch.exp2(m - m_new)
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ vv[a:e]
                        m = m_new
                    warps.append((m, l, acc))
                splits.append(merge(warps))
            _, l, acc = merge(splits)
            out[b, h * G:(h + 1) * G] = acc / l.clamp_min(1e-30)[:, None]
    return out


def test_split_merge_model_matches_reference_kernel():
    """The kernel's split-and-merge, modelled in PyTorch, against the
    reference's Pallas kernel (interpret mode), fp32 atol 1e-5, on a
    batch whose rows split at 8 pages (the least split at page 16): one
    token, a seq_len-0 pad row, a row ending on a split boundary, one
    ending mid-page one page past it (two splits of 5 and 4 pages), and
    the full table (two splits)."""
    chunks, min_chunk = pa.paged_decode_plan(2, 16, 132)
    lens = [1, 0, 8 * 16, 8 * 16 + 5, 16 * 16]
    rows = pa.paged_decode_splits(lens, 16, 16, chunks, min_chunk)
    assert [(sp, pr) for _, sp, pr in rows] == [(1, 1), (1, 1), (1, 8),
                                                (2, 5), (2, 8)]
    args = _paged_case(B=5, KVH=2, G=2, D=64, page=16, max_pages=16,
                       seq_lens=lens, seed=7)
    want = np.asarray(ref_pa.paged_attention_decode(
        *(jnp.asarray(a) for a in args)))
    q, kc, vc, bt, sl = (torch.from_numpy(a) for a in args)
    got = _split_merge_model(q, kc, vc, bt, sl, rows, 1.0 / math.sqrt(64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.all(got.numpy()[1] == 0.0)


def test_ctypes_signature_matches_the_cuda_source():
    """The wrapper's ctypes argtypes must mirror the C prototype
    parameter for parameter: a mismatch would pass garbage to the
    kernel, and only the card could show it."""
    src = (build.CSRC / pa.KERNEL_SOURCE).read_text()
    proto = re.search(r'extern "C" int paged_attention_decode\((.*?)\)\s*\{',
                      src, re.S).group(1)
    params = [p.strip() for p in proto.split(",")]
    expect = {"void*": ctypes.c_void_p, "int32_t*": ctypes.c_void_p,
              "int": ctypes.c_int, "float": ctypes.c_float}
    kinds = []
    for p in params:
        ty = p.replace("const ", "").rsplit(" ", 1)[0].replace(" ", "")
        kinds.append(expect[ty])
    assert kinds == pa.C_ARGTYPES


def test_build_path_is_keyed_by_source_and_imports_compile_nothing():
    path = build.library_path(pa.KERNEL_SOURCE)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("paged_attention-")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
