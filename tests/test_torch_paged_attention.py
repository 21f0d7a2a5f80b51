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


def test_cache_write_matches_reference_and_drops_pad_rows():
    """A pad decode row writes at position -1. The reference drops it (an
    out-of-bounds scatter offset); a torch index of -1 would wrap into
    the last slot. The port must leave the cache unchanged for it."""
    rng = np.random.RandomState(1)
    num_pages, KVH, page, D = 9, 2, 8, 64
    kc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    bt = np.array([[3, 5, 0], [0, 0, 0], [7, 2, 8]], np.int32)
    pos = np.array([12, -1, 17], np.int32)       # row 1 is a pad row
    kn = rng.randn(3, KVH, D).astype(np.float32)
    vn = rng.randn(3, KVH, D).astype(np.float32)
    want_k, want_v = ref_pa.paged_cache_write(
        *(jnp.asarray(a) for a in (kc, vc, kn, vn, bt, pos)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pa.paged_cache_write(tk, tv, *(torch.from_numpy(a)
                                   for a in (kn, vn, bt, pos)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
    # exactly the two live (page, slot)s changed: the pad row wrote
    # nothing — in particular not the last slot of its page 0
    diff_slots = {(p, s) for p, h, s in np.argwhere(
        np.any(tk.numpy() != kc, axis=3)).tolist()}
    assert diff_slots == {(5, 4), (8, 1)}


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
