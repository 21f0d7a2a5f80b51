"""The port's quantization pieces against the reference on the CPU:
int8 KV (`quantize_kv`, the scale-carrying paged writes, int8 paged
decode), the weight-only int8 matmul (`quant_matmul_ref`,
`dequant_matmul`) and weight-only linears (`weight_quantize`,
`weight_only_linear`, `quantize_for_serving`).

Quantizers and writes are held bitwise. The attention and matmul plain
versions are held against the reference's Pallas kernels, run in
interpret mode off the TPU (as tests/test_quant_matmul.py runs them),
within 1e-5 at fp32: the two sum in different orders. The CUDA kernels
run only on the card: tests/test_torch_cuda.py holds them against these
plain versions there.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.quant as ref_q
from paddle_tpu.kernels import paged_attention as ref_pa
from paddle_tpu.kernels import quant_matmul as ref_qm
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.nn import quant as pq

from _torch_parity import model_pair


def _np(t):
    """A reference Tensor or array -> numpy."""
    return np.array(getattr(t, "_data", t))


def _weight(K, N, seed, dtype):
    """A seeded (K, N) weight with one all-zero column (the absmax
    clamp), in both frameworks' `dtype`."""
    w = (np.random.RandomState(seed).randn(K, N) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    return (paddle.to_tensor(w).astype(dtype),
            torch.from_numpy(w).to(getattr(torch, dtype)))


# ------------------------------------------------------- weight-only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_quantize_is_bitwise_the_reference(dtype, algo):
    jw, tw = _weight(256, 384, 1, dtype)
    rq, rs = ref_q.weight_quantize(jw, algo=algo)
    got_q, got_s = pq.weight_quantize(tw, algo=algo)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), _np(rq))
    np.testing.assert_array_equal(got_s.numpy(), _np(rs))
    want = ref_q.weight_dequantize(rq, rs, algo=algo)
    np.testing.assert_array_equal(
        pq.weight_dequantize(got_q, got_s, algo=algo).numpy(), _np(want))


# (M, K, N): tile-legal shapes, among them the decode route's extremes —
# one row (the LM head's prefill row) and the 16-row decode bucket
@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (5, 512, 128),
                                   (1, 256, 384), (16, 512, 256)])
def test_quant_matmul_ref_matches_reference_kernel(M, K, N):
    """Tile-legal shapes: the reference runs its Pallas kernel
    (interpret mode); the CPU wrapper runs the plain version and counts
    no launch on any route."""
    assert qm.quant_matmul_supported(M, K, N)
    assert qm.pick_quant_blocks(M, K, N) == ref_qm.pick_quant_blocks(M, K, N)
    _, tw = _weight(K, N, M, "float32")
    qw, s = pq.weight_quantize(tw)
    x = np.random.RandomState(K).randn(M, K).astype(np.float32)
    want = np.asarray(ref_qm.quant_matmul(jnp.asarray(x),
                                          jnp.asarray(qw.numpy()),
                                          jnp.asarray(s.numpy())))
    counters = ("launches", "prefill_launches", "decode_launches")
    before = [getattr(qm.quant_matmul, c) for c in counters]
    got = qm.quant_matmul(torch.from_numpy(x), qw, s)
    assert [getattr(qm.quant_matmul, c) for c in counters] == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(qm.quant_matmul_ref(torch.from_numpy(x), qw,
                                                   s).numpy(), want,
                               rtol=0, atol=1e-5)


def test_dequant_matmul_matches_reference_composition():
    """A shape the reference routes to XLA (N not a multiple of 128)."""
    M, K, N = 5, 200, 72
    assert not pq._wint8_supported(M, K, N)
    _, tw = _weight(K, N, 2, "float32")
    qw, s = pq.weight_quantize(tw)
    x = np.random.RandomState(3).randn(M, K).astype(np.float32)
    want = np.asarray(ref_qm.dequant_matmul_xla(
        jnp.asarray(x), jnp.asarray(qw.numpy()), jnp.asarray(s.numpy())))
    got = qm.dequant_matmul(torch.from_numpy(x), qw, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wdt,K,N", [("int8", 128, 256), ("int8", 200, 72),
                                     ("int4", 128, 256)])
def test_weight_only_linear_matches_reference(wdt, K, N):
    """Both dispatch branches of int8 (kernel numerics / scale-first)
    and int4, with a bias and a 3-D input."""
    algo = f"weight_only_{wdt}"
    jw, tw = _weight(K, N, 4, "float32")
    rq, rs = ref_q.weight_quantize(jw, algo=algo)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    want = ref_q.weight_only_linear(paddle.to_tensor(x), rq,
                                    paddle.to_tensor(b), rs, wdt)
    got = pq.weight_only_linear(torch.from_numpy(x),
                                torch.from_numpy(_np(rq)),
                                torch.from_numpy(b),
                                torch.from_numpy(_np(rs)), wdt)
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def test_quantize_for_serving_converts_the_reference_layers():
    """2 layers: gate/up/down x 2 + the untied head = 7, the same
    state-dict keys and bitwise-equal buffers (forward parity of the
    converted model is the engine test's, test_torch_serving_quant.py)."""
    ref, port = model_pair(seed=4)
    assert ref_q.quantize_for_serving(ref) == 7
    assert pq.quantize_for_serving(port) == 7
    assert pq.quantize_for_serving(port) == 0          # already converted
    want = {k: _np(v) for k, v in ref.state_dict().items()}
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    assert "lm_head.qweight" in got and "lm_head.weight" not in got
    for k in got:
        if k.endswith(("qweight", "weight_scale")):
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_tied_head_is_not_converted():
    _, port = model_pair(seed=5, tie_word_embeddings=True)
    assert port.lm_head is None
    assert pq.quantize_for_serving(port) == 6


# ------------------------------------------------------------ int8 KV
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_reference(dtype):
    x = np.random.RandomState(7).randn(5, 3, 64).astype(np.float32)
    x[1, 2] = 0.0                                    # absmax clamp
    rq, rs = ref_pa.quantize_kv(jnp.asarray(x).astype(dtype))
    got_q, got_s = pa.quantize_kv(torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(rs))


def _int8_cache(num_pages, KVH, page, D, seed):
    rng = np.random.RandomState(seed)
    kq, ks = pa.quantize_kv(torch.from_numpy(
        rng.randn(num_pages, KVH, page, D).astype(np.float32)))
    vq, vs = pa.quantize_kv(torch.from_numpy(
        rng.randn(num_pages, KVH, page, D).astype(np.float32)))
    return [t.numpy() for t in (kq, vq, ks, vs)]


def test_int8_cache_write_matches_reference_and_drops_pad_rows():
    """Values quantized on write and scales at the same (page, head,
    slot); the pad row (write_pos -1) changes nothing, scales included."""
    rng = np.random.RandomState(8)
    kc, vc, ks, vs = _int8_cache(9, 2, 8, 64, 8)
    bt = np.array([[3, 5, 0], [0, 0, 0], [7, 2, 8]], np.int32)
    pos = np.array([12, -1, 17], np.int32)
    kn = rng.randn(3, 2, 64).astype(np.float32)
    vn = rng.randn(3, 2, 64).astype(np.float32)
    want = ref_pa.paged_cache_write(
        *(jnp.asarray(a) for a in (kc, vc, kn, vn, bt, pos)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    out = pa.paged_cache_write(got[0], got[1], torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(bt),
                               torch.from_numpy(pos), k_scale=got[2],
                               v_scale=got[3])
    assert len(out) == 4 and all(o is g for o, g in zip(out, got))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    changed = {(p, s) for p, h, s in np.argwhere(got[2].numpy() != ks)}
    assert changed == {(5, 4), (8, 1)}


@pytest.mark.parametrize("start,length", [(0, 9), (13, 3)])
def test_int8_cache_write_range_matches_reference(start, length):
    """Live positions land bitwise, values and scales; dead positions go
    to the pad page 0, whose contents are arbitrary under duplicate
    writes and never read unmasked, so page 0 is left out."""
    rng = np.random.RandomState(start)
    kc, vc, ks, vs = _int8_cache(10, 2, 8, 64, start + 1)
    kn = rng.randn(16, 2, 64).astype(np.float32)
    vn = rng.randn(16, 2, 64).astype(np.float32)
    bt = np.array([6, 2, 9, 0], np.int32)
    want = ref_pa.paged_cache_write_range(
        *(jnp.asarray(a) for a in (kc, vc, kn, vn, bt)), jnp.int32(length),
        jnp.int32(start), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    pa.paged_cache_write_range(got[0], got[1], torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(bt),
                               length, start, k_scale=got[2], v_scale=got[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


@pytest.mark.parametrize("G", [1, 4])
def test_int8_decode_matches_reference_kernel(G):
    """Mid-page lengths, a full table and a seq_len-0 pad row, on int8
    pages in shuffled order."""
    B, KVH, D, page, max_pages = 4, 2, 128, 16, 4
    seq_lens = np.array([5, 37, 0, 64], np.int32)
    rng = np.random.RandomState(G)
    num_pages = B * max_pages + 3
    kc, vc, ks, vs = _int8_cache(num_pages, KVH, page, D, G + 10)
    q = rng.randn(B, KVH * G, D).astype(np.float32)
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((B, max_pages), np.int32)
    bt[seq_lens > 0] = perm[:12].reshape(3, 4)
    args = (q, kc, vc, bt, seq_lens)
    want = np.asarray(ref_pa.paged_attention_decode(
        *(jnp.asarray(a) for a in args), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    before = (pa.paged_attention_decode.launches,
              pa.paged_attention_decode.int8_launches)
    got = pa.paged_attention_decode(*(torch.from_numpy(a) for a in args),
                                    k_scale=torch.from_numpy(ks),
                                    v_scale=torch.from_numpy(vs))
    assert (pa.paged_attention_decode.launches,
            pa.paged_attention_decode.int8_launches) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.all(got.numpy()[2] == 0.0)


def test_int8_mismatches_raise_like_the_reference():
    kc, vc, ks, vs = (torch.from_numpy(a)
                      for a in _int8_cache(3, 1, 8, 64, 0))
    q = torch.zeros(1, 1, 64)
    bt = torch.tensor([[1]], dtype=torch.int32)
    sl = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention_decode(q, kc, vc, bt, sl, k_scale=ks)
    with pytest.raises(ValueError, match="needs"):
        pa.paged_attention_decode(q, kc, vc, bt, sl)
    with pytest.raises(ValueError, match="not int8"):
        pa.paged_attention_decode(q, kc.float(), vc.float(), bt, sl,
                                  k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="scale buffers"):
        pa.paged_cache_write(kc, vc, q, q, bt, sl - 1)
    with pytest.raises(ValueError, match="not int8"):
        pa.paged_cache_write_range(kc.float(), vc.float(), q[0], q[0],
                                   bt[0], 1, k_scale=ks, v_scale=vs)


def test_int8_page_bytes_and_alloc_match_reference():
    for args in ((8, 16, 128), (1, 8, 64)):
        assert pa.paged_page_bytes(*args, "int8") == \
            ref_pa.paged_page_bytes(*args, "int8")
    assert pa.paged_page_bytes(8, 16, 128, "int8") == 33792
    pa.check_supported_paged((2, 4, 64), (8, 2, 16, 64), torch.float32,
                             kv_dtype="int8")
    with pytest.raises(ValueError):
        pa.check_supported_paged((2, 4, 64), (8, 2, 16, 64), torch.float32,
                                 kv_dtype="int4")
    out = pa.alloc_paged_cache(2, 5, 8, 64, device="cpu", kv_dtype="int8")
    want = ref_pa.alloc_paged_cache(2, 5, 8, 64, kv_dtype="int8")
    for o, w in zip(out, want):
        assert tuple(o.shape) == w.shape and str(o.dtype)[6:] == \
            str(w.dtype) and not o.any()


def test_quant_matmul_ctypes_signatures_match_the_cuda_source():
    """Both C entries' ctypes argtypes mirror the prototypes: a mismatch
    would pass garbage to the kernel, and only the card could show it."""
    src = (build.CSRC / qm.KERNEL_SOURCE).read_text()
    expect = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    for fn, argtypes in (("quant_matmul", qm.C_ARGTYPES),
                         ("quant_matmul_splits", qm.C_SPLITS_ARGTYPES)):
        proto = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                          re.S).group(1)
        kinds = [expect[p.strip().replace("const ", "").rsplit(" ", 1)[0]
                        .replace(" ", "")] for p in proto.split(",")]
        assert kinds == argtypes, fn
    assert build.library_path(qm.KERNEL_SOURCE).name.startswith(
        "quant_matmul-")
