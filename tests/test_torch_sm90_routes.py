"""The port's choice of kernel for the int8 matmul and the flash kernels,
on the CPU: which (M, K, N, dtype, alignment) take the decode weight
stream (csrc/quant_decode_sm90.cu) and how it splits the work over the
CTAs, which take the wgmma prefill kernel (csrc/quant_matmul_sm90.cu)
and with which tile rows and K splits, which (dtype, head_dim, mode)
take the wgmma forward
(csrc/flash_fwd_sm90.cu) and the wgmma dQ and dK/dV
(csrc/flash_bwd_sm90.cu), and that CPU tensors still run the plain
versions bitwise. The kernels themselves run only on the card:
tests/test_torch_cuda.py holds them against the plain versions there.
"""
import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import quant_matmul as qm

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,K,N,dtype,aligned,route", [
    # the decode batch bucket and the LM head at prefill (their ids name
    # the decode rows they test)
    pytest.param(16, 4096, 14336, BF16, True, "decode_sm90",
                 id="16-4096-14336-dtype0-True-decode"),
    pytest.param(1, 4096, 128256, BF16, True, "decode_sm90",
                 id="1-4096-128256-dtype1-True-decode"),
    (3, 37, 16, FP32, True, "decode"),
    (17, 4096, 1024, BF16, True, "sm90"),
    (512, 14336, 4096, BF16, True, "sm90"),
    (200, 4096, 1040, BF16, True, "sm90"),      # N % 128 != 0 is fine
    (512, 4096, 14336, FP32, True, "fp32"),
    (17, 96, 130, BF16, True, "mma"),           # N not a multiple of 16
    (40, 100, 64, BF16, True, "mma"),           # K not a multiple of 8
    (33, 256, 128, BF16, False, "mma"),         # unaligned base
    (13, 1000, 4112, BF16, True, "decode_sm90"),   # ragged K and N
    (16, 4096, 14336, FP32, True, "decode"),    # fp32 x keeps its kernel
    (5, 200, 72, BF16, True, "decode"),         # N not a multiple of 16
    (7, 100, 64, BF16, True, "decode"),         # K not a multiple of 8
    (16, 256, 128, BF16, False, "decode"),      # unaligned base
])
def test_quant_matmul_route(M, K, N, dtype, aligned, route):
    assert qm.quant_matmul_route(M, K, N, dtype, aligned) == route


@pytest.mark.parametrize("M,K,N,plan", [
    (512, 4096, 14336, (256, 1)),   # gate/up: 224 tiles of 256 rows
    (256, 4096, 14336, (256, 1)),
    (32, 4096, 14336, (64, 1)),
    (512, 14336, 4096, (128, 1)),   # down: 256 rows would give 64 tiles
    (256, 14336, 4096, (64, 1)),
    (128, 14336, 4096, (64, 2)),    # 64 tiles: K split in two
    (64, 14336, 4096, (64, 4)),
    (200, 4096, 1040, (64, 3)),
    (72, 1000, 4112, (64, 2)),
])
def test_quant_prefill_plan_at_132_sms(M, K, N, plan):
    assert qm.quant_prefill_plan(M, K, N, 132) == plan


def test_quant_prefill_plan_never_leaves_a_split_empty():
    """Over seeded shapes: bm is 64, 128 or 256 and no larger than M
    needs; each split holds at least one 64-deep K tile (the C entry
    refuses an empty one), and splits only where 64-row tiles leave
    fewer than 3/4 of the SMs busy."""
    rng = np.random.RandomState(0)
    for _ in range(300):
        M, K, N = (int(rng.randint(17, 3000)), 8 * int(rng.randint(1, 3000)),
                   16 * int(rng.randint(1, 1500)))
        sms = int(rng.choice([78, 114, 132]))
        bm, splits = qm.quant_prefill_plan(M, K, N, sms)
        assert bm in (64, 128, 256) and (bm == 64 or bm < 2 * M)
        kt = -(-K // 64)
        per = -(-kt // splits)
        assert per * (splits - 1) < kt
        tiles = -(-N // 128) * -(-M // bm)
        assert splits == 1 or 4 * tiles < 3 * sms


# Llama-3-8B's serve_quant shapes at the decode bucket, the head's M 1
# row, and ragged ones (K not a multiple of the 64-row unit, N not of the
# 256-column tile, fewer units than SMs, one unit)
DECODE_SPLIT_CASES = [(16, 4096, 14336, 132), (16, 14336, 4096, 132),
                      (16, 4096, 128256, 132), (1, 4096, 128256, 132),
                      (13, 1000, 4112, 132), (5, 200, 80, 132),
                      (7, 136, 16, 132), (1, 8, 16, 132),
                      (9, 4096, 14336, 114), (16, 14336, 4096, 78)]


@pytest.mark.parametrize("M,K,N,sms", DECODE_SPLIT_CASES, ids=str)
def test_quant_decode_split_covers_every_unit_once(M, K, N, sms):
    """The decode kernel's split (`quant_decode_split`, the C rule in
    Python) over the CTAs `quant_decode_plan` gives: every (column tile,
    K unit) pair is covered exactly once; shares differ by at most one
    unit and none is empty; a tile one CTA covers alone is flushed by it
    (no slot), a shared one writes partials to slot 0 (the CTA's first
    tile) or 1 (its last) and is merged over its parts in K order."""
    ctas = qm.quant_decode_plan(M, K, N, sms)
    tiles, kt = -(-N // qm.DECODE_BN), -(-K // qm.DECODE_BK)
    assert ctas == min(sms, tiles * kt)
    runs, merges = qm.quant_decode_split(K, N, ctas)
    assert len(runs) == ctas
    cover = np.zeros((tiles, kt), np.int64)
    shares = []
    parts = {}
    for i, segs in enumerate(runs):
        assert segs, f"CTA {i} is empty"
        shares.append(sum(b - a for _, a, b, _ in segs))
        for n, (tile, a, b, slot) in enumerate(segs):
            assert 0 <= a < b <= kt
            cover[tile, a:b] += 1
            if slot is None:
                assert (a, b) == (0, kt)
            else:
                assert slot == (0 if n == 0 else 1)
                assert n in (0, len(segs) - 1)
                parts.setdefault(tile, []).append((a, i, slot))
        # a run is contiguous: its segments follow each other in unit order
        flat = [tile * kt + k for tile, a, b, _ in segs for k in range(a, b)]
        assert flat == list(range(flat[0], flat[0] + len(flat)))
    assert (cover == 1).all()
    assert max(shares) - min(shares) <= 1
    assert sum(shares) == tiles * kt
    # the merge adds a shared tile's parts in K order, each from the slot
    # its CTA wrote
    assert merges == {tile: [(i, slot) for _, i, slot in sorted(p)]
                      for tile, p in parts.items()}
    for tile, order in merges.items():
        assert len(order) >= 2 and [i for i, _ in order] == list(
            range(order[0][0], order[-1][0] + 1))


def test_quant_decode_split_at_the_serve_quant_shapes():
    """At 132 SMs: gate/up's 56 tiles of 64 units over 132 CTAs (27 or 28
    units each) are each merged from 3 or 4 CTAs' partials; down's 16
    tiles of 224 units from 8 to 10; 130 of the head's 501 tiles of 64
    units from 2, the others flushed by the one CTA that covers them."""
    for (K, N), (n_shared, fewest, most) in (((4096, 14336), (56, 3, 4)),
                                             ((14336, 4096), (16, 8, 10)),
                                             ((4096, 128256), (130, 2, 2))):
        ctas = qm.quant_decode_plan(16, K, N, 132)
        runs, merges = qm.quant_decode_split(K, N, ctas)
        assert ctas == 132 and len(merges) == n_shared
        sizes = [len(p) for p in merges.values()]
        assert (min(sizes), max(sizes)) == (fewest, most)


@pytest.mark.parametrize("dtype,D,mode,route", [
    (BF16, 128, "plain", "sm90"), (BF16, 64, "plain", "sm90"),
    (BF16, 40, "plain", "sm90"), (BF16, 136, "plain", "mma"),
    (BF16, 256, "plain", "mma"), (FP32, 128, "plain", "mma"),
    (BF16, 128, "masked", "sm90"), (FP32, 64, "plain", "mma"),
    (FP32, 256, "plain", "mma"), (BF16, 64, "varlen", "sm90"),
    (BF16, 128, "varlen", "sm90"), (BF16, 256, "varlen", "mma"),
    (BF16, 64, "flashmask", "sm90"), (BF16, 128, "flashmask", "sm90"),
    (BF16, 256, "flashmask", "mma"), (FP32, 128, "varlen", "mma"),
    (FP32, 128, "flashmask", "mma"), (BF16, 8, "plain", "sm90"),
    (BF16, 120, "plain", "sm90"), (BF16, 129, "plain", "mma"),
    (torch.float16, 64, "plain", "mma"),
])
def test_flash_fwd_route(dtype, D, mode, route):
    """The forward, dQ and dK/dV take the wgmma kernels for bf16 at
    head_dim <= 128 in every mode (plain, causal or none; the segment and
    flashmask modes): `route` for all three."""
    assert fa.flash_route(dtype, D, mode) == route
    for kernel in ("fwd", "dq", "dkv"):
        assert fa.flash_route(dtype, D, mode, kernel) == route


@pytest.mark.parametrize("BH,Sq,Sk,D,causal", [
    (2, 72, 136, 64, True), (1, 130, 64, 128, True), (2, 80, 80, 40, False)])
def test_cpu_tensors_take_the_plain_backward_bitwise(BH, Sq, Sk, D, causal):
    """Shapes the card sends to the wgmma dQ and dK/dV (bf16, plain mode,
    head_dim <= 128, ragged lengths, causal or not) run flash_dq_ref /
    flash_dkv_ref on CPU tensors, bitwise, and count no launch."""
    rng = np.random.RandomState(BH + Sq + Sk + D)
    counters = (fa.flash_dq, fa.flash_dkv)
    counts = [(f.launches, f.sm90_launches) for f in counters]
    assert fa.flash_route(BF16, D) == "sm90"
    q, do = (torch.from_numpy(rng.randn(BH, Sq, D).astype(np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(BH, Sk, D).astype(np.float32))
            .bfloat16() for _ in range(2))
    out, lse = fa.flash_fwd(q, k, v, 0.125, causal)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), 0.125, causal)
    assert torch.equal(fa.flash_dq(*args), fa.flash_dq_ref(*args))
    for got, want in zip(fa.flash_dkv(*args), fa.flash_dkv_ref(*args)):
        assert got.dtype == BF16 and torch.equal(got, want)
    assert counts == [(f.launches, f.sm90_launches) for f in counters]


def _c_kinds(source, name):
    """The ctypes kinds of `name`'s prototype in csrc/`source`."""
    expect = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
              "float": ctypes.c_float}
    src = (build.CSRC / source).read_text()
    proto = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                      re.S).group(1)
    assert '#include "hopper.cuh"' in src
    return [expect[p.strip().replace("const ", "").rsplit(" ", 1)[0]
                   .replace(" ", "")] for p in proto.split(",")]


def test_cpu_tensors_take_the_plain_versions_bitwise():
    """Shapes the card sends to the Hopper kernels (the int8 matmul's
    decode stream at 16 and 1 rows, its wgmma route at 64, the wgmma
    flash forward) run the plain versions on CPU tensors, bitwise, and
    count no launch."""
    rng = np.random.RandomState(1)
    qw = torch.from_numpy(rng.randint(-127, 128, (256, 128)).astype(np.int8))
    s = torch.from_numpy(rng.rand(128).astype(np.float32) * 0.01)
    q, k, v = (torch.from_numpy(rng.randn(2, 80, 64).astype(np.float32))
               .bfloat16() for _ in range(3))
    counts = (qm.quant_matmul.launches, qm.quant_matmul.prefill_launches,
              qm.quant_matmul.decode_launches,
              fa.flash_fwd.launches, fa.flash_fwd.sm90_launches)
    for M, route in ((64, "sm90"), (16, "decode_sm90"), (1, "decode_sm90")):
        x = torch.from_numpy(rng.randn(M, 256).astype(np.float32)).bfloat16()
        assert qm.quant_matmul_route(M, 256, 128, BF16) == route
        assert torch.equal(qm.quant_matmul(x, qw, s),
                           qm.quant_matmul_ref(x, qw, s))
    assert fa.flash_route(q.dtype, 64) == "sm90"
    for got, want in zip(fa.flash_fwd(q, k, v, 0.125, True),
                         fa.flash_fwd_ref(q, k, v, 0.125, True)):
        assert torch.equal(got, want)
    assert counts == (qm.quant_matmul.launches,
                      qm.quant_matmul.prefill_launches,
                      qm.quant_matmul.decode_launches,
                      fa.flash_fwd.launches, fa.flash_fwd.sm90_launches)


def test_sm90_ctypes_signatures_match_the_cuda_sources():
    """The new C entries' ctypes argtypes mirror their prototypes: a
    mismatch would pass garbage to a kernel, and only the card could
    show it."""
    for source, name, types in (
            (qm.SM90_SOURCE, "quant_matmul_sm90", qm.SM90_C_ARGTYPES),
            (qm.DECODE_SOURCE, "quant_decode_sm90", qm.DECODE_C_ARGTYPES),
            (*fa.SM90_C_ARGTYPES["flash_attention_fwd_sm90"][:1],
             "flash_attention_fwd_sm90",
             fa.SM90_C_ARGTYPES["flash_attention_fwd_sm90"][1])):
        assert _c_kinds(source, name) == types, name


@pytest.mark.parametrize("name", ["flash_attention_dq_sm90",
                                  "flash_attention_dkv_sm90"])
def test_flash_bwd_ctypes_signatures_match_the_cuda_source(name):
    """dQ and dK/dV's argtypes mirror their prototypes in
    csrc/flash_bwd_sm90.cu: the tensors (q, k, v, dout, lse, delta, then
    dq or dk, dv), BH, Sq, Sk, D, scale, causal, stream."""
    source, types = fa.SM90_C_ARGTYPES[name]
    assert source == fa.SM90_BWD_SOURCE
    assert _c_kinds(source, name) == types
    tensors = 7 if name.endswith("dq_sm90") else 8
    assert types == [ctypes.c_void_p] * tensors + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def test_library_key_covers_the_included_header(tmp_path, monkeypatch):
    """A change to csrc/hopper.cuh rebuilds the sources that include it
    (their library names change) and no other."""
    sources = (qm.SM90_SOURCE, qm.DECODE_SOURCE, qm.KERNEL_SOURCE)
    for f in ("hopper.cuh",) + sources:
        shutil.copy(build.CSRC / f, tmp_path / f)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {f: build.library_path(f) for f in sources}
    with open(tmp_path / "hopper.cuh", "a") as fh:
        fh.write("// changed\n")
    assert build.library_path(qm.SM90_SOURCE) != before[qm.SM90_SOURCE]
    assert build.library_path(qm.DECODE_SOURCE) != before[qm.DECODE_SOURCE]
    assert build.library_path(qm.KERNEL_SOURCE) == before[qm.KERNEL_SOURCE]
