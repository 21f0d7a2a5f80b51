"""The port's choice of kernel for the int8 matmul and the flash kernels,
on the CPU: which (M, K, N, dtype, alignment) take the wgmma prefill
kernel (csrc/quant_matmul_sm90.cu) and with which tile rows and K
splits, which (dtype, head_dim, mode) take the wgmma forward
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
    (16, 4096, 14336, BF16, True, "decode"),    # the decode batch bucket
    (1, 4096, 128256, BF16, True, "decode"),    # the LM head at prefill
    (3, 37, 16, FP32, True, "decode"),
    (17, 4096, 1024, BF16, True, "sm90"),
    (512, 14336, 4096, BF16, True, "sm90"),
    (200, 4096, 1040, BF16, True, "sm90"),      # N % 128 != 0 is fine
    (512, 4096, 14336, FP32, True, "fp32"),
    (17, 96, 130, BF16, True, "mma"),           # N not a multiple of 16
    (40, 100, 64, BF16, True, "mma"),           # K not a multiple of 8
    (33, 256, 128, BF16, False, "mma"),         # unaligned base
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


@pytest.mark.parametrize("dtype,D,mode,route", [
    (BF16, 128, "plain", "sm90"), (BF16, 64, "plain", "sm90"),
    (BF16, 40, "plain", "sm90"), (BF16, 136, "plain", "mma"),
    (BF16, 256, "plain", "mma"), (FP32, 128, "plain", "mma"),
    (BF16, 128, "masked", "mma"), (FP32, 64, "plain", "mma"),
    (FP32, 256, "plain", "mma"), (BF16, 64, "varlen", "mma"),
    (BF16, 128, "varlen", "mma"), (BF16, 256, "varlen", "mma"),
    (BF16, 64, "flashmask", "mma"), (BF16, 128, "flashmask", "mma"),
    (BF16, 256, "flashmask", "mma"), (FP32, 128, "varlen", "mma"),
    (FP32, 128, "flashmask", "mma"), (BF16, 8, "plain", "sm90"),
    (BF16, 120, "plain", "sm90"), (BF16, 129, "plain", "mma"),
    (torch.float16, 64, "plain", "mma"),
])
def test_flash_fwd_route(dtype, D, mode, route):
    """The forward, dQ and dK/dV take the wgmma kernels on one rule: bf16,
    plain mode (causal or none), head_dim <= 128."""
    assert fa.flash_route(dtype, D, mode) == route


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
    """Shapes the card sends to the wgmma kernels run the plain versions
    on CPU tensors, bitwise, and count no launch."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(64, 256).astype(np.float32)).bfloat16()
    qw = torch.from_numpy(rng.randint(-127, 128, (256, 128)).astype(np.int8))
    s = torch.from_numpy(rng.rand(128).astype(np.float32) * 0.01)
    q, k, v = (torch.from_numpy(rng.randn(2, 80, 64).astype(np.float32))
               .bfloat16() for _ in range(3))
    counts = (qm.quant_matmul.launches, qm.quant_matmul.prefill_launches,
              fa.flash_fwd.launches, fa.flash_fwd.sm90_launches)
    assert qm.quant_matmul_route(64, 256, 128, BF16) == "sm90"
    assert torch.equal(qm.quant_matmul(x, qw, s),
                       qm.quant_matmul_ref(x, qw, s))
    assert fa.flash_route(q.dtype, 64) == "sm90"
    for got, want in zip(fa.flash_fwd(q, k, v, 0.125, True),
                         fa.flash_fwd_ref(q, k, v, 0.125, True)):
        assert torch.equal(got, want)
    assert counts == (qm.quant_matmul.launches,
                      qm.quant_matmul.prefill_launches,
                      fa.flash_fwd.launches, fa.flash_fwd.sm90_launches)


def test_sm90_ctypes_signatures_match_the_cuda_sources():
    """The new C entries' ctypes argtypes mirror their prototypes: a
    mismatch would pass garbage to a kernel, and only the card could
    show it."""
    for source, name, types in (
            (qm.SM90_SOURCE, "quant_matmul_sm90", qm.SM90_C_ARGTYPES),
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
    for f in ("hopper.cuh", qm.SM90_SOURCE, qm.KERNEL_SOURCE):
        shutil.copy(build.CSRC / f, tmp_path / f)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {f: build.library_path(f)
              for f in (qm.SM90_SOURCE, qm.KERNEL_SOURCE)}
    with open(tmp_path / "hopper.cuh", "a") as fh:
        fh.write("// changed\n")
    assert build.library_path(qm.SM90_SOURCE) != before[qm.SM90_SOURCE]
    assert build.library_path(qm.KERNEL_SOURCE) == before[qm.KERNEL_SOURCE]
