"""The wgmma kernels' segment and flashmask modes (the forward of
csrc/flash_fwd_sm90.cu, dQ and dK/dV of csrc/flash_bwd_sm90.cu) on the
CPU: which kernel each flash entry takes (`flash_route`), the blocks'
walk of their ring tiles (`masked_walk`, the C rule of
csrc/flash_walk.cuh in Python) against the reference's
`_block_contributes` over 64 x 64 tiles, the whole-pair shortcut against
the dense mask, the start summary the shortcut reads, the C prototypes
against their ctypes argtypes, and that CPU tensors still take the plain
versions bitwise.
The kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against the plain versions there. No interpret-mode kernel
runs here; the reference's predicate is evaluated eagerly on small
blocks.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as ref_fa
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import flash_attention as fa

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,D,mode", [
    (BF16, 128, "plain"), (BF16, 64, "varlen"), (BF16, 128, "varlen"),
    (BF16, 8, "flashmask"), (BF16, 128, "flashmask"), (BF16, 136, "varlen"),
    (BF16, 256, "flashmask"), (FP32, 64, "varlen"), (FP32, 128, "flashmask"),
    (torch.float16, 64, "varlen")])
def test_flash_route_per_kernel(dtype, D, mode, kernel):
    """bf16 at head_dim <= 128 takes the wgmma kernels for the forward, dQ
    and dK/dV in every mode; fp32, head_dim > 128 and other types take
    flash_attention.cu."""
    sm90 = dtype == BF16 and D <= 128
    assert fa.flash_route(dtype, D, mode, kernel) == ("sm90" if sm90
                                                      else "mma")


def test_flash_route_names_its_kernel():
    with pytest.raises(ValueError, match="kernel"):
        fa.flash_route(BF16, 64, "varlen", "bwd")


# ------------------------------------------------------------ the cases
def _seg_rows(B, lens_q, lens_k, causal):
    """(segq, segk) (B, 2, S) int32 [id; position], the query positions
    shifted by each sequence's k_len - q_len; zeros without causal."""
    def rows(lens, shift):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
        pos = np.concatenate([np.arange(n) + d for n, d in zip(lens, shift)])
        return np.stack([ids, pos * causal])
    shift = [b - a for a, b in zip(lens_q, lens_k)]
    return tuple(torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        rows(ls, sh), (B, 2, sum(ls))), dtype=np.int32))
        for ls, sh in ((lens_q, shift), (lens_k, [0] * len(lens_k))))


def _bounds(kind, B, Hm, S):
    """(B*Hm, C, S) int32 flashmask bounds and fm_causal: a document mask
    (C 1), the sliding window (C 1), a causal band (C 2), non-causal C 2
    and C 4, each head's width its own."""
    col = np.arange(S)
    w = (24 + 16 * (np.arange(B * Hm) % Hm))[:, None, None]
    if kind == "doc":
        lens = [70, 5, 90, S - 165]
        ends = np.repeat(np.cumsum(lens), lens)
        b, causal = [ends + 0 * w], True
    elif kind == "window":
        b, causal = [np.minimum(col + 130, S) + 0 * w], True
    elif kind == "band":
        b, causal = [np.minimum(col + w, S), np.full((B * Hm, 1, S), S)], True
    elif kind == "nc2":
        b, causal = [np.minimum(col + w, S), np.maximum(col - w, 0)], False
    else:
        b, causal = [np.minimum(col + w // 2, S), np.minimum(col + w, S),
                     np.zeros((B * Hm, 1, S), int),
                     np.maximum(col - w, 0)], False
    b = [np.broadcast_to(x, (B * Hm, 1, S)) for x in b]
    return torch.from_numpy(np.concatenate(b, 1).astype(np.int32)), causal


# name: (B, H, masks kw, Sq, Sk, causal). Varlen with non-uniform q/k
# lengths (Sq 100, Sk 148), non-causal, documents shorter than a tile so
# one 128-row block straddles several, long documents whose inner pairs
# are whole; flashmask causal C 1 (documents, the window) and C 2,
# non-causal C 2 and C 4, per-head bounds (Hm = H).
CASES = {
    "varlen_ragged": (1, 2, dict(seg=_seg_rows(1, [40, 9, 51], [60, 25, 63],
                                               True)), 100, 148, True),
    "varlen_nc": (2, 2, dict(seg=_seg_rows(2, [70, 64, 66], [70, 64, 66],
                                           False)), 200, 200, False),
    "varlen_straddle": (1, 2, dict(seg=_seg_rows(1, [40, 30, 100, 130],
                                                 [40, 30, 100, 130], True)),
                        300, 300, True),
    "varlen_long": (1, 1, dict(seg=_seg_rows(1, [200, 20, 236],
                                             [200, 20, 236], True)),
                    456, 456, True),
    "fm_doc": (2, 2, None, 400, 400, "doc"),
    "fm_window": (1, 2, None, 320, 320, "window"),
    "fm_band": (1, 2, None, 136, 136, "band"),
    "fm_nc2": (1, 2, None, 136, 136, "nc2"),
    "fm_nc4": (1, 3, None, 160, 160, "nc4"),
    "fm_heads": (2, 3, None, 130, 130, "heads"),
}


def _case(name):
    """(B, H, masks kw of the port's entries, Sq, Sk, causal)."""
    B, H, kw, Sq, Sk, causal = CASES[name]
    if kw is None:
        kind = "band" if causal == "heads" else causal
        fm, causal = _bounds(kind, B, H if name == "fm_heads" else 1, Sk)
        kw = dict(fm=fm, fm_causal=causal)
    return B, H, kw, Sq, Sk, causal


def _reference_pairs(B, H, kw, Sq, Sk, causal):
    """{bh: {(q tile, k tile)}} the reference's `_block_contributes` lets
    through at 64-row tiles cut at the sequence ends."""
    seg, fm = kw.get("seg"), kw.get("fm")
    rows = {}
    for n in range(B if seg is not None else fm.shape[0]):
        ok = set()
        for qi in range(-(-Sq // 64)):
            for ki in range(-(-Sk // 64)):
                qs, ks = slice(64 * qi, 64 * qi + 64), slice(64 * ki,
                                                            64 * ki + 64)
                blk = (dict(segq_blk=seg[0][n, 0, qs].numpy(),
                            posq_blk=seg[0][n, 1, qs].numpy(),
                            segk_blk=seg[1][n, 0, ks].numpy(),
                            posk_blk=seg[1][n, 1, ks].numpy())
                       if seg is not None else
                       dict(segq_blk=None, segk_blk=None,
                            fm_blk=fm[n, :, ks].numpy(),
                            fm_causal=kw["fm_causal"], fm_cols=fm.shape[1]))
                if bool(ref_fa._block_contributes(
                        qi, ki, block_q=64, block_k=64, q_offset=Sk - Sq,
                        causal=causal, **blk)):
                    ok.add((qi, ki))
        rows[n] = ok
    per = H if seg is not None or fm.shape[0] == B else 1
    return {bh: rows[bh // per] for bh in range(B * H)}


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("name", list(CASES))
def test_walk_computes_the_reference_pairs(name, kernel):
    """The pairs the warpgroups compute are the reference's
    `_block_contributes` pairs over 64 x 64 tiles, each exactly once; the
    ring carries only tiles a warpgroup computes, in ascending order; the
    count is `flash_visits_ref`'s (the kernels' `visits`)."""
    B, H, kw, Sq, Sk, causal = _case(name)
    BH = B * H
    walk = fa.masked_walk(kernel, BH, Sq, Sk, causal, H=H, **kw)
    want = _reference_pairs(B, H, kw, Sq, Sk, causal)
    queries = kernel != "dkv"       # the forward's blocks fix queries too
    fixed = -(-(Sq if queries else Sk) // 128)
    assert sorted(walk) == [(bh, 128 * i) for bh in range(BH)
                            for i in range(fixed)]
    got = {bh: [] for bh in range(BH)}
    for (bh, f0), tiles in walk.items():
        ts = [t for t, _, _ in tiles]
        assert ts == sorted(set(ts))                       # ascending, once
        for t, computes, _ in tiles:
            assert any(computes)
            for wg, c in enumerate(computes):
                if c:
                    r = (f0 + 64 * wg) // 64
                    got[bh].append((r, t) if queries else (t, r))
    for bh in range(BH):
        assert len(got[bh]) == len(set(got[bh]))
        assert set(got[bh]) == want[bh], bh
    assert sum(map(len, got.values())) == fa.flash_visits_ref(
        BH, Sq, Sk, causal, H=H, tile=64, **kw)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("name", list(CASES))
def test_whole_pairs_have_no_masked_score(name, kernel):
    """A pair the walk marks whole (the kernels skip its per-element mask)
    lies inside both sequences and has every score visible under the
    dense mask of the plain versions; the long documents and the C == 1
    causal bounds give some."""
    B, H, kw, Sq, Sk, causal = _case(name)
    BH = B * H
    _, keep = fa._apply_masks(torch.zeros(BH, Sq, Sk), causal, H=H, **kw)
    keep = keep.expand(BH, Sq, Sk)
    whole = 0
    for (bh, f0), tiles in fa.masked_walk(kernel, BH, Sq, Sk, causal,
                                          H=H, **kw).items():
        for t, computes, wholes in tiles:
            for wg in range(2):
                if not wholes[wg]:
                    continue
                assert computes[wg]
                r = f0 + 64 * wg
                q0, k0 = (r, 64 * t) if kernel != "dkv" else (64 * t, r)
                assert q0 + 64 <= Sq and k0 + 64 <= Sk
                assert bool(keep[bh, q0:q0 + 64, k0:k0 + 64].all())
                whole += 1
    if name in ("varlen_long", "fm_doc", "fm_window"):
        assert whole > 0


def test_start_summary_keeps_the_largest_and_smallest_start():
    """`tile_summary`'s flashmask start summary (C == 1 causal bounds):
    (N, 2, ceil(Sk/32)), each 32-column group's largest start (the skip
    predicate) and smallest (the whole-pair test), the last group over
    its in-range columns only; other bounds take no summary."""
    rng = np.random.RandomState(0)
    fm = torch.from_numpy(rng.randint(0, 200, (3, 1, 100)).astype(np.int32))
    summ = fa.tile_summary(fm=fm, fm_causal=True)[2]
    assert summ.dtype == torch.int32 and summ.shape == (3, 2, 4)
    for g in range(4):
        cols = fm[:, 0, 32 * g:32 * g + 32]
        assert torch.equal(summ[:, 0, g], cols.amax(-1))
        assert torch.equal(summ[:, 1, g], cols.amin(-1))
    assert fa.tile_summary(fm=fm.repeat(1, 2, 1), fm_causal=True) == (
        None, None, None)


@pytest.mark.parametrize("name,D", [("varlen_ragged", 64),
                                    ("varlen_straddle", 128),
                                    ("fm_doc", 64), ("fm_nc4", 128)])
def test_cpu_masked_backward_takes_the_plain_versions_bitwise(name, D):
    """Masked shapes the card sends to the wgmma dQ and dK/dV (bf16,
    head_dim <= 128) run flash_dq_ref / flash_dkv_ref on CPU tensors,
    bitwise, and count no launch."""
    B, H, kw, Sq, Sk, causal = _case(name)
    rng = np.random.RandomState(Sq + D)
    q, do = (torch.from_numpy(rng.randn(B * H, Sq, D).astype(np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B * H, Sk, D).astype(np.float32))
            .bfloat16() for _ in range(2))
    for kernel in ("dq", "dkv"):
        assert fa.flash_route(BF16, D, "varlen" if "seg" in kw
                              else "flashmask", kernel) == "sm90"
    names = ("launches", "sm90_launches", "varlen_launches",
             "flashmask_launches")
    counts = [[getattr(f, n) for n in names]
              for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)]
    out, lse = fa.flash_fwd(q, k, v, 0.125, causal, H=H, **kw)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), 0.125, causal)
    assert torch.equal(fa.flash_dq(*args, H=H, **kw),
                       fa.flash_dq_ref(*args, H=H, **kw))
    for got, want in zip(fa.flash_dkv(*args, H=H, **kw),
                         fa.flash_dkv_ref(*args, H=H, **kw)):
        assert got.dtype == BF16 and torch.equal(got, want)
    assert counts == [[getattr(f, n) for n in names]
                      for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)]


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_masked_forward_takes_the_plain_version_bitwise(name):
    """Masked shapes the card sends to the wgmma forward (bf16, head_dim
    <= 128) run flash_fwd_ref on CPU tensors, bitwise (out and lse), and
    count no launch."""
    B, H, kw, Sq, Sk, causal = _case(name)
    rng = np.random.RandomState(Sq + Sk)
    q = torch.from_numpy(rng.randn(B * H, Sq, 64).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B * H, Sk, 64).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    assert fa.flash_route(BF16, 64, "varlen" if "seg" in kw
                          else "flashmask", "fwd") == "sm90"
    names = ("launches", "sm90_launches", "varlen_launches",
             "flashmask_launches")
    count = [getattr(fa.flash_fwd, n) for n in names]
    got = fa.flash_fwd(q, k, v, 0.125, causal, H=H, **kw)
    want = fa.flash_fwd_ref(q, k, v, 0.125, causal, H=H, **kw)
    assert got[0].dtype == BF16 and got[1].dtype == FP32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert count == [getattr(fa.flash_fwd, n) for n in names]


def _c_kinds(source, name):
    """The ctypes kinds of `name`'s prototype in csrc/`source`."""
    expect = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
              "float": ctypes.c_float}
    src = (build.CSRC / source).read_text()
    proto = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                      re.S).group(1)
    return [expect[p.strip().replace("const ", "").rsplit(" ", 1)[0]
                   .replace(" ", "")] for p in proto.split(",")]


@pytest.mark.parametrize("name", ["flash_attention_fwd_sm90_masked",
                                  "flash_attention_dq_sm90_masked",
                                  "flash_attention_dkv_sm90_masked"])
def test_masked_sm90_ctypes_signatures_match_the_cuda_source(name):
    """The masked wgmma entries' argtypes mirror their prototypes: the
    tensors, then flash_attention.cu's masked tail less its dtype."""
    source, types = fa.SM90_C_ARGTYPES[name]
    assert source == (fa.SM90_SOURCE if "_fwd_" in name
                      else fa.SM90_BWD_SOURCE)
    assert _c_kinds(source, name) == types
    mma = fa.C_ARGTYPES[name.replace("_sm90_masked", "")]
    assert types == mma[:-2] + mma[-1:]


def test_both_flash_sources_include_the_mask_header(tmp_path, monkeypatch):
    """The three flash sources include csrc/flash_mask.cuh: a change to it
    rebuilds each. The two wgmma sources (the forward, dQ and dK/dV) also
    include the walk, csrc/flash_walk.cuh: a change to it rebuilds both
    and not flash_attention.cu."""
    import shutil
    sources = (fa.KERNEL_SOURCE, fa.SM90_BWD_SOURCE, fa.SM90_SOURCE)
    for f in ("flash_mask.cuh", "flash_walk.cuh", "hopper.cuh") + sources:
        shutil.copy(build.CSRC / f, tmp_path / f)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for header, rebuilt in (("flash_mask.cuh", set(sources)),
                            ("flash_walk.cuh", {fa.SM90_BWD_SOURCE,
                                                fa.SM90_SOURCE})):
        before = {f: build.library_path(f) for f in sources}
        with open(tmp_path / header, "a") as fh:
            fh.write("// changed\n")
        after = {f: build.library_path(f) for f in sources}
        assert {f for f in sources if after[f] != before[f]} == rebuilt


@pytest.mark.parametrize("S", [128, 130, 131, 129])
def test_tma_rows_pad_to_a_multiple_of_4(S):
    """The rows the wgmma backward reads in 16-byte-aligned TMA boxes (dK/
    dV's lse and delta, the masked modes' segment rows and bounds) reach
    the kernels padded to a multiple of 4 elements, their values kept:
    rows of S already a multiple of 4 pass as they are."""
    x = torch.arange(2 * 3 * S, dtype=torch.int32).view(2, 3, S)
    got = fa._tma_rows(x)
    assert got.shape == (2, 3, -(-S // 4) * 4) and got.is_contiguous()
    assert torch.equal(got[..., :S], x)
    assert (got is x) == (S % 4 == 0)
    assert fa._tma_rows(None) is None
    lse = torch.randn(5, S)
    assert torch.equal(fa._tma_rows(lse)[:, :S], lse)
