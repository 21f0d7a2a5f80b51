#!/usr/bin/env python3
"""Shows that chip_smoke.py's kernel checks catch a wrong kernel.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_fault_check.py [--seed N]

For the unmodified kernels and for each planted fault below, it copies
`paddle_tpu_torch/` and `chip_smoke.py` into a temporary directory,
edits the copy's CUDA source (the repository's own files are never
touched), and in a child process on that copy builds the kernels and
runs the checks the smoke run applies: `chip_smoke.check_flash_kernels`
for the flash kernels, `chip_smoke.check_quant_kernels` for the int8
paged-decode and int8 matmul kernels, `chip_smoke.check_lora_kernels` for
the LoRA kernel, `chip_smoke.check_packed_kernels` for the
flash kernels' segment and flashmask modes, `chip_smoke.check_norm_kernel`
for rms_norm_rows, `chip_smoke.check_paged_kernels` for the split-KV
paged-decode kernel (both variants, on seeded batches). The children build their sources together, then run
their checks at most GPU_SLOTS at a time (the plain versions at the main
path's shapes hold ~10 GB each); each is waited for.

Faults:
  * skip_tile  — the flash forwards and dQ kernels (the wgmma kernels of
    flash_fwd_sm90.cu and flash_bwd_sm90.cu, which the bf16 main path
    runs, and flash_attention.cu's) skip the second key tile of every
    query tile, the dK/dV kernels the second query tile of every key
    tile (the wgmma kernels still wait for and free it, but mask all of
    it): each affected row loses 64 (128 in the wgmma forward) of its up
    to 4096 terms;
  * no_rescale — the wgmma flash forward drops the online-softmax rescale
    of its running sum and accumulator (alpha = 1);
  * flash_sm90_other_v_stage — the wgmma flash forward's P V product
    reads V from the other slot of its 2-stage ring (the previous or the
    next key tile, in flight or stale);
  * flash_bwd_dq_other_v_stage — the wgmma dQ kernel's dP = dO V^T reads
    V from stage (s + 1) % 3 of its ring (another key tile's V);
  * flash_bwd_dkv_other_qdo_stage — the wgmma dK/dV kernel reads Q and
    dO from stage (s + 1) % 3 of its ring for all four of its products
    (another query tile's rows; lse and delta still its own);
  * bwd_no_delta — the wgmma dQ and dK/dV kernels drop delta from dS
    (dS = P dP scale): dV stays right, dQ and dK do not;
  * qmm_drop_last_k_tile — quant_matmul.cu and the wgmma int8 matmul
    skip the last K tile of every output tile (32-deep and 64-deep: K
    4096 loses 1/128 or 1/64 of its terms);
  * qmm_sm90_next_stage — the wgmma int8 matmul's consumers read stage
    (s + 1) % kStages of the ring instead of s (another K tile's x and
    weights);
  * qmm_decode_next_stage — the int8 decode stream's consumers read stage
    (s + 1) % kStages of its ring instead of s (another unit's weights
    and x slice, or a stage never filled);
  * qmm_decode_drop_last_unit — each CTA of the decode stream leaves out
    the last unit of its share (64 K rows of 256 columns), still waiting
    for and releasing its stage;
  * qmm_decode_merge_drops_last_part — the decode stream's merge of a
    column tile shared by several CTAs leaves out the last partial (the
    tile's last K rows);
  * int8_no_v_scale — the int8 paged-decode kernel ignores the V scale
    (each V row taken as its raw int8 values), on both of its paths;
  * paged_merge_drops_last_split — the paged-decode merge skips the last
    live split's partial (its accumulator and its sum): every row with
    more than one live split loses its last tokens;
  * paged_ring_other_stage — the paged-decode consumers (both paths)
    read stage (s + 1) % kStages of the ring (another stage's K, V and
    scales) while still waiting for stage s;
  * lora_drop_h_slice — the LoRA kernel's cluster reduction leaves out
    the last CTA's H slice (H 4096 over 8 CTAs loses 512 of its terms);
  * lora_row0_slot — the LoRA kernel's grouping gives every row row 0's
    slot (one group: each row through another adapter's A and B);
  * lora_drop_bucket1 — the LoRA kernel treats the rows of rank bucket 1
    as null rows (their delta dropped, y + 0.0 written);
  * lora_epilogue_unrounded — the LoRA kernel's bf16 epilogue adds the
    fp32 delta to y without rounding it to bf16 first (y + d rounded
    once, not y + bf16(d));
  * seg_global_causal — the segment mode (flash_attention.cu's three
    kernels and the wgmma forward, dQ and dK/dV) applies the global
    causal mask
    (key j <= query i + Sk - Sq) instead of the per-sequence one (pos_k <=
    pos_q): equal for self-attention over whole documents, wrong once the
    sequences' q/k lengths differ unevenly (the ragged varlen case);
  * masked_break_at_gap — flash_attention.cu's masked fwd and dQ k-loops
    stop at the first tile that does not contribute (a `break` where a
    later tile can contribute again): every document after the first
    loses its keys (the fp32 pass: the bf16 forward and dQ are the wgmma
    kernels');
  * rms_residual_after_square — rms_norm_rows takes the mean of squares of
    x before the residual is added (the residual joins only the output);
  * seg_visit_every_tile — the segment mode's skip predicate (in
    flash_mask.cuh, both flash sources) lets every tile through: the
    outputs stay right (masked scores add exact zeros), so only the count
    of visited tile pairs against the plain predicate catches it;
  * bwd_seg_drop_id — the wgmma masked dQ drops the segment-id test
    (keys of other documents at or before the query's position count);
  * bwd_dkv_drop_last_tile — each wgmma masked dK/dV block leaves out the
    last query tile of its list, still waiting for and freeing it;
  * bwd_fm_dq_other_stage — the wgmma masked dQ reads its key tile's
    mask rows (flashmask bounds, segment ids) from stage (s + 1) % 3 of
    the ring (another key tile's): the full-width document mask and every
    small flashmask case;
  * fwd_mask_rows_other_stage — the wgmma masked forward reads its key
    tile's mask rows from stage (s + 1) % 4 of its ring (another key
    tile's, or one not yet filled): the full-width document mask and
    every small flashmask case;
  * fwd_whole_other_warpgroup — the wgmma masked forward takes the other
    warpgroup's whole-pair bit for its own, so a pair that crosses the
    causal diagonal (or a document's end) skips the per-score mask: the
    full-width cases, whose long documents have whole pairs.

The ring faults keep the ring's protocol (every stage is still waited for
and released), so they give wrong numbers, never a hang. The unmodified
copy must pass every check. A planted fault counts as caught when every
output it corrupts fails its check at the main path's shapes in bf16,
the main path's type (seg_global_causal: at the ragged
varlen case, the only one where the two causal masks differ;
seg_visit_every_tile: the visited-tile counts of the varlen cases;
masked_break_at_gap's dQ: fp32). Prints
one JSON line per copy and
exits 0 only when the clean copy passed and every fault was caught.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "paddle_tpu_torch/kernels/csrc/"
_FWD_DQ_LOOP = "      if (!contributes(q0, k0, kT, off, causal)) break;\n"
_DKV_LOOP = "      if (!contributes(q0, k0, kT, off, causal)) continue;\n"
_SEG_CAUSAL = "(causal && sCol[kT + cj] > rpos[r])"
_SEG_CAUSAL_DKV = "(causal && kpos[e >> 1] > sCol[kT + ci])"
_MASKED_LOOP = "    for (int base = 0; base < nk; base += 32) {\n"
_MASKED_BALLOT = ("                  : 0);\n      }\n"
                  "      unsigned live = __ballot_sync(0xffffffffu, c);\n")
_SEG_SKIP = "  return overlap && !(causal && one_seq && all_future);\n"
_BWD_SEG_CAUSAL_DQ = "(causal_b & (kpos > rpos[h]))"
_BWD_SEG_CAUSAL_DKV = "(causal_b & (kpos[h] > qpos[e]))"
_BWD_SEG_ID = "(kid != rid[h]) | "
_BWD_MINE = "      const bool mine = (word >> (24 + wg)) & 1;\n"
_BWD_COLS = "    const int* cols = m.ivec + s * kIvec;\n"
_FWD_COLS = "    const int* cols = w.ivec + s * kIvec;\n"
_FWD_WHOLE = "    const bool whole = (word >> (26 + wg)) & 1;\n"
_FWD_SEG_CAUSAL = "(causal_b & (kpos > rpos[h]))"
_RMS_PASS1 = "    load_row<T, kRes, V>(f, xr, rr, c);\n#pragma unroll\n" \
             "    for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);\n"
_SM90_MASKED = "    const bool masked_tile =\n"
_SM90_COL_MASK = "            if (col >= Sk || (causal && col > row + off))\n"
_SM90_ALPHA = "exp2f(m[h] - mn);"
_SM90_V = "    const uint8_t* v = sV + s * C::kKVBytes;\n"
_BWD_MASKED = "    const bool masked_tile =\n"
_BWD_DQ_COL = ("            if (col >= Sk || "
               "(causal && col > row0 + 8 * h + off))")
_BWD_DKV_COL = "            if (q >= Sq || (causal && key0 + 8 * h > q + off))"
_BWD_DQ_V = "    const uint8_t* vt = m.ring1 + s * C::kSmallBytes;\n"
_BWD_DKV_Q = "    const uint8_t* qt = m.ring0 + s * C::kSmallBytes;\n"
_BWD_DKV_DO = "    const uint8_t* dot = m.ring1 + s * C::kSmallBytes;\n"
_BWD_DQ_DS = (" " * 12 + "pack_bf16(sc[i] * (dp[i] - dlt[h]) * scale,\n"
              + " " * 22 + "sc[i + 1] * (dp[i + 1] - dlt[h]) * scale);\n")
_BWD_DKV_DS = "          d2[e] = p * (dp[i] - dlt[e]) * scale;\n"
_OTHER_STAGE = "(s + 1) % kStages * C"
_K_LOOP = "  for (int kt = kt0; kt < kt1; ++kt) {\n"
_SM90_PRODUCT = ("      for (int j = 0; j < kBatch; ++j)\n"
                 "        wgmma_rs<BM>(acc, a + 4 * j, dx + 2 * (k0 + j));\n")
_SM90_STAGE = "    const uint8_t* x = smem + s * C::kStageBytes;\n"
_DECODE_STAGE = "      const uint8_t* st = smem + s * C::kStageBytes;\n"
_DECODE_PRODUCT = "      mma_stage<kN8>(acc, st, warp, g, t);\n"
_DECODE_PARTS = "    const int parts = last - first + 1;\n"
_V_SCALE = "p * st_vs[lane]"
_V_SCALE_MMA = "p[k] * st_vs[tok]"
_PAGED_MERGE = ("    for (int r = 0; r < live; ++r) {\n"
                "      const float4 x = __ldcg(")
_PAGED_STAGE = "    const uint8_t* st = smem + s * C::kStageBytes;\n"
_LORA_CLUSTER_SUM = "        if (c < C) s += v[c];\n"
_LORA_KEY = "key_of(p, p.slots[i])"
_LORA_NULL = "  const bool live = key < p.nkeys - 1;\n"
_LORA_EPILOGUE = "yv[c] + __bfloat162float(__float2bfloat16_rn(d[c])));"
# name: ([(source, [(text, replacement, count)]), ...], check)
FAULTS = {
    "skip_tile": ([("flash_attention.cu",
                    [(_FWD_DQ_LOOP, _FWD_DQ_LOOP
                      + "      if (kt == 1) continue;\n", 2),
                     (_DKV_LOOP, _DKV_LOOP
                      + "      if (qt == blockIdx.x + 1) continue;\n", 1)]),
                   # the wgmma kernels still wait for and free tile 1, but
                   # mask all of it
                   ("flash_fwd_sm90.cu",
                    [(_SM90_MASKED, _SM90_MASKED + "        it == 1 ||\n", 1),
                     (_SM90_COL_MASK, _SM90_COL_MASK.replace(
                         "(col >= Sk", "(it == 1 || col >= Sk"), 1)]),
                   ("flash_bwd_sm90.cu",
                    [(_BWD_MASKED, _BWD_MASKED + "        it == 1 ||\n", 2),
                     (_BWD_DQ_COL, _BWD_DQ_COL.replace(
                         "(col >= Sk", "(it == 1 || col >= Sk"), 1),
                     (_BWD_DKV_COL, _BWD_DKV_COL.replace(
                         "(q >= Sq", "(it == 1 || q >= Sq"), 1)])],
                  "flash"),
    "no_rescale": ([("flash_fwd_sm90.cu", [(_SM90_ALPHA, "1.f;", 1)])],
                   "flash"),
    "flash_sm90_other_v_stage": (
        [("flash_fwd_sm90.cu",
          [(_SM90_V, _SM90_V.replace("s * C", "(s ^ 1) * C"), 1)])],
        "flash"),
    "flash_bwd_dq_other_v_stage": (
        [("flash_bwd_sm90.cu",
          [(_BWD_DQ_V, _BWD_DQ_V.replace("s * C", _OTHER_STAGE), 1)])],
        "flash"),
    "flash_bwd_dkv_other_qdo_stage": (
        [("flash_bwd_sm90.cu",
          [(_BWD_DKV_Q, _BWD_DKV_Q.replace("s * C", _OTHER_STAGE), 1),
           (_BWD_DKV_DO, _BWD_DKV_DO.replace("s * C", _OTHER_STAGE), 1)])],
        "flash"),
    "bwd_no_delta": (
        [("flash_bwd_sm90.cu",
          [(_BWD_DQ_DS, _BWD_DQ_DS.replace(" - dlt[h]", ""), 1),
           (_BWD_DKV_DS, _BWD_DKV_DS.replace(" - dlt[e]", ""), 1)])],
        "flash"),
    "qmm_drop_last_k_tile": (
        [("quant_matmul.cu",
          [(_K_LOOP, "  for (int kt = kt0; kt < kt1 - (kt1 == kt_total); "
            "++kt) {\n", 1)]),
         # the wgmma kernel still waits for and frees the last stage
         ("quant_matmul_sm90.cu",
          [(_SM90_PRODUCT, "      if (i + 1 < nk || kt0 + nk < kt_total)\n"
            + _SM90_PRODUCT, 1)])], "quant"),
    "qmm_sm90_next_stage": (
        [("quant_matmul_sm90.cu",
          [(_SM90_STAGE, _SM90_STAGE.replace(
              "s * C", "(s + 1) % kStages * C"), 1)])], "quant"),
    "qmm_decode_next_stage": (
        [("quant_decode_sm90.cu",
          [(_DECODE_STAGE, _DECODE_STAGE.replace(
              "s * C", "(s + 1) % kStages * C"), 1)])], "quant"),
    "qmm_decode_drop_last_unit": (
        [("quant_decode_sm90.cu",
          [(_DECODE_PRODUCT, "      if (u + 1 < u1)\n  " + _DECODE_PRODUCT,
            1)])], "quant"),
    "qmm_decode_merge_drops_last_part": (
        [("quant_decode_sm90.cu",
          [(_DECODE_PARTS, _DECODE_PARTS.replace("+ 1", ""), 1)])],
        "quant"),
    "int8_no_v_scale": ([("paged_attention.cu",
                          [(_V_SCALE, "p", 1), (_V_SCALE_MMA, "p[k]", 1)])],
                        "quant"),
    "paged_merge_drops_last_split": (
        [("paged_attention.cu",
          [(_PAGED_MERGE, _PAGED_MERGE.replace("r < live", "r < live - 1"),
            1)])], "paged"),
    "paged_ring_other_stage": (
        [("paged_attention.cu",
          [(_PAGED_STAGE, _PAGED_STAGE.replace(
              "s * C", "(s + 1) % C::kStages * C"), 2)])], "paged"),
    "lora_drop_h_slice": (
        [("lora_matmul.cu",
          [(_LORA_CLUSTER_SUM, _LORA_CLUSTER_SUM.replace("c < C", "c + 1 < C"),
            1)])], "lora"),
    "lora_row0_slot": ([("lora_matmul.cu",
                         [(_LORA_KEY, "key_of(p, p.slots[0])", 2)])], "lora"),
    "lora_drop_bucket1": (
        [("lora_matmul.cu",
          [(_LORA_NULL, _LORA_NULL.replace(
              "key < p.nkeys - 1",
              "key < p.nkeys - 1 && !(p.nb > 1 && key >= p.bk[1].key0)"),
            1)])], "lora"),
    "lora_epilogue_unrounded": (
        [("lora_matmul.cu",
          [(_LORA_EPILOGUE, "yv[c] + d[c]);", 1)])], "lora"),
    "seg_global_causal": ([("flash_attention.cu",
                            [(_SEG_CAUSAL, "(causal && col > row + off)", 2),
                             (_SEG_CAUSAL_DKV, "(causal && key > qi + off)",
                              1)]),
                           ("flash_bwd_sm90.cu",
                            [(_BWD_SEG_CAUSAL_DQ,
                              "(causal_b & (col > row + off))", 1),
                             (_BWD_SEG_CAUSAL_DKV,
                              "(causal_b & (key0 + 8 * h > q + off))", 1)]),
                           ("flash_fwd_sm90.cu",
                            [(_FWD_SEG_CAUSAL,
                              "(causal_b & (col > row0 + 8 * h + off))",
                              1)])],
                          "packed"),
    "masked_break_at_gap": (
        [("flash_attention.cu",
          [(_MASKED_LOOP, "    bool stop = false;\n" + _MASKED_LOOP, 2),
           (_MASKED_BALLOT, _MASKED_BALLOT
            + "      live = stop ? 0u : live & ~(live + 1u);\n"
            "      stop = stop || live != 0xffffffffu;\n", 2)])], "packed"),
    "seg_visit_every_tile": ([("flash_mask.cuh",
                               [(_SEG_SKIP, "  return true;\n", 1)])],
                             "packed"),
    "bwd_seg_drop_id": ([("flash_bwd_sm90.cu", [(_BWD_SEG_ID, "", 1)])],
                        "packed"),
    "bwd_dkv_drop_last_tile": (
        [("flash_bwd_sm90.cu",
          [(_BWD_MINE, _BWD_MINE.replace("& 1;", "& 1 && it + 1 < n;"),
            1)])], "packed"),
    "bwd_fm_dq_other_stage": (
        [("flash_bwd_sm90.cu",
          [(_BWD_COLS, _BWD_COLS.replace("s * kIvec",
                                         "(s + 1) % kStages * kIvec"), 1)])],
        "packed"),
    "fwd_mask_rows_other_stage": (
        [("flash_fwd_sm90.cu",
          [(_FWD_COLS, _FWD_COLS.replace("s * kIvec",
                                         "(s + 1) % kStages * kIvec"), 1)])],
        "packed"),
    "fwd_whole_other_warpgroup": (
        [("flash_fwd_sm90.cu",
          [(_FWD_WHOLE, _FWD_WHOLE.replace("(26 + wg)", "(27 - wg)"), 1)])],
        "packed"),
    "rms_residual_after_square": (
        [("fused_norm.cu",
          [(_RMS_PASS1, _RMS_PASS1.replace("kRes", "false"), 1)])], "norm"),
}
# the sources each check launches, built before a copy takes the card
CHECK_SOURCES = {
    "flash": ("flash_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu"),
    "quant": ("paged_attention.cu", "quant_matmul.cu",
              "quant_matmul_sm90.cu", "quant_decode_sm90.cu"),
    "lora": ("lora_matmul.cu",),
    "packed": ("flash_attention.cu", "flash_fwd_sm90.cu",
               "flash_bwd_sm90.cu"),
    "norm": ("fused_norm.cu",), "paged": ("paged_attention.cu",)}
GPU_SLOTS = 4
CHILD = """
import fcntl
import json
import time
import chip_smoke
from paddle_tpu_torch.kernels import build
build.build({sources!r})
while True:                     # one of the GPU slots (released at exit)
    slot = None
    for i in range({slots}):
        f = open({locks!r} + str(i), "w")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            slot = f
            break
        except BlockingIOError:
            f.close()
    if slot is not None:
        break
    time.sleep(0.2)
out = {{}}
for check in {checks!r}:
    if check == "flash":
        errs, failures = chip_smoke.check_flash_kernels({seed})
    elif check == "lora":
        errs, failures, _ = chip_smoke.check_lora_kernels({seed})
    elif check == "packed":
        errs, failures = chip_smoke.check_packed_kernels({seed})
    elif check == "paged":
        errs, failures = chip_smoke.check_paged_kernels({seed})
    elif check == "norm":
        errs, failures = chip_smoke.check_norm_kernel({seed})
        errs = {{"rms_norm_rows": errs}}
    else:
        errs, failures, _ = chip_smoke.check_quant_kernels({seed})
    out[check] = {{"errors": errs, "failures": failures}}
print(json.dumps(out))
"""


def plant(root: Path, plants) -> None:
    for source, edits in plants:
        path = root / CSRC / source
        text = path.read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{source}: expected {count} x {old!r}, "
                                   f"found {text.count(old)}")
            text = text.replace(old, new)
        path.write_text(text)


def must_fail(name: str):
    """The (check, output, case) triples a fault has to make fail: every
    output it corrupts at the main path's shapes in bf16."""
    import torch
    from chip_smoke import FLASH_SHAPES, NORM_SHAPES, flash_case, qmm_shapes
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul_route
    bh, sq, sk, d, causal = FLASH_SHAPES[0]
    bf16_route = {s: quant_matmul_route(*shape, torch.bfloat16)
                  for s, shape in qmm_shapes().items()}
    stream = [("quant", "quant_matmul", f"{s}_bfloat16")
              for s, r in bf16_route.items() if r == "decode_sm90"]
    flash_case = flash_case("bfloat16", bh, sq, sk, d, causal)
    if name == "skip_tile":
        return [("flash", o, flash_case)
                for o in ("out", "lse", "dq", "dk", "dv")]
    if name == "no_rescale":
        return [("flash", o, flash_case) for o in ("out", "lse")]
    if name == "flash_sm90_other_v_stage":
        return [("flash", "out", flash_case)]    # the lse never reads V
    if name == "flash_bwd_dq_other_v_stage":
        return [("flash", "dq", flash_case)]
    if name == "flash_bwd_dkv_other_qdo_stage":
        return [("flash", o, flash_case) for o in ("dk", "dv")]
    if name == "bwd_no_delta":
        return [("flash", o, flash_case) for o in ("dq", "dk")]
    if name == "qmm_drop_last_k_tile":
        # the bf16 cases of the two kernels it edits, and fp32 x (always
        # quant_matmul.cu)
        return [("quant", "quant_matmul", f"{s}_{dt}")
                for s, r in bf16_route.items() for dt in ("bfloat16",
                                                           "float32")
                if dt == "float32" or r != "decode_sm90"]
    if name == "qmm_sm90_next_stage":
        return [("quant", "quant_matmul", f"{s}_bfloat16")
                for s, r in bf16_route.items() if r == "sm90"]
    if name in ("qmm_decode_next_stage", "qmm_decode_drop_last_unit",
                "qmm_decode_merge_drops_last_part"):
        # every decode-stream case: each has CTAs of several units and
        # column tiles shared by several CTAs
        return stream
    if name in ("lora_drop_h_slice", "lora_drop_bucket1"):
        return [("lora", "lora_apply", f"{c}_bfloat16")
                for c in ("decode", "prefill", "rows512", "ragged")]
    if name == "lora_row0_slot":
        # the prefill chunk is one entry: its rows are row 0's already
        return [("lora", "lora_apply", f"{c}_bfloat16")
                for c in ("decode", "rows512", "ragged")]
    if name == "lora_epilogue_unrounded":
        # one rounding or two differ where y + d lies near a bf16 rounding
        # boundary: hundreds of elements at the full-width cases
        return [("lora", "lora_apply", f"{c}_bfloat16")
                for c in ("decode", "prefill", "rows512")]
    if name == "seg_global_causal":
        # the full-width documents are self-attention over whole sequences,
        # where the two masks coincide; the ragged case's do not
        return [("packed", o, "varlen_ragged_bfloat16")
                for o in ("out", "lse", "dq", "dk", "dv")]
    if name == "masked_break_at_gap":   # bf16 is the wgmma kernels'
        return [("packed", o, f"{c}_float32") for o in ("out", "lse", "dq")
                for c in ("varlen_full", "flashmask_doc_full")]
    if name == "bwd_seg_drop_id":
        return [("packed", "dq", f"{c}_bfloat16")
                for c in ("varlen_full", "varlen_ragged")]
    if name == "bwd_dkv_drop_last_tile":
        return [("packed", o, f"{c}_bfloat16") for o in ("dk", "dv")
                for c in ("varlen_full", "varlen_ragged",
                          "flashmask_doc_full", "flashmask_band_c2")]
    if name in ("bwd_fm_dq_other_stage", "fwd_mask_rows_other_stage"):
        o = "dq" if name.startswith("bwd") else "out"
        return [("packed", o, f"{c}_bfloat16")
                for c in ("flashmask_doc_full", "flashmask_band_c2",
                          "flashmask_nc2", "flashmask_nc4", "flashmask_heads")]
    if name == "fwd_whole_other_warpgroup":
        return [("packed", "out", f"{c}_bfloat16")
                for c in ("varlen_full", "flashmask_doc_full",
                          "flashmask_window_full")]
    if name == "seg_visit_every_tile":
        return [("packed", "tiles", f"{c}_{dt}")
                for c in ("varlen_full", "varlen_ragged")
                for dt in ("bfloat16", "float32")]
    if name == "rms_residual_after_square":
        return [("norm", "rms_norm_rows", f"{r}x{h}_bfloat16_residual")
                for r, h in NORM_SHAPES]
    if name in ("paged_merge_drops_last_split", "paged_ring_other_stage"):
        # the main path's type at the serve and long-context shapes, where
        # rows span several splits and every split several stages
        return [("paged", k, f"{c}_bfloat16")
                for k in ("paged_attention_decode",
                          "paged_attention_decode_int8")
                for c in ("serve", "b1_32768", "b4_8192")]
    return [("quant", "paged_attention_decode_int8", "bfloat16")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA card is available", file=sys.stderr)
        return 2

    copies = {"clean": ([], ("flash", "quant", "lora", "packed", "norm",
                             "paged"))}
    copies.update({name: (plants, (check,))
                   for name, (plants, check) in FAULTS.items()})
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name, (plants, checks) in copies.items():
                root = Path(tmp) / name
                shutil.copytree(ROOT / "paddle_tpu_torch",
                                root / "paddle_tpu_torch",
                                ignore=shutil.ignore_patterns("__pycache__"))
                shutil.copy(ROOT / "chip_smoke.py", root)
                plant(root, plants)
                sources = sorted({s for c in checks
                                  for s in CHECK_SOURCES[c]})
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c",
                     CHILD.format(checks=list(checks), seed=args.seed,
                                  sources=sources, slots=GPU_SLOTS,
                                  locks=str(Path(tmp) / "gpu_slot"))],
                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
            results = {name: p.communicate() + (p.returncode,)
                       for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    ok = True
    for name, (out, err, rc) in results.items():
        if rc != 0:
            print(json.dumps({"copy": name, "exit": rc,
                              "stderr": err[-4000:]}), flush=True)
            ok = False
            continue
        res = json.loads(out.strip().splitlines()[-1])
        failed = sorted({(check, *f) for check, r in res.items()
                         for f in r["failures"]})
        if name == "clean":
            want, verdict = [], not failed
        else:
            want = must_fail(name)
            verdict = all(w in failed for w in want)
        ok &= verdict
        # what the checks measured: the must-fail cases of a fault, every
        # error of the clean copy
        errors = ({":".join(w): res[w[0]]["errors"][w[1]][w[2]]
                   for w in want} if want else
                  {c: r["errors"] for c, r in res.items()})
        print(json.dumps({"copy": name, "passed": verdict,
                          "must_fail": [":".join(w) for w in want],
                          "failed_checks": [":".join(f) for f in failed],
                          "errors": errors}), flush=True)
    print(json.dumps({"fault_check_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
