#!/usr/bin/env python3
"""Where the masked wgmma backward's time goes (csrc/flash_bwd_sm90.cu,
segment and flashmask modes).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_flash_mask_breakdown.py [--seed N]

Builds the source and copies of it in a temporary directory (the
repository's own files are never touched):
  no_mask  — no pair evaluates the per-score mask (wrong numbers where a
             pair is not whole; the same walk, loads and products): what
             the mask costs;
  all_mask — every pair evaluates it, whole or not: what the whole-pair
             shortcut saves.
Each times the masked dQ and dK/dV entries with chip_smoke.time_ms at
packed_attention's full width (B*H 32, D 128, bf16) on the packed row's
documents as segments, as the causal document mask and as the window,
and on one document spanning the row (segments and document mask) beside
the plain causal kernels at the same S, with each masked case's pairs a
head and those of them that are whole (no score masked: the kernels skip
the per-score mask there), from `masked_bwd_walk`. Prints the card, then
one JSON line per case. Imports nothing of JAX. Exits 2 without a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

# the masked modes' choice between the two passes, in dQ and in dK/dV
_PICK = ("      if (whole)\n        probs(std::false_type{});\n      else\n"
         "        probs(std::true_type{});\n")
CUTS = {"no_mask": (_PICK, "      probs(std::false_type{});\n"),
        "all_mask": (_PICK, "      probs(std::true_type{});\n")}
ENTRIES = ("flash_attention_dq_sm90_masked",
           "flash_attention_dkv_sm90_masked")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_mask_breakdown: no CUDA card is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import flash_attention as fa

    src = (build.CSRC / fa.SM90_BWD_SOURCE).read_text()
    build.build([fa.KERNEL_SOURCE, fa.SM90_SOURCE, fa.SM90_BWD_SOURCE])
    entry = fa._entry
    variants = {"kernel": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (old, new) in CUTS.items():
            if src.count(old) != 2:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   f"twice")
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(src.replace(old, new))
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
            variants[name] = {}
            for e in ENTRIES:
                fn = getattr(lib, e)
                fn.argtypes = fa.SM90_C_ARGTYPES[e][1]
                fn.restype = ctypes.c_int
                variants[name][e] = fn

        print(cs.nvidia_smi_line(), flush=True)
        lens = cs.pack_documents(args.seed)
        S, D = sum(lens), cs.PACK_DIM
        q, k, v, do = (t.transpose(0, 1).contiguous()
                       for t in cs.packed_inputs(args.seed, lens))
        scale = 1.0 / math.sqrt(D)
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                            device="cuda").zero_
        packed, whole_row = cs.packed_masks(lens), cs.packed_masks([S])
        cases = {"varlen": packed["varlen"], "document": packed["document"],
                 "window": packed["window"],
                 "varlen_one_document": whole_row["varlen"],
                 "document_one_document": whole_row["document"],
                 "plain_causal": {}}
        for case, kw in cases.items():
            if kw:
                kw = dict(kw, summary=fa.tile_summary(
                    kw.get("seg"), kw.get("fm"), kw.get("fm_causal", True)))
            out, lse = fa.flash_fwd(q, k, v, scale, True, **kw)
            a = (q, k, v, do, lse, fa.flash_delta(out, do), scale, True)
            row = {"case": case, "S": S, "BH": q.shape[0], "D": D,
                   "documents": len(lens) if case in ("varlen", "document")
                   else 1}
            if kw:      # one head's walk: its masks are the same in each
                one = {k_: (tuple(t.cpu() for t in x) if k_ == "seg"
                            else x.cpu()) for k_, x in kw.items()
                       if k_ in ("seg", "fm")}
                for kern in ("dq", "dkv"):
                    walk = fa.masked_bwd_walk(
                        kern, 1, S, S, True,
                        fm_causal=kw.get("fm_causal", True), **one)
                    row[f"{kern}_pairs_per_head"] = sum(
                        sum(c) for t in walk.values() for _, c, _ in t)
                    row[f"{kern}_whole_pairs_per_head"] = sum(
                        sum(w) for t in walk.values() for _, _, w in t)
            for name, fns in variants.items():
                if not kw and name != "kernel":
                    continue
                fa._entry = (lambda n: fns.get(n) or entry(n))
                try:
                    row[f"dq_ms_{name}"] = cs.time_ms(
                        lambda: fa.flash_dq(*a, **kw), flush)
                    row[f"dkv_ms_{name}"] = cs.time_ms(
                        lambda: fa.flash_dkv(*a, **kw), flush)
                finally:
                    fa._entry = entry
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
