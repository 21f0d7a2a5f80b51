#!/usr/bin/env python3
"""Where the masked wgmma kernels' time goes (the forward of
csrc/flash_fwd_sm90.cu, dQ and dK/dV of csrc/flash_bwd_sm90.cu, segment
and flashmask modes).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_flash_mask_breakdown.py [--seed N]

Builds the two sources and copies of them in a temporary directory (the
repository's own files are never touched):
  no_mask      — no pair evaluates the per-score mask (wrong numbers where
                 a pair is not whole; the same walk, loads and products):
                 what the mask costs;
  all_mask     — every pair evaluates it, whole or not: what the
                 whole-pair shortcut saves;
  grid_by_head — the forward's masked blocks in the plain kernel's order
                 (a head's query tiles in turn), the forward only;
  ring_only    — the forward's consumers only wait for and free each
                 stage (wrong numbers): the list, the loads and the
                 blocks' start and end, the forward only.
Each times the masked forward, dQ and dK/dV entries (a cut, the ones it
edits) with
chip_smoke.time_ms at packed_attention's full width (B*H 32, D 128,
bf16) on the packed row's documents as segments, as the causal document
mask and as the window, and on one document spanning the row (segments
and document mask) beside the plain causal kernels at the same S, with
each masked case's pairs a head and those of them that are whole (no
score masked: the kernels skip the per-score mask there), from
`masked_walk`. Prints the card, then one JSON line per case. Imports
nothing of JAX. Exits 2 without a CUDA card.
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

_FWD, _BWD = "flash_fwd_sm90.cu", "flash_bwd_sm90.cu"


def _pick(f, i, masked=None):
    """The masked modes' choice between the masked and the unmasked pass
    `f` at indentation `i` (masked None), or one pass alone."""
    if masked is None:
        return (f"{i}if (whole)\n{i}  {f}(std::false_type{{}});\n{i}else\n"
                f"{i}  {f}(std::true_type{{}});\n")
    return f"{i}{f}(std::{'true' if masked else 'false'}_type{{}});\n"


_FWD_CONSUMERS = (
    "  masked_rows<DP, kMode>(w, mk, sK, sV, kfull, vfull, empty, dq, o, m, l,"
    " nk,\n                         Sq, Sk, scale_log2, causal, row0, b, wg);"
    "\n")
_FWD_RING = (
    "  for (int it = 0; it < nk; ++it) {\n"
    "    mbar_wait(&kfull[it % C::kStages], (it / C::kStages) & 1);\n"
    "    mbar_wait(&vfull[it % C::kStages], (it / C::kStages) & 1);\n"
    "    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % C::kStages]);\n"
    "  }\n")
# name: {source: [(text, replacement, times in the source)]}
CUTS = {
    "no_mask": {_FWD: [(_pick("scores", " " * 4),
                        _pick("scores", " " * 4, False), 1)],
                _BWD: [(_pick("probs", " " * 6),
                        _pick("probs", " " * 6, False), 2)]},
    "all_mask": {_FWD: [(_pick("scores", " " * 4),
                         _pick("scores", " " * 4, True), 1)],
                 _BWD: [(_pick("probs", " " * 6),
                         _pick("probs", " " * 6, True), 2)]},
    # the forward's masked blocks in the plain kernel's order (a head's
    # query tiles in turn)
    "grid_by_head": {_FWD: [
        ("  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;\n"
         "  const int bh = blockIdx.x;\n",
         "  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBM;\n"
         "  const int bh = blockIdx.y;\n", 1),
        ("  const dim3 grid(BH, (Sq + kBM - 1) / kBM);\n",
         "  const dim3 grid((Sq + kBM - 1) / kBM, BH);\n", 1)]},
    # the forward's consumers only wait for and free each stage: the list,
    # the loads, the blocks' start and end
    "ring_only": {_FWD: [(_FWD_CONSUMERS, _FWD_RING, 1)]},
}
ENTRIES = {_FWD: ("flash_attention_fwd_sm90_masked",),
           _BWD: ("flash_attention_dq_sm90_masked",
                  "flash_attention_dkv_sm90_masked")}
KERNELS = {_FWD: ("fwd",), _BWD: ("dq", "dkv")}


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

    build.build([fa.KERNEL_SOURCE, fa.SM90_SOURCE, fa.SM90_BWD_SOURCE])
    entry = fa._entry
    variants = {"kernel": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, edits in CUTS.items():
            for source, subs in edits.items():
                src = (build.CSRC / source).read_text()
                for old, new, count in subs:
                    if src.count(old) != count:
                        raise RuntimeError(f"{name}: {old!r} is not in "
                                           f"{source} {count} times")
                    src = src.replace(old, new)
                cu = Path(tmp) / f"{name}_{source}"
                cu.write_text(src)
                procs[name, source] = subprocess.Popen(
                    [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                     "-o", str(cu.with_suffix(".so")), str(cu)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        for (name, source), proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} {source}:\n{log}")
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}_{source[:-3]}.so"))
            for e in ENTRIES[source]:
                fn = getattr(lib, e)
                fn.argtypes = fa.SM90_C_ARGTYPES[e][1]
                fn.restype = ctypes.c_int
                variants.setdefault(name, {})[e] = fn

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
                for kern in ("fwd", "dq", "dkv"):
                    walk = fa.masked_walk(
                        kern, 1, S, S, True,
                        fm_causal=kw.get("fm_causal", True), **one)
                    row[f"{kern}_pairs_per_head"] = sum(
                        sum(c) for t in walk.values() for _, c, _ in t)
                    row[f"{kern}_whole_pairs_per_head"] = sum(
                        sum(w) for t in walk.values() for _, _, w in t)
                    # the forward's warpgroups both run every ring tile
                    row[f"{kern}_ring_tiles_per_head"] = sum(
                        len(t) for t in walk.values())
            calls = {"fwd": lambda: fa.flash_fwd(q, k, v, scale, True, **kw),
                     "dq": lambda: fa.flash_dq(*a, **kw),
                     "dkv": lambda: fa.flash_dkv(*a, **kw)}
            for name, fns in variants.items():
                if not kw and name != "kernel":
                    continue
                kerns = [kern for src in (CUTS.get(name) or ENTRIES)
                         for kern in KERNELS[src]]
                fa._entry = (lambda n: fns.get(n) or entry(n))
                try:
                    for kern in kerns:
                        row[f"{kern}_ms_{name}"] = cs.time_ms(calls[kern],
                                                              flush)
                finally:
                    fa._entry = entry
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
