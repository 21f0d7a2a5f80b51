#!/usr/bin/env python3
"""Where the int8 decode stream's time goes (csrc/quant_decode_sm90.cu).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_qmm_breakdown.py [--seed N]

Builds the kernel and copies of it with one part cut out, in a temporary
directory (the repository's own files are never touched):
  stream     — the consumers wait for and release every stage and do
               nothing else (no conversion, product or flush): the TMA
               ring alone;
  no_merge   — shared column tiles are never merged (partials written,
               tickets drawn, nothing summed);
  no_convert — the int8 -> bf16 conversion replaced by one byte shuffle
               (wrong numbers; the same loads, products and flushes).
Each is timed with chip_smoke.time_ms at Llama-3-8B's decode shapes (M 16
gate/up, down and LM head; the head's M 1 row) after time_ms's usual
flush (`zero_`, which leaves ~50 MB of dirty lines in L2) and after one
that leaves L2 clean (a read of the flush buffer), beside one PyTorch
read of the same weight bytes (amax) after each. Prints the card, then
one JSON line per shape. Imports nothing of JAX. Exits 2 without a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# name: (text in csrc/quant_decode_sm90.cu, replacement)
CUTS = {
    "stream": ("    const float* v = &acc[0][0][0];\n",
               "    continue;\n    const float* v = &acc[0][0][0];\n"),
    "no_merge": ("    if (!*s_last) continue;\n", "    continue;\n"),
    "no_convert": ("  return __byte_perm(__float_as_uint(lo), "
                   "__float_as_uint(hi), 0x7632);",
                   "  return __byte_perm(p, q, 0x5140 + i);"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_qmm_breakdown: no CUDA card is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    src = (build.CSRC / qm.DECODE_SOURCE).read_text()
    entries = {"kernel": qm._decode_entry()}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (old, new) in CUTS.items():
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   f"once")
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
            fn = ctypes.CDLL(str(Path(tmp) / f"{name}.so")).quant_decode_sm90
            fn.argtypes = qm.DECODE_C_ARGTYPES
            fn.restype = ctypes.c_int
            entries[name] = fn
        print(cs.nvidia_smi_line(), flush=True)
        flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                device="cuda")
        flushes = {"zero": flush_buf.zero_,
                   "l2_clean": flush_buf.view(torch.float32).amax}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        shapes = cs.qmm_shapes()
        for case in ("gate_up_m16", "down_m16", "lm_head_m16", "lm_head_m1"):
            M, K, N = shapes[case]
            x, qw, scale = cs.qmm_inputs((M, K, N), args.seed)
            xb = x.bfloat16()
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            ctas = qm.quant_decode_plan(M, K, N, sms)
            ws, tickets = qm._decode_scratch(xb.device, ctas, -(-N // 256))
            ptrs = [t.data_ptr() for t in (xb, qw, scale, out, ws, tickets)]
            row = {"case": case, "M": M, "K": K, "N": N,
                   "bound_ms": (K * N + N * 4 + M * K * 2 + M * N * 2)
                   / cs.HBM_BYTES_PER_S * 1e3}
            for name, fn in entries.items():
                def call(fn=fn):
                    if fn(*ptrs, M, K, N, ctas, stream) != 0:
                        raise RuntimeError(f"{name}: launch refused")
                for fl, flush in flushes.items():
                    row[f"{name}_ms_{fl}"] = cs.time_ms(call, flush)
            words = qw.view(torch.float32)
            for fl, flush in flushes.items():
                row[f"weight_read_ms_{fl}"] = cs.time_ms(words.amax, flush)
            tickets.zero_()        # the cut copies may leave counters set
            print(json.dumps(row), flush=True)
            del x, qw, scale, xb, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
