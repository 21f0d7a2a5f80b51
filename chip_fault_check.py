#!/usr/bin/env python3
"""Shows that chip_smoke.py's flash-kernel checks catch a wrong kernel.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_fault_check.py [--seed N]

For the unmodified kernels and for each planted fault below, it copies
`paddle_tpu_torch/` and `chip_smoke.py` into a temporary directory,
edits the copy's `csrc/flash_attention.cu` (the repository's own files
are never touched), and in a child process on that copy builds the
kernels and runs `chip_smoke.check_flash_kernels`, the checks the smoke
run applies. The children run together and each is waited for.

Faults:
  * skip_tile  — the forward and dQ kernels skip the second key tile of
    every query tile, the dK/dV kernel the second query tile of every
    key tile: each affected row loses 64 of its up to 4096 terms;
  * no_rescale — the forward drops the online-softmax rescale of its
    running sum and accumulator (alpha = 1).

The unmodified copy must pass every check. A planted fault counts as
caught when every output it corrupts fails its check at the training
shape in bf16, the main path's type. Prints one JSON line per copy and
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
CU = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
_FWD_DQ_LOOP = "    if (!contributes(q0, k0, kT, off, causal)) break;\n"
_DKV_LOOP = "    if (!contributes(q0, k0, kT, off, causal)) continue;\n"
_ALPHA = "expf(m[r] - mn);"
# name: ([(text, replacement, count)], outputs it must make fail)
FAULTS = {
    "skip_tile": ([(_FWD_DQ_LOOP, _FWD_DQ_LOOP
                    + "    if (kt == 1) continue;\n", 2),
                   (_DKV_LOOP, _DKV_LOOP
                    + "    if (qt == blockIdx.x + 1) continue;\n", 1)],
                  ("out", "lse", "dq", "dk", "dv")),
    "no_rescale": ([(_ALPHA, "1.f;", 1)], ("out", "lse")),
}
CHILD = """
import json, sys
import chip_smoke
errs, failures = chip_smoke.check_flash_kernels({seed})
print(json.dumps({{"errors": errs, "failures": failures}}))
"""


def plant(root: Path, edits) -> None:
    path = root / CU
    text = path.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{CU}: expected {count} x {old!r}, found "
                               f"{text.count(old)}")
        text = text.replace(old, new)
    path.write_text(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA card is available", file=sys.stderr)
        return 2
    from chip_smoke import FLASH_SHAPES

    bh, sq, sk, d = FLASH_SHAPES[0]
    main_case = f"bfloat16_S{sq}x{sk}_D{d}"
    copies = {"clean": ([], ())} | FAULTS
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name, (edits, _) in copies.items():
                root = Path(tmp) / name
                shutil.copytree(ROOT / "paddle_tpu_torch",
                                root / "paddle_tpu_torch",
                                ignore=shutil.ignore_patterns("__pycache__"))
                shutil.copy(ROOT / "chip_smoke.py", root)
                plant(root, edits)
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", CHILD.format(seed=args.seed)],
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
        failed = sorted({tuple(f) for f in res["failures"]})
        must_fail = copies[name][1]
        if name == "clean":
            verdict = not failed
        else:
            verdict = all((o, main_case) in failed for o in must_fail)
        ok &= verdict
        print(json.dumps({
            "copy": name, "passed": verdict, "must_fail": list(must_fail),
            "failed_checks": failed,
            "main_case": {o: res["errors"][o][main_case]
                          for o in res["errors"]}}), flush=True)
    print(json.dumps({"fault_check_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
