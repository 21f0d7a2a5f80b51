#!/usr/bin/env python3
"""Times another commit's kernels and main paths beside this tree's, in
one call on one card.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_ab.py --parent DIR [--seed N] [--phases kernels,packed,...]

DIR is a checkout of the commit to compare with, for example the parent
commit unpacked with `git archive` into a directory .gitignore lists. In
the order parent, this tree, this tree, parent, a child process imports
one tree's `paddle_tpu_torch` and `chip_smoke` and runs the phases asked
for (all by default):
  kernels     — chip_smoke.time_ms (CUDA events, median of 30 launches,
                L2 flushed before each) of the int8 matmul with bf16 x at
                Llama-3-8B's gate/up and down, M 16 (the decode bucket)
                and every prefill bucket 32-512, and at the LM head, M 16
                and M 1 (the head's row at a prefill chunk's end); the
                flash forward, dQ and
                dK/dV at the training shape (B*H 32, S 4096, D 128,
                causal); the varlen and flashmask (document mask) forward,
                dQ and dK/dV at packed_attention's full width; the paged
                decode through the public paged_attention_decode, bf16
                and int8 KV with bf16 queries, at the serve shape (B 16,
                H 32, KVH 8, D 128, page 16) and the long-context shapes
                (one request at 32768 tokens over 2048 pages, four at
                8192), on batches built by this tree's
                chip_smoke.paged_batch in both trees;
  paged       — the paged decode of `kernels` alone;
  lora        — chip_smoke.time_ms of one LoRA projection hook,
                `apply_lora("gate_proj", x, y)` under `lora_scope` of a
                `build_context` over chip_smoke.lora_registry's adapters
                (gate_proj at Llama-3-8B's widths, rank buckets 8 and 16),
                under torch.inference_mode as the engine runs it: 16
                decode rows tagged round-robin a1, a2, a3, base, and one
                512-token prefill chunk of a2, bf16 x and y;
  packed      — chip_smoke.phase_packed_attention: ms per forward +
                backward of each entry point;
  train       — chip_smoke.phase_train: step ms and MFU;
  serve_quant — chip_smoke.phase_serve, then phase_serve_quant: wall
                seconds of the prefill-only and mixed steps, decode step
                ms and tokens/s, and the profiled decode-only step's
                device ms, launches and int8 matmul kernels' ms and
                launches;
  serve_lora  — chip_smoke.phase_serve, then phase_serve_lora: decode
                step ms and tokens/s, and the profiled decode-only step's
                device ms, launches and LoRA kernels' ms and launches.
Each child builds its tree's kernels into that tree's build directory; a
library this tree has already built from the same source text and flags
(the hash in its file name) is copied there first instead of rebuilt.
Prints the card, one JSON line per run, then one with each number's runs
per tree and the ratio of their means (this tree over the parent).
Imports nothing of JAX. Exits 2 without a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("kernels", "paged", "lora", "packed", "train", "serve_quant",
          "serve_lora")
QMM_ROWS = (16, 32, 64, 128, 256, 512)


def _this_smoke():
    """This tree's chip_smoke module, whichever tree the child imports:
    its batch builders use only entry points both trees have."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_this", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paged_kernel_times(seed: int, flush):
    """{case: ms} of the paged decode at the serve and long-context
    shapes, bf16 and int8 KV, bf16 queries."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import paged_attention as pa
    here = _this_smoke()
    shapes = {"serve": (16, 72, here.serve_lens(seed))}
    shapes.update({name: (B, P, [n] * B)
                   for name, (B, P, n) in here.PAGED_LONG.items()})
    res = {}
    for name, (B, P, lens) in shapes.items():
        for kv in ("bfloat16", "int8"):
            batch = here.paged_batch(seed + 40, B, 8, 4, 128, 16, P, lens, kv)
            q = batch["q"].bfloat16()
            args = (q, batch["k"], batch["v"], batch["bt"], batch["sl"])
            sc = batch["scales"]
            extra = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
            res[f"paged_{kv}_{name}"] = cs.time_ms(
                lambda: pa.paged_attention_decode(*args, **extra), flush)
            del batch, args, extra
    return res


def qmm_times(seed: int):
    """{case: ms} of the int8 matmul with bf16 x at the two trees' shared
    shapes."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.models.llama import llama_3_8b

    cfg = llama_3_8b()
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    shapes = {f"qmm_{name}_m{M}": (M, K, N) for M in QMM_ROWS
              for name, (K, N) in (("gate_up", (h, i)), ("down", (i, h)))}
    shapes.update(qmm_lm_head_m16=(16, h, v), qmm_lm_head_m1=(1, h, v))
    res = {}
    for name, shape in shapes.items():
        x, qw, scale = cs.qmm_inputs(shape, seed)
        xb = x.bfloat16()
        res[name] = cs.time_ms(lambda: qm.quant_matmul(xb, qw, scale), flush)
        del x, qw, scale, xb
    return res


def kernel_times(seed: int):
    """{case: ms} of the kernels of the two trees' shared shapes."""
    import math
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    res = qmm_times(seed)
    BH, S, _, D = cs.FLASH_SHAPES[0][:4]    # the parent's tuples may be 4 long
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), scale, True)
    res["flash_fwd"] = cs.time_ms(lambda: fa.flash_fwd(q, k, v, scale, True),
                                  flush)
    res["flash_dq"] = cs.time_ms(lambda: fa.flash_dq(*args), flush)
    res["flash_dkv"] = cs.time_ms(lambda: fa.flash_dkv(*args), flush)
    del q, k, v, do, out, lse, args
    res.update(paged_kernel_times(seed, flush))
    lens = cs.pack_documents(seed)
    q, k, v, do = (t.transpose(0, 1).contiguous()
                   for t in cs.packed_inputs(seed, lens))
    scale = 1.0 / math.sqrt(cs.PACK_DIM)
    masks = cs.packed_masks(lens)
    for variant, kw in (("varlen", masks["varlen"]),
                        ("flashmask", masks["document"])):
        kw = dict(kw, summary=fa.tile_summary(
            kw.get("seg"), kw.get("fm"), kw.get("fm_causal", True)))
        out, lse = fa.flash_fwd(q, k, v, scale, True, **kw)
        args = (q, k, v, do, lse, fa.flash_delta(out, do), scale, True)
        res[f"{variant}_fwd"] = cs.time_ms(
            lambda: fa.flash_fwd(q, k, v, scale, True, **kw), flush)
        res[f"{variant}_dq"] = cs.time_ms(
            lambda: fa.flash_dq(*args, **kw), flush)
        res[f"{variant}_dkv"] = cs.time_ms(
            lambda: fa.flash_dkv(*args, **kw), flush)
    return res


def lora_times(seed: int):
    """{case: ms} of the LoRA projection hook through entry points both
    trees have (build_context, lora_scope, apply_lora)."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import llama_3_8b
    from paddle_tpu_torch.serving.lora import llama_lora_dims
    from paddle_tpu_torch.serving.lora.runtime import (apply_lora,
                                                       build_context,
                                                       lora_scope)
    dims = llama_lora_dims(llama_3_8b(), targets=("gate_proj",))
    H, N = dims["gate_proj"]
    reg = cs.lora_registry(dims, seed)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    decode = [reg.slot_of(t) if t else 0 for t in cs.LORA_TAGS] * 4
    res = {}
    for name, slots, t in (("lora_decode", decode, 1),
                           ("lora_prefill", [reg.slot_of("a2")], 512)):
        rows = torch.tensor(slots, dtype=torch.int32, device="cuda")
        x = torch.randn(len(slots), t, H, generator=gen,
                        device="cuda").bfloat16()
        y = torch.randn(len(slots), t, N, generator=gen,
                        device="cuda").bfloat16()
        with torch.inference_mode():
            ctx = build_context(reg.layout, reg.flat_args(), rows)
            with lora_scope(ctx):
                res[name] = cs.time_ms(
                    lambda: apply_lora("gate_proj", x, y), flush)
        del ctx, x, y
    return res


def child(phases, seed: int) -> int:
    """One run on the tree in the working directory: prints {phase:
    {name: number}} as its last line."""
    sys.path.insert(0, os.getcwd())    # this tree's package, not chip_ab's
    import gc
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build

    lines = []
    cs.emit = lines.append             # the phases' JSON lines, kept

    def line(phase):
        return next(x for x in reversed(lines) if x.get("phase") == phase)

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    build.build(src.rsplit("/", 1)[1] for src in cs.SOURCES)
    out = {}
    if "kernels" in phases:
        out["kernels"] = kernel_times(seed)
        free()
    if "paged" in phases:
        out["paged"] = paged_kernel_times(seed, torch.empty(
            256 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_)
        free()
    if "lora" in phases:
        out["lora"] = lora_times(seed)
        free()
    if "packed" in phases:
        cs.phase_packed_attention(seed)
        out["packed"] = {name: e["ms_median"] for name, e in
                         line("packed_attention")["entries"].items()}
        free()
    if "train" in phases:
        cs.phase_train(seed)
        t = line("train")
        out["train"] = {"step_ms": t["step_ms"],
                        "mfu": t["mfu_vs_989tflops"]}
        free()
    if "serve_quant" in phases:
        served = cs.phase_serve(seed)[2]
        free()
        cs.phase_serve_quant(served, seed)
        del served
        q = line("serve_quant")
        prof = q["profiled_step"] or {}
        qmm = prof.get("by_kind", {}).get("quant_matmul", {})
        out["serve_quant"] = {
            **{k: q[k] for k in ("prefill_steps_s", "mixed_steps_s",
                                 "decode_step_ms", "decode_tokens_per_s",
                                 "serve_s")},
            "profiled_device_ms": prof.get("device_ms"),
            "profiled_launches": prof.get("kernel_launches"),
            "profiled_qmm_ms": qmm.get("ms", 0.0),
            "profiled_qmm_launches": qmm.get("launches", 0)}
        free()
    if "serve_lora" in phases:
        served = cs.phase_serve(seed)[2]
        free()
        cs.phase_serve_lora(served, seed)
        del served
        q = line("serve_lora")
        prof = q["profiled_step"] or {}
        lora = prof.get("by_kind", {}).get("lora", {})
        out["serve_lora"] = {
            "decode_step_ms": q["decode_step_ms"],
            "decode_tokens_per_s": q["decode_tokens_per_s"],
            "serve_s": q["serve_s"],
            "profiled_device_ms": prof.get("device_ms"),
            "profiled_launches": prof.get("kernel_launches"),
            "profiled_lora_ms": lora.get("ms", 0.0),
            "profiled_lora_launches": lora.get("launches", 0)}
        free()
    print(json.dumps(out), flush=True)
    return 0


def seed_build(parent: Path) -> None:
    """Copies this tree's built libraries into the parent's build
    directory: a file name holds the hash of its source text and flags,
    so the parent loads only the ones it would build identically."""
    from paddle_tpu_torch.kernels import build
    dst = parent / "build" / "paddle_tpu_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in build.BUILD_DIR.glob("*.so"):
        if not (dst / lib.name).exists():
            shutil.copy2(lib, dst / lib.name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"phases are {PHASES}")
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card is available", file=sys.stderr)
        return 2
    if args.child:
        return child(phases, args.seed)
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        ap.error("--parent must be a checkout holding chip_smoke.py")
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    build.build(src.rsplit("/", 1)[1] for src in cs.SOURCES)
    parent = args.parent.resolve()
    seed_build(parent)
    print(cs.nvidia_smi_line(), flush=True)
    runs = {"parent": [], "this": []}
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                      ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_ab.py"), "--child",
             "--phases", ",".join(phases), "--seed", str(args.seed)],
            cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(json.dumps({"run": tag, "exit": proc.returncode,
                              "stderr": proc.stderr[-4000:]}), flush=True)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": tag, **res}), flush=True)
        runs[tag].append(res)
    summary = {}
    for phase, names in runs["this"][0].items():
        for name in names:
            p = [r[phase][name] for r in runs["parent"]]
            t = [r[phase][name] for r in runs["this"]]
            summary[f"{phase}.{name}"] = {
                "parent": p, "this": t,
                "ratio": statistics.mean(t) / statistics.mean(p)}
    print(json.dumps({"ab_summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
