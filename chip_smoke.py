#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the repository root on a machine with one CUDA card (an H100;
the kernels build for sm_90a):

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  1. device  — the card (`nvidia-smi` name and power limit), torch/CUDA.
  2. build   — compiles every CUDA kernel of the serving path from the
               repository's sources (one nvcc per source, in parallel).
  3. serve   — builds Llama-3-8B (`llama_3_8b`, all 32 layers, bf16)
               from seeded random weights on the card and serves 16
               greedy requests (prompts of 128-1024 tokens, 32-64 new
               tokens; 8 up front, 8 once decoding has begun) through
               `ServingEngine` (page 16, one batch bucket of 16, 2048
               pages). Checks every request emits exactly its
               max_new_tokens with finite logits, that the paged-decode
               kernel ran once per layer per decode launch, and that all
               pages return after reset_prefix_cache().
  4. kernels — layer 0's caches, block tables and seq_lens captured from
               a live decode batch of phase 3 (plus a seq_len-0 pad row
               and a length ending mid-page) go through each kernel and
               its plain PyTorch version, in bf16 (tolerance 2e-2: output
               rounding, about 1 ulp at |x| <~ 2) and in fp32 on the
               same data cast up (1e-4: summation order); then each is
               timed with CUDA events (median of 30 launches, L2 flushed
               before each) beside its plain version, a PyTorch library
               call computing the same function, and its bound.
Then the `{"kernels": [...]}` line, the raw nvidia-smi line, and as the
last line `{"ok": true, "device": {...}}`. Any failure is an uncaught
exception: a nonzero exit and no ok line. Without a CUDA card it exits
with status 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# every CUDA kernel of the serving path: (name, source, TPU kernel it
# replaces)
KERNELS = [("paged_attention_decode",
            "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:113")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event device time of `fn` in ms. `flush` runs
    (untimed) before every launch so each one finds a cold L2, then a
    spin kernel of ~2.5 ms holds the stream while the host enqueues the
    start event and `fn`'s launches — so the interval between the
    events is device time, not the host's Python and launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_summary(prof, wall_s: float, decode_only: bool, tokens: int):
    """Device time of one profiled engine step: CUDA kernel events summed
    (one stream, so they do not overlap) and the kernels that took the
    most device time. The step's wall time under the profiler includes
    the profiler's start-up, so it is reported but not divided by."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    device_ms = sum(t for t, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"decode_only": decode_only, "tokens": tokens,
            "wall_ms_profiled": wall_s * 1e3, "device_ms": device_ms,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": k[:100], "ms": t / 1e3, "calls": n}
                            for k, (t, n) in top]}


def phase_serve(seed: int):
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_3_8b
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_3_8b(dtype="bfloat16")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServingEngine(model, page_size=16, num_pages=2048,
                        batch_buckets=[16], seed=seed)

    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=16)
    news = rng.randint(32, 65, size=16)
    prompts = [(rng.randint(0, cfg.vocab_size, int(n)).tolist(), int(m))
               for n, m in zip(lens, news)]

    torch.cuda.reset_peak_memory_stats()
    paged_attention_decode.launches = 0          # the main path starts
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts[:8]]
    late_added = False
    capture = None
    profiled = None
    steps = 0
    wall = {"prefill_steps_s": 0.0, "mixed_steps_s": 0.0,
            "decode_steps_s": 0.0}
    decode_only_tokens = decode_only_steps = 0
    t_serve = time.perf_counter()
    while eng.has_work():
        if not late_added and eng.scheduler.running:
            rids += [eng.add_request(p, max_new_tokens=m)
                     for p, m in prompts[8:]]
            late_added = True
        before = eng.metrics.counters["decode_launches"]
        chunks_before = eng.metrics.counters["prefill_chunks"]
        # the first step after the capture runs under torch.profiler; it
        # is reported on its own and left out of the wall sums
        profile_this = capture is not None and profiled is None
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile_this else contextlib.nullcontext())
        ts = time.perf_counter()
        with ctx as prof:
            emitted = eng.step()
        dt = time.perf_counter() - ts
        decoded = eng.metrics.counters["decode_launches"] > before
        chunked = eng.metrics.counters["prefill_chunks"] > chunks_before
        if profile_this:
            profiled = profile_summary(prof, dt, decoded and not chunked,
                                       len(emitted))
        elif decoded and not chunked:
            wall["decode_steps_s"] += dt
            decode_only_tokens += len(emitted)
            decode_only_steps += 1
        elif decoded:
            wall["mixed_steps_s"] += dt
        else:
            wall["prefill_steps_s"] += dt
        steps += 1
        if steps > 2000:
            raise RuntimeError("engine did not drain")
        running = eng.scheduler.running
        if (capture is None and late_added and decoded and not chunked
                and len(running) >= 8):
            capture = capture_batch(eng, running[:15])
    serve_s = time.perf_counter() - t_serve
    launches = paged_attention_decode.launches   # the main path ended
    c = eng.metrics.counters
    outs = {rid: eng.requests[rid].output_ids for rid in rids}
    for (_, m), rid in zip(prompts, rids):
        if len(outs[rid]) != m:
            raise AssertionError(f"request {rid} emitted {len(outs[rid])} "
                                 f"tokens, wanted {m}")
    if c["requests_quarantined"] or c["engine_failures"]:
        raise AssertionError(f"non-finite logits: {c}")
    if not (launches > 0 and launches == c["decode_launches"]
            * cfg.num_hidden_layers):
        raise AssertionError(f"paged_attention_decode launches {launches} "
                             f"!= decode launches {c['decode_launches']} "
                             f"x {cfg.num_hidden_layers} layers")
    if capture is None:
        raise AssertionError("no decode batch was captured")
    peak = torch.cuda.max_memory_allocated()
    step_ms = (wall["decode_steps_s"] / decode_only_steps * 1e3
               if decode_only_steps else None)
    if profiled is not None and step_ms:
        # device share of an unprofiled decode-only step: the profiled
        # step's device time over their mean wall time (the profiled
        # step's own wall includes the profiler's start-up)
        profiled["device_busy_share_vs_decode_step"] = \
            profiled["device_ms"] / step_ms
    eng.reset_prefix_cache()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"{eng.allocator.num_used} pages leaked")
    emit({"phase": "serve", "model": "llama_3_8b", "dtype": "bfloat16",
          "layers": cfg.num_hidden_layers, "params": n_params,
          "weights_build_s": build_s, "requests": len(rids),
          "steps": steps, "prefill_tokens": c["prefill_tokens"],
          "generated_tokens": sum(len(o) for o in outs.values()),
          "decode_launches": c["decode_launches"],
          "decode_tokens": c["decode_tokens"], "serve_s": serve_s, **wall,
          "decode_only_tokens": decode_only_tokens,
          "decode_only_steps": decode_only_steps,
          "decode_step_ms": step_ms,
          "decode_tokens_per_s": (decode_only_tokens
                                  / wall["decode_steps_s"]
                                  if wall["decode_steps_s"] else None),
          "paged_attention_decode_launches": launches,
          "profiled_step": profiled,
          "max_memory_allocated": peak,
          "pages_used_after_reset": eng.allocator.num_used})
    return {"paged_attention_decode": launches}, capture


def capture_batch(eng, reqs):
    """Layer 0's caches and a decode batch's block tables / seq_lens,
    padded with one seq_len-0 row to the batch bucket."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.engine import _bucket_for
    B = eng.batch_buckets[-1]
    P = _bucket_for(max(len(r.seq.pages) for r in reqs), eng.pages_buckets)
    bt = np.zeros((B, P), np.int32)
    bt[:len(reqs)] = eng.allocator.block_table([r.seq for r in reqs], P)
    sl = np.zeros((B,), np.int32)
    sl[:len(reqs)] = [r.seq.num_tokens for r in reqs]
    if not np.any(sl[:len(reqs)] % eng.page_size):
        sl[0] -= 1                  # make one length end mid-page
    k, v = eng.kv_caches[0]
    return {"k": k.clone(), "v": v.clone(),
            "bt": torch.from_numpy(bt).cuda(),
            "sl": torch.from_numpy(sl).cuda(),
            "heads": eng.num_heads}


def phase_kernels(capture, launches, seed: int, card: str):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_attention_decode_ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    k, v, bt, sl = capture["k"], capture["v"], capture["bt"], capture["sl"]
    B, H = bt.shape[0], capture["heads"]
    _, KVH, page, D = k.shape
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)

    errs = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        args = (q.to(dt), k.to(dt), v.to(dt), bt, sl)
        got = paged_attention_decode(*args)
        torch.cuda.synchronize()
        want = paged_attention_decode_ref(*args)
        err = (got.float() - want.float()).abs().max().item()
        pad = int((sl == 0).nonzero()[0, 0])
        if not (err <= tol and torch.isfinite(got).all()
                and torch.all(got[pad] == 0)):
            raise AssertionError(f"paged_attention_decode {dt}: max abs "
                                 f"err {err} > {tol} or pad row not zero")
        errs[str(dt).replace("torch.", "")] = err
    emit({"phase": "kernel_check", "kernel": "paged_attention_decode",
          "batch": B, "seq_lens": sl.tolist(), "max_abs_err": errs,
          "tolerance": {"bfloat16": 2e-2, "float32": 1e-4}})

    # timing at the main path's dtype (bf16)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    args = (q, k, v, bt, sl)
    kernel_ms = time_ms(lambda: paged_attention_decode(*args),
                        flush_buf.zero_)
    plain_ms = time_ms(lambda: paged_attention_decode_ref(*args),
                       flush_buf.zero_)
    # library yardstick: SDPA with GQA over the same KV pre-gathered
    # contiguous (the gather is not timed); never called by the port
    idx = bt.long()
    kd = k[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, -1, D)
    vd = v[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, -1, D)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < sl[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True), flush_buf.zero_)

    live = int(sl.sum())
    elem = q.element_size()
    nbytes = (2 * live * KVH * D * elem          # live K + V, read once
              + 2 * B * H * D * elem             # q in, out
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * live * (H // KVH) * KVH * D      # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    name, source, replaces = KERNELS[0]
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs["bfloat16"],
             "max_abs_err_fp32": errs["float32"],
             "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "library_ms": library_ms,
             "library": "torch.nn.functional.scaled_dot_product_attention"
                        "(enable_gqa=True), KV pre-gathered",
             "shape": {"B": B, "H": H, "KVH": KVH, "D": D, "page": page,
                       "max_pages": bt.shape[1], "live_tokens": live,
                       "dtype": "bfloat16"},
             "bytes": nbytes, "flops": flops, "card": card}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build

    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_source = build.build(src.rsplit("/", 1)[1] for _, src, _ in KERNELS)
    reports = {}
    for _, src, _ in KERNELS:
        log = build.library_path(src.rsplit("/", 1)[1])
        log = log.with_name(log.name + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(x.split("Used ")[1].split()[0]) for x in lines
                if "Used " in x and " registers" in x]
        spills = [int(x.split("bytes spill stores")[0].split(",")[-1])
                  for x in lines if "bytes spill stores" in x]
        reports[src] = {"kernels": len(regs),
                        "max_registers": max(regs) if regs else None,
                        "max_spill_store_bytes": max(spills) if spills
                        else None}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": reports})

    launches, capture = phase_serve(args.seed)
    kernels = phase_kernels(capture, launches, args.seed, card)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
