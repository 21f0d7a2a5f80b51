#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the repository root on a machine with one CUDA card (an H100;
the kernels build for sm_90a):

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  1. device  — the card (`nvidia-smi` name and power limit), torch/CUDA.
  2. build   — compiles every CUDA kernel of the serving, training and
               packed-attention paths and rms_norm_rows from the
               repository's sources (one nvcc per source, in parallel);
               reports each source's ptxas registers and spills, naming
               the functions that spill, and each wgmma kernel's
               registers and spill bytes.
  3. serve   — builds Llama-3-8B (`llama_3_8b`, all 32 layers, bf16)
               from seeded random weights on the card and serves 16
               greedy requests (prompts of 128-1024 tokens, 32-64 new
               tokens; 8 up front, 8 once decoding has begun) through
               `ServingEngine` (page 16, one batch bucket of 16, 2048
               pages). Checks every request emits exactly its
               max_new_tokens with finite logits, that the paged-decode
               kernel ran once per layer per decode launch, and that all
               pages return after reset_prefix_cache().
  3a. serve_multi — on the same bf16 model object, the same 16 requests,
               schedule and grid with `decode_steps=4`: each launch runs
               4 decode steps (sampling and the freeze masks on the
               card) under torch.cuda.set_sync_debug_mode("error"), so
               a host sync inside its K steps fails the phase. Checks
               as in phase 3, and that the paged-decode launches counted
               in the wrapper equal 32 layers x the K-loop iterations the
               engine counted (decode_launch_steps). Reports decode
               tokens/s and wall ms per launch and per token beside
               phase 3's, and how many requests' tokens equal phase 3's
               (bf16: not gated).
  3b. serve_spec — two drains of the same 16 requests with spec_k=4:
               (a) NgramProposer; (b) DraftModelProposer with the served
               model as its own draft (its own 1536-page pool, 3.2 GB).
               Checks verify launches ran, every request completes, both
               pools end empty; in (b) drafts accepted, more than one
               token a verify step, the draft's decode through the paged
               kernel (counted). Reports acceptance, tokens a verify
               step, verify ms a launch, agreement with phase 3 and, in
               (b), the first rejected draft's logit margin.
  3c. serve_resume — the 16 requests up front, stepped until one decodes
               while another is mid-prefill; snapshot(), a json round
               trip, vacate(), then ServingEngine.from_snapshot on the
               same model and grid, drained. Checks every request
               completes under its original id with its token count and
               both engines end with zero pages; reports agreement with
               phase 3.
  3d. trace  — one serve drain with trace=True: every request's trace
               holds its admission, prefill span(s), one decode span per
               token after the first and its finish; export() writes
               build/serve_trace.json, which json.load reads.
               Reports the decode-step wall beside phase 3's.
  3f. serve_spill — the host spill tier on the same model: a seeded
               512-token shared prefix + 8 seeded 512-token tails, 8 new
               tokens, two passes one request at a time, through a
               device pool of 128 usable pages (the working set is ~290)
               with one batch (1), prefill (1024) and pages (72) bucket:
               spill off, spill on (host pool 512 pages), spill off and
               on with int8 KV, and spill on with one host_spill.corrupt
               fault (pass 1 and the first pass-2 request). Checks spill-on tokens == spill-off tokens (bf16,
               int8, and through the corrupt page, counted once), pages
               demoted, promoted and host hits > 0 with no eviction on
               the drop rung, cached + prefilled tokens conserved, both
               pools empty after reset_prefix_cache, and the paged kernel
               (bf16 or int8) once per layer per decode launch. Reports
               per-page demote and promote costs (host and, from CUDA
               events, device), the codec's encode and decode ms a page,
               host-to-device and device-to-host GB/s, a 32-page tail's
               promotion against a 512-token recompute chunk, pass-2
               TTFT with spill on and off, and the prefill tokens saved.
  3g. fleet  — two replicas of the same model (1024 pages each, pinned
               buckets) behind PrefixAffinityRouter take serve's 16
               prompts; `fleet.replica_crash` kills replica-0 mid-run.
               Checks every request completes with its token count, none
               lost, each stream saw each token once and the tokens
               before the crash are a prefix of the final ones, every
               pool empty at the end; a prefix pull (the crashed
               replica's vacated engine adopts what the survivor exports
               for a prompt it served start to end: adopted == exported
               pages, one prefix hit, its tokens == the survivor's
               batched fleet run == the survivor serving it alone); a
               prefill-role engine's hand-off (reason "handoff", a
               page-aligned span), resumed on the survivor; FleetServer +
               HttpFrontend on 127.0.0.1: two SSE streams equal to their
               handles' tokens, one JSON request, /healthz 200, /metrics
               naming the serving counters; the paged kernel once per
               layer per decode launch of every engine. Reports
               migrations, the drain wall and agreement with phase 3
               (not gated).
  3h. proc_fleet — the cross-process fleet: two worker processes on the
               card, p0 (role prefill) and d0 (role decode), each
               building the same model from the seed (1024 pages,
               FLEET_KW's buckets), behind `ProcessFleet` (a TCPStore
               mailbox on 127.0.0.1). Run 1: serve's prompts 0-7, 32 new
               tokens: prefilled on p0, KV pages relayed to d0, decoded
               there by the paged kernel. Run 2: prompts 8-15; d0 is
               SIGKILLed once it has emitted a token, its requests re-land
               on p0 from its last heartbeat snapshot; d0 respawns.
               Checks every stream of both runs bitwise equal to one
               in-process drain of all 16 on the same grid, none lost, no
               funnel conflict, 8 hand-offs completed in run 1 with the
               donated pages shipped, both pools empty, each worker's
               paged launches 32 x its decode launches, no kernel rebuilt
               by a worker, exits 0 (the killed one -9). Reports worker
               start seconds, hand-off ms and relay MB/s, TTFT and drain
               wall of each run, the longest heartbeat gap, migrations
               and the card's peak memory (all processes).
  3i. serve_tp — tensor-parallel serving: TP_DEGREE (2) rank processes
               started by the port's `spawn` (NCCL with a card per rank,
               rank r on cuda:r; with one card both ranks on cuda:0 over
               gloo), each running `ServingEngine(mesh=tp_serving_mesh(2))`
               over its own shard; the parent's model is freed first
               (after serve_quant). fp32: a small model (head_dim 64,
               pinned buckets) at tp 1 and tp 2 on each rank: greedy
               tokens equal. bf16: serve's model, weights, grid and 16
               requests on serve's schedule: both ranks emit identical
               tokens, each rank's paged-decode launches == 32 x its
               decode launches at H 16 / KVH 4. int8 (`wq="int8",
               kv_dtype="int8"`, serve's first 8 requests, int8 pages in
               half of serve's pool bytes a rank): tokens equal on both
               ranks, the int8 paged kernel 32 x a decode launch at KVH
               4, the int8 matmul on the kernel `quant_matmul_route`
               names at the shard widths (gate/up N 7168, down K 7168,
               head N 64128; decode rows and each prefill bucket), held
               to the flight recorder. Rank 0's layer-0 caches of a live
               decode batch of each run are held to the plain version
               (bf16 and fp32 queries) and timed. Reports the backend,
               card count and each rank's device, decode tokens/s, each
               rank's peak memory, the all_reduce share of a profiled
               decode step and agreement with phase 3's tokens (bf16:
               the row-parallel sums round differently; not gated). Two
               ranks over gloo on one card measure correctness, not TP
               speed. A rank that fails, times out or diverges (the
               engine compares a fingerprint of every step across the
               ranks) fails the phase.
  3e. generate — `LlamaForCausalLM.generate` on the same bf16 model: 4
               prompts of 512 tokens (the first 512 of the first 4 serve
               prompts that long), 32 new tokens; greedy eager, greedy
               use_jit=True (the preallocated cache written in place),
               and a sampled run (temperature 0.8, top_p 0.9, seed 0)
               twice. Checks that every forward pass launched the wgmma
               flash forward once per layer (the prefill causal at Sq =
               Sk = 512, each decode step at Sq 1 against the cache) and
               nothing else attended (no varlen, flashmask, paged or
               `sdpa_ref` call), use_jit tokens == eager, the two sampled
               runs bitwise equal, tokens in the vocabulary, finite
               logits, and a full forward over each returned sequence
               within a relative error of 5e-2 of the logits generate
               used. Reports prefill ms, decode-step ms, tokens/s, peak
               memory and where each row's greedy tokens first leave a
               ServingEngine drain of the same prompts (not gated).
  4. serve_lora — on the same bf16 model object, multi-LoRA serving: an
               `AdapterRegistry` (rank buckets 8 and 16, 4 slots each,
               all 7 target modules) holding a1 (rank 8), a2 (rank 16)
               and a3 (rank 16, int8 payload), seeded; the same 16
               requests on the same schedule, tagged round-robin a1, a2,
               a3, base. Checks as in phase 3, plus the LoRA kernel
               (lora_apply: every rank bucket and the y + delta
               epilogue) once per (module x layer) per launch, decode
               launches that mix adapters
               (adapter_mix p50 > 1), every adapter's refs back to 0 and
               the registry's invariants. Reports decode tokens/s and
               step walls beside phase 3's, and whether the base rows'
               tokens equal phase 3's.
  5. serve_quant — on the same model object, `ServingEngine(wq="int8",
               kv_dtype="int8")`: the MLP and LM-head weights are
               quantized in place to int8, the KV pages are int8 with
               fp32 scales in the byte budget of phase 3's pool (3971
               pages, as `paged_page_bytes` predicts), and the same 16
               requests are served on the same schedule. Checks as in
               phase 3, plus the int8 paged-decode kernel once per layer
               per decode launch and the int8 matmul kernels 97 times per
               launch (gate/up/down x 32 and the head), each launch on
               the kernel `quant_matmul_route` names, counted per kernel
               and held to the engine's flight recorder: every prefill
               chunk's MLP linears through the wgmma route
               (quant_matmul_sm90.cu) at its bucket's rows, every bf16
               launch of at most 16 rows — the decode launches and the
               head's single row at each chunk's end — through the decode
               weight stream (quant_decode_sm90.cu), none through
               quant_matmul.cu; the profiled decode-only step launches
               the int8 matmul 97 times and `reduce_splits` never.
               Reports the
               weight bytes before and after, and where each request's
               greedy tokens first leave phase 3's (not gated: random
               weights give near-flat logits).
  6. train   — the serving model is freed; Llama-3-8B at its published
               widths with depth cut 32 -> 8 layers (bf16, seeded random
               weights) trains on one seeded batch of 1 x 4096 tokens
               with AdamW(3e-4, multi_precision, fused, bf16 moments):
               2 warm-up steps (the second under torch.profiler, split by
               kernel kind) and 4 timed ones. Checks every loss is
               finite and the last below the first, and that each step
               launched the flash forward, dQ and dK/dV kernels once per
               layer, every one the wgmma kernel of flash_fwd_sm90.cu or
               flash_bwd_sm90.cu, and the AdamW kernel once per bucket.
               Reports step ms, tokens/s, MFU (bench.py's FLOP reckoning
               over 989 TFLOP/s) and peak memory.
  6b. train_loop — the AdamW kernel's check on the train phase's bucket
               runs first (phase 8's row), so the bucket is freed; then
               the train phase's configuration again with recompute=True
               (one checkpoint per decoder layer): one forward + backward
               without and with recompute from the same weights (loss
               and pre-clip gradient norm within 1e-3, the peak memory
               of each, recompute's lower), then AdamW with
               LinearWarmup(CosineAnnealingDecay(3e-4, T_max=6), 2 warm-up
               steps), ClipGradByGlobalNorm(1.0) and lr_ratio 0.5 for the
               embedding and the head (two fused buckets), 2 warm-up and
               4 timed steps. Checks every step: the flash forward 16
               times (8 + 8 replays), dQ and dK/dV 8 times, all on the
               wgmma kernels; AdamW once per bucket, each bucket's lr the
               schedule's times its ratio; the clipped gradients' global
               norm <= 1.0 within 1e-2; finite losses, the last below the
               first. Reports step ms (less the phase's norm observer),
               tokens/s, MFU as the train phase counts it (the replay is
               not useful work) and peak memory.
  6c. train_moe — the train_loop model freed; Qwen2-57B-A14B
               (`qwen2_moe_a14b`: hidden 3584, 28 heads over 4 KV heads,
               qkv bias, 64 routed experts of 2560 with top-8 and capacity
               factor 2, a 20480-wide shared expert with its sigmoid gate,
               vocab 151936) at its published widths with depth cut 28 ->
               1 (3.10e9 parameters; see MOE_LAYERS), bf16, seeded random
               weights, on the train phase's batch, optimizer and steps
               (the second warm-up step profiled). Checks finite losses,
               the last below the first; each step the flash forward, dQ
               and dK/dV once per layer on the wgmma kernels (B*H 28, the
               KV heads repeated 7x) and the AdamW kernel once per
               bucket; every parameter equal to its slice of the fp32
               master bucket rounded to bf16 (the packing past 2**31
               elements); the first step's bf16 gates routed on the card
               and on the CPU bitwise equal (slot tokens and weights, each
               token's slots, counts, the dispatched slab), at the step's
               capacity and at a quarter of it, where experts overflow
               (some assignment must drop there); one MoELayer
               forward + backward on the captured input under
               torch.cuda.set_sync_debug_mode("error"); two combines of
               the same inputs bitwise equal. Reports step ms, tokens/s,
               MFU over the active work (each token's top-8 experts, the
               shared expert, attention, the head: `moe_step_flops`) and
               the executed capacity slots' share, peak memory, the share
               of assignments dropped by capacity and the profiled step's
               device time by kind. Then, the model freed, its AdamW
               bucket (3.10e9 elements) goes through `check_moe_adamw`:
               the kernel bitwise against its plain version chunk by
               chunk, and timed (the fused_adamw row's
               `train_moe_buckets`).
  7. packed_attention — Llama-3-8B's attention widths (32 heads, the 8
               KV heads repeated, head_dim 128, bf16) over one packed row
               of 8192 tokens, seeded documents of 128-2048 tokens (the
               last cut to fit), forward + backward (autograd.grad of
               <out, dout>) through flash_attn_unpadded (causal),
               flash_attn_varlen_qkvpacked, flashmask_attention with the
               causal document mask (C 1) and with window_size=1024: 2
               warm-up and 4 timed calls each. Checks every call launched
               its variant's fwd, dQ and dK/dV kernels once (every one
               on the wgmma kernels: the forward of flash_fwd_sm90.cu,
               dQ and dK/dV of flash_bwd_sm90.cu), finite
               outputs and gradients, one document's change leaving every
               other row of outputs and gradients bitwise unchanged, the
               varlen and document-mask entries within flash_error's bf16
               limit, one whole-row document against the causal flash
               kernel, and the tile pairs each kernel counts as visited
               (a counted launch on each entry's masks) against the plain
               predicate `flash_visits_ref`. Reports ms per fwd + bwd,
               TFLOP/s over the allowed (q, k) pairs, those tiles over
               the grid's, peak memory and one profiled call's device
               time by kind.
  8. kernels — every kernel against its plain PyTorch version on the same
               inputs, then timed with CUDA events (median of 30
               launches, L2 flushed before each) beside its plain
               version, a PyTorch library call computing the same
               function, and its bound:
               * paged decode: seeded batches (`check_paged_kernels`) —
                 the serve shape, one request at 32768 tokens over the
                 widest table (2048 pages) and four at 8192, a batch of
                 split edges (one token, a length ending mid-page, on a
                 split boundary, one past it, the full table, rows whose
                 trailing splits are empty), G 1, 2, 8, D 64, 192, 256,
                 pages 8-32 — bf16 (tolerance 2e-2: output rounding,
                 about 1 ulp at |x| <~ 2), fp32 on the same data (1e-4:
                 summation order) and int8 caches with both query types,
                 pad rows exactly 0, a second launch bitwise equal;
                 then layer 0's caches, block tables and seq_lens
                 captured from a live decode batch of phase 3 (plus a
                 seq_len-0 pad row and a length ending mid-page), bf16
                 and fp32; timed at the live batch and at the two
                 long-context shapes (`long_context`, no main path runs
                 them);
               * flash fwd / dQ / dK/dV: the training shape (B*H 32,
                 S 4096, D 128, causal; seeded), train_moe's (B*H 28,
                 timed too: each row's `train_moe_shape`) and small
                 ragged ones
                 (S not a tile multiple, D 64 and 40, Sq < Sk and
                 Sq > Sk, causal and not, causal rows that see no key,
                 Sq not a multiple of 4)
                 — bf16 on the wgmma kernels (flash_fwd_sm90.cu,
                 flash_bwd_sm90.cu), fp32 on flash_attention.cu; bf16
                 outputs within a relative error ||got - ref|| / ||ref||
                 of 1e-2, fp32 outputs within 1e-4 of the reference's
                 largest value, the fp32 lse within 1e-4 in both types
                 (`flash_error`), the dQ rows of queries that see no key
                 exactly zero (chip_fault_check.py shows that a kernel
                 with a planted fault fails these checks);
               * the flash forward at generate's decode shape (B*H 128,
                 Sq 1, D 128, bf16, not causal) at cache lengths 1, 7,
                 64, 513, 544 and 1025 within flash_error's limits, timed
                 at 513 and 544 beside SDPA on the same q, k, v and its
                 byte bound (the K/V read);
               * fused AdamW: the train phase's own bucket (fp32 master,
                 bf16 moments, ~2.8e9 elements) with a seeded bf16
                 gradient, and fp32 state on a slice of it: bitwise;
                 train_moe's bucket (~3.10e9 elements) too, in phase 6c;
               * int8 paged decode: layer 0 of a live serve_quant decode
                 batch (int8 caches and scales, plus a pad row and a
                 length ending mid-page) with bf16 and fp32 queries,
                 tolerances as for the full-width kernel
                 (`check_quant_kernels`); timed there and at the
                 long-context shapes;
               * int8 matmul: seeded x and `weight_quantize`d seeded
                 weights at Llama-3-8B's decode GEMMs (M 16, the decode
                 stream) and the head's prefill row (M 1), gate/up and
                 down at M 512 (the wgmma route), a ragged shape on each
                 Hopper route and one TMA cannot address
                 (quant_matmul.cu), bf16 within a relative error of 1e-2
                 (the decode stream also bitwise equal on a repeat
                 launch, its ticket counters back at 0) and fp32 within
                 1e-4 of max |ref| (chip_fault_check.py shows that
                 planted faults in the quantized kernels fail these
                 checks); timed as three rows: the decode stream in bf16
                 at M 16 and 1 (also after an L2 flush that leaves no
                 dirty lines, beside one PyTorch read of the same weight
                 bytes), the wgmma route at M 512 and at each prefill
                 bucket serve_quant launched, and quant_matmul.cu with
                 fp32 x at M 16 (its route; 0 launches on the main path);
               * LoRA (lora_apply): layer 0's gate_proj input and
                 output, row slots and both rank buckets' gathered
                 stacks of a live serve_lora decode launch, a 512-token
                 prefill chunk of one request, its rows as 512 decode
                 rows over every slot, and a ragged shape (H 1100, N 72,
                 ranks 5 and 3), bf16 and fp32 x: the delta-only output
                 within 1e-5 of max |ref| (fp32 products either way),
                 the fused output (bf16 and fp32 y) bitwise y +
                 delta.to(y.dtype) of the kernel's own delta, null rows
                 exactly y + 0.0, each row bitwise unchanged when the
                 other rows' slots change, a repeat launch bitwise
                 equal (`check_lora_kernels`; chip_fault_check.py plants
                 four faults); timed at the decode capture and the
                 prefill chunk beside the plain version, the library
                 composition (gathered bmm per bucket, the fp32 sum,
                 the cast and the add) and the bound, and over cluster
                 sizes x column clusters;
               * the flash kernels' segment and flashmask modes: the
                 packed row at full width as segments, as the causal
                 document mask and as the window (plain versions over
                 head groups of 8), and small ragged cases — varlen with
                 uneven q/k lengths (Sq 100, Sk 148, D 64), flashmask
                 causal C 2, non-causal C 2 and C 4, per-head bounds — in
                 bf16 and fp32 with flash_error's limits, each kernel's
                 count of visited tile pairs equal to the plain
                 predicate's (`check_packed_kernels`: bf16 on the
                 wgmma kernels of flash_fwd_sm90.cu and
                 flash_bwd_sm90.cu, fp32 on flash_attention.cu); timed
                 at full
                 width (tile summaries prebuilt, as the autograd
                 Functions pass them) beside SDPA with the equivalent
                 dense boolean mask and the bound of the allowed pairs;
               * rms_norm_rows at (4096, 4096), (16, 4096) and (7, 1100),
                 bf16 and fp32, with an fp32 weight and one in x's dtype,
                 with and without a residual: bf16 within one bf16 ulp,
                 fp32 within 1e-5 relative
                 (`check_norm_kernel`); timed beside
                 torch.nn.functional.rms_norm and its byte bound (no
                 main path calls it: 0 launches).
Then the `{"kernels": [...]}` line (each row's `launches` its main
path's count; the flash and AdamW rows also `launches_by_phase` for
train, train_loop, train_moe and generate, the paged-decode row for
serve, serve_multi, serve_spec, serve_spill, fleet, proc_fleet (the
workers' stats: d0 at the end of run 1, p0 at the end) and serve_tp
(each rank's), the int8 row for serve_quant, serve_spill and serve_tp,
the int8 matmul's decode and prefill rows for serve_quant and serve_tp;
the paged rows' `tp_shard` and the int8 matmul rows' `shapes` hold the
rank shards' checks and times), the raw nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`. Any failure is an uncaught
exception: a nonzero exit and no ok line. Without a CUDA card it exits
with status 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# every CUDA kernel of the serving and training paths: (name, source,
# TPU kernel it replaces)
_CSRC = "paddle_tpu_torch/kernels/csrc/"
KERNELS = [("paged_attention_decode", _CSRC + "paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:113"),
           ("flash_attention_fwd", _CSRC + "flash_fwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:179"),
           ("flash_attention_dq", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:333"),
           ("flash_attention_dkv", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:386"),
           ("fused_adamw", _CSRC + "fused_adamw.cu",
            "paddle_tpu/kernels/fused_optimizer.py:180"),
           ("paged_attention_decode_int8", _CSRC + "paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:152"),
           ("quant_matmul", _CSRC + "quant_matmul.cu",
            "paddle_tpu/kernels/quant_matmul.py:162"),
           ("quant_matmul_decode", _CSRC + "quant_decode_sm90.cu",
            "paddle_tpu/kernels/quant_matmul.py:162"),
           ("quant_matmul_prefill", _CSRC + "quant_matmul_sm90.cu",
            "paddle_tpu/kernels/quant_matmul.py:162"),
           ("lora_apply", _CSRC + "lora_matmul.cu",
            "paddle_tpu/kernels/lora_matmul.py:176"),
           ("flash_attention_varlen_fwd", _CSRC + "flash_fwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:179"),
           ("flash_attention_varlen_dq", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:333"),
           ("flash_attention_varlen_dkv", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:386"),
           ("flashmask_attention_fwd", _CSRC + "flash_fwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:179"),
           ("flashmask_attention_dq", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:333"),
           ("flashmask_attention_dkv", _CSRC + "flash_bwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:386"),
           ("rms_norm_rows", _CSRC + "fused_norm.cu",
            "paddle_tpu/kernels/fused_norm.py:36"),
           ("flash_attention_fwd_decode", _CSRC + "flash_fwd_sm90.cu",
            "paddle_tpu/kernels/flash_attention.py:179")]
KERNEL = {name: (name, src, replaces) for name, src, replaces in KERNELS}
# flash_attention.cu also holds the fp32 and head_dim > 128 routes of all
# three flash kernels; the wgmma sources share csrc/hopper.cuh, the three
# flash sources csrc/flash_mask.cuh, the two wgmma flash sources the masked
# walk of csrc/flash_walk.cuh
SOURCES = sorted({src for _, src, _ in KERNELS})
# the design of each kernel of the redesigned routes, for the kernels line
DESIGN = {
    "paged_attention_decode": "split-KV on the card: grid (KVH, chunks + "
                              "B), every block splitting the batch from "
                              "seq_lens, each row by its own length and the "
                              "launch's shapes alone; a producer warp keeping a ring "
                              "of 64-token stages full by 1-D bulk copies "
                              "(mbarriers); 4 consumer warps, each an online "
                              "softmax over 16 tokens a stage, S = Q K^T and "
                              "O^T = V^T P^T on mma.sync m16n8k16 (P as bf16 "
                              "hi + lo); the last block of each (row, KV "
                              "head) merging the splits in order (ticket "
                              "counter)",
    "flash_attention_fwd": "sm90: TMA ring of 128-key K/V tiles (2 stages, "
                           "mbarriers), wgmma m64n128k16 SS for QK^T and RS "
                           "for PV (P in registers), 2 consumer warpgroups "
                           "of 64 rows + 1 producer",
    "flash_attention_fwd_decode": "the plain sm90 forward at one query row "
                                  "(generate's decode step): a block of 128 "
                                  "query rows, 127 of them past Sq, streams "
                                  "the head's K/V through the 128-key TMA "
                                  "ring",
    "flash_attention_dq": "sm90: 128 query rows a block, Q and dO once, a "
                          "TMA ring of 64-key K/V tiles (3 stages, "
                          "mbarriers), wgmma m64n64k16 SS for S and dP, dS "
                          "in registers as the RS A operand of dQ += dS K (K "
                          "MN-major), 2 consumer warpgroups of 64 rows + 1 "
                          "producer",
    "flash_attention_dkv": "sm90: 128 keys a block, K and V once, a TMA ring "
                           "of 64-query Q/dO tiles with their lse/delta (3 "
                           "stages, mbarriers), wgmma SS for S^T and dP^T, "
                           "P^T and dS^T in registers as the RS A operands of "
                           "dV += P^T dO and dK += dS^T Q, 2 consumer "
                           "warpgroups of 64 keys, thread 0 issuing the "
                           "loads",
    "flash_attention_varlen_fwd": "sm90, segment mode: the plain forward's "
                                  "block (128 query rows, a producer "
                                  "warpgroup) over a 4-stage TMA ring of "
                                  "64-key K/V tiles, walked as the masked dQ "
                                  "walks them (flash_walk.cuh; the same "
                                  "grid): the ring carries the key tiles "
                                  "either warpgroup computes, each with its "
                                  "(id, position) rows as 1-D TMA boxes; "
                                  "wgmma m64n64k16 SS for S, the online "
                                  "softmax and the branch-free mask on the "
                                  "accumulator, skipped on pairs the "
                                  "summaries show whole, P in registers as "
                                  "the RS A operand of O += P V, issued "
                                  "after the next tile's S",
    "flashmask_attention_fwd": "sm90, flashmask mode: as the segment "
                               "forward, the key tiles' C bound rows riding "
                               "in the stage",
    "flash_attention_varlen_dq": "sm90, segment mode: the plain dQ's block "
                                 "and ring; before the roles split every "
                                 "warp ballots the skip predicate for 32 key "
                                 "tiles at once per warpgroup, the ring "
                                 "carries the tiles either warpgroup "
                                 "computes, each with its (id, position) "
                                 "rows as 1-D TMA boxes; the mask "
                                 "branch-free on the accumulators, skipped "
                                 "on pairs the summaries show whole",
    "flash_attention_varlen_dkv": "sm90, segment mode: the plain dK/dV's "
                                  "block and ring over the listed query "
                                  "tiles, their (id, position) rows riding "
                                  "with Q and lse; thread 0 walking the "
                                  "list as it refills",
    "flashmask_attention_dq": "sm90, flashmask mode: as the segment dQ, the "
                              "key tiles' C bound rows riding in the stage",
    "flashmask_attention_dkv": "sm90, flashmask mode: as the segment dK/dV, "
                               "the block's C x 128 key bounds loaded once "
                               "with K and V",
    "quant_matmul_prefill": "sm90: TMA ring of x and int8 W tiles (4 stages, "
                            "mbarriers), wgmma RS on out^T = W^T x^T with "
                            "W^T converted to bf16 in registers, 2 consumer "
                            "warpgroups of 64 columns + 1 producer",
    "quant_matmul_decode": "one balanced launch: units of 64 K rows x 256 "
                           "columns split evenly over one CTA an SM; a "
                           "producer warp keeping a TMA ring of 4 units "
                           "(two swizzled int8 W boxes + the x slice, "
                           "mbarriers); 8 consumer warps, each 32 columns "
                           "over the unit's K, on mma.sync m16n8k16 for "
                           "out^T = W^T x^T, W converted to bf16 in "
                           "registers; a column tile shared by CTAs merged "
                           "in K order by the last to arrive (ticket "
                           "counter)",
    "quant_matmul": "fp32 x and shapes TMA cannot address: mma.sync / FMA "
                    "tiles (16 x 128 at M <= 16, K splits summed by a second "
                    "launch), quant_matmul.cu",
    "lora_apply": "one launch per projection: rows grouped by (bucket, "
                  "slot) on the card into units of up to 64 rows; a "
                  "thread-block cluster of C CTAs splits H (a ring of x "
                  "and A by bulk copies, cp.async where unaligned; fp32 "
                  "FMAs), the partials summed in CTA order over "
                  "distributed shared memory, each CTA expanding its "
                  "slice of N from B and y staged in shared memory "
                  "where they fit, writing y + delta",
}
# the train phase: Llama-3-8B widths, depth cut to fit one card
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 1, 4096
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LR = 2, 4, 3e-4
# train_loop: the train phase's model and batch under recompute, with a
# warm-up + cosine schedule, the global-norm clip and half the lr for the
# embedding and the head (two AdamW buckets)
LOOP_WARMUP_STEPS, LOOP_T_MAX, LOOP_CLIP, LOOP_RATIO = 2, 6, 1.0, 0.5
# generate: the serve model, 4 prompts of 512 tokens cut from the serve
# phase's prompts, 32 new tokens; the sampled runs' settings
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 32
GEN_TEMPERATURE, GEN_TOP_P, GEN_SEED = 0.8, 0.9, 0
GEN_LOGIT_LIMIT = 5e-2
# the flash forward at generate's decode shape: B*H 128 (4 x 32 heads),
# one query row, D 128; checked at these cache lengths and timed at the
# first and last decode step's
DECODE_BH, DECODE_D = GEN_BATCH * 32, 128
DECODE_CHECK_SK = (1, 7, 64, GEN_PROMPT + 1, GEN_PROMPT + GEN_NEW, 1025)
DECODE_TIME_SK = (GEN_PROMPT + 1, GEN_PROMPT + GEN_NEW)
# flash kernel checks (B*H, Sq, Sk, D, causal): the training shape, and
# ragged ones: S not a tile multiple with D 64 and Sq < Sk; Sq > Sk, whose
# first 70 query rows see no key under causal; non-causal Sq > Sk, Sq < Sk
# at D 40 (below the instantiated width), and Sq not a multiple of 4
FLASH_SHAPES = ((32, TRAIN_SEQ, TRAIN_SEQ, 128, True), (3, 72, 136, 64, True),
                (2, 200, 130, 128, True), (2, 136, 64, 128, False),
                (2, 96, 200, 40, False), (2, 130, 130, 64, True),
                (28, TRAIN_SEQ, TRAIN_SEQ, 128, True))
# train_moe: Qwen2-57B-A14B (hidden 3584, 28 heads over 4 KV heads, head_dim
# 128, 64 experts of 2560 and top-8, a 20480-wide shared expert, vocab
# 151936) with depth cut 28 -> 1 on the train phase's batch and optimizer.
# Reckoned from the code, not measured: a layer holds 2.011e9 parameters
# (attention 29.4M, routed experts 1761.6M, shared expert 220.2M), the
# embedding and the head 0.545e9 each: 3.10e9 in all, 37.2 GB at 12 B a
# parameter (bf16 param and grad, fp32 master, bf16 m and v), 6.2 GB more
# for the packed gradient bucket, ~10 GB of activations at 1 x 4096 tokens
# (the logits and their fp32 log-softmax and gradient, the (64, 1024, 3584)
# dispatched slab, the experts' (65536, 2560) intermediates): ~55 GB. A
# second layer adds ~24 GB, too much for an 80 GB card
MOE_LAYERS = 1
ADAMW_CHUNK_ROWS = 2 ** 20    # the AdamW checks' chunk: 2**27 elements
# the serve phase's bf16 pool; serve_quant gets the same bytes of int8
# pages
SERVE_PAGES = 2048
# serve_multi's decode steps a launch; serve_spec's drafts a step and its
# draft model's pool (2 MB a page at Llama-3-8B's widths: 3.2 GB beside
# the 4.3 GB serve pool); the trace phase's Chrome export
SERVE_K, SPEC_K, DRAFT_PAGES = 4, 4, 1536
TRACE_PATH = os.path.join("build", "serve_trace.json")
# serve_spill: a seeded shared prefix and 8 seeded tails (page-aligned),
# 8 new tokens each, two passes one request at a time, through a device
# pool far below the ~290-page working set and a host pool above it; one
# batch, prefill and pages bucket, so spill on and off launch the same
# shapes (token budget 1024: a 32-page tail's promotion fits its budget).
# A promotion takes free pages only (the reference's rule: it never
# evicts for a maybe-hit), and between requests this workload leaves
# usable pages - 96 free: 128 usable pages (129 with the pad page) leave
# the 32 a tail needs
SPILL_PREFIX, SPILL_TAIL, SPILL_TAILS, SPILL_NEW = 512, 512, 8, 8
SPILL_PAGES, SPILL_HOST = 129, 512
SPILL_KW = dict(page_size=16, num_pages=SPILL_PAGES, token_budget=1024,
                batch_buckets=[1], prefill_buckets=[1024],
                pages_buckets=[72])
# fleet: two replicas of serve's model, 1024 pages each, pinned buckets
# (serve's batch of 16, chunks of 512, 72-page tables); replica-0 crashes
# after this many crash-point checks (both replicas check once a step)
FLEET_PAGES, FLEET_CRASH_AFTER, FLEET_HTTP_NEW = 1024, 24, 8
# proc_fleet: new tokens of each request (two worker processes on
# FLEET_KW's grid), and where the workers' stderr goes
PROC_NEW = 32
PROC_LOGS = os.path.join("build", "proc_fleet_logs")
FLEET_KW = dict(page_size=16, num_pages=FLEET_PAGES, token_budget=512,
                batch_buckets=[16], prefill_buckets=[512],
                pages_buckets=[72])
# serve_lora: the registry's rank buckets and slots per bucket, and the
# adapters (name, rank, payload) tagged round-robin with base rows
LORA_BUCKETS, LORA_SLOTS = (8, 16), 4
LORA_ADAPTERS = (("a1", 8, None), ("a2", 16, None), ("a3", 16, "int8"))
LORA_TAGS = tuple(name for name, _, _ in LORA_ADAPTERS) + (None,)
# packed_attention: Llama-3-8B's attention widths (32 query heads, the 8
# KV heads repeated to 32, head_dim 128) over one packed row of Llama-3's
# context; documents of seeded lengths in [128, 2048], the last cut to fit
PACK_TOKENS, PACK_HEADS, PACK_KV_HEADS, PACK_DIM = 8192, 32, 8, 128
PACK_DOC_LENS, PACK_WINDOW = (128, 2048), 1024
PACK_WARMUP, PACK_TIMED = 2, 4
# the reference kernel each masked variant drives it through
PACK_ENTRY = {"varlen": "paddle_tpu/kernels/flash_attention.py:721",
              "flashmask": "paddle_tpu/kernels/flash_attention.py:763"}
# rms_norm_rows: the train phase's tokens x hidden, and decode rows
NORM_SHAPES = ((TRAIN_SEQ, 4096), (16, 4096), (7, 1100))
# serve_tp: the model degree; the int8 run's requests (serve's first) and
# depth; the small fp32 model held against tp 1 (head_dim 64, G 2) with
# its pinned grid, requests and new tokens; where the ranks write; the
# process group's collective timeout and how long the parent waits
TP_DEGREE, TP_INT8_REQUESTS, TP_INT8_LAYERS = 2, 8, 32
TP_FP32 = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=512,
               dtype="float32")
TP_FP32_KW = dict(page_size=16, num_pages=256, token_budget=64,
                  batch_buckets=[8], prefill_buckets=[64],
                  pages_buckets=[8])
TP_FP32_REQUESTS, TP_FP32_NEW = 8, 16
TP_OUT = os.path.join("build", "serve_tp")
TP_TIMEOUT_S, TP_JOIN_S = 300, 900


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


def kernel_kind(name: str) -> str:
    n = name.lower()
    if "flash_" in n:
        return "flash"
    if "adamw_kernel" in n:
        return "adamw"
    if "paged_decode" in n:
        return "paged_decode"
    if any(k in n for k in ("quant_matmul", "qmm_sm90", "qmm_decode",
                            "reduce_splits")):
        return "quant_matmul"
    if "lora_apply" in n:
        return "lora"
    if "nccl" in n:
        return "collective"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                            "sm90_")):
        return "gemm"
    return "elementwise_and_other"


def profile_summary(prof, wall_s: float, **fields):
    """Device time of one profiled step: CUDA kernel events summed (one
    stream, so they do not overlap), split by kernel kind, and the
    kernels that took the most device time; and the host time spent
    inside `all_reduce` calls (tensor parallelism; over gloo a CUDA
    tensor's reduction runs on the host). The step's wall time under
    the profiler includes the profiler's start-up, so it is reported but
    not divided by."""
    from torch.autograd import DeviceType
    by_name = {}
    allreduce_us, allreduce_calls = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        elif e.name == "c10d::allreduce_":
            allreduce_us += e.time_range.elapsed_us()
            allreduce_calls += 1
    kinds = {}
    for name, (t, n) in by_name.items():
        kt, kn = kinds.get(kernel_kind(name), (0.0, 0))
        kinds[kernel_kind(name)] = (kt + t, kn + n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {**fields, "wall_ms_profiled": wall_s * 1e3,
            "device_ms": sum(t for t, _ in by_name.values()) / 1e3,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "reduce_splits_launches": sum(n for k, (_, n) in by_name.items()
                                          if "reduce_splits" in k),
            "allreduce_calls": allreduce_calls,
            "allreduce_host_ms": allreduce_us / 1e3,
            "by_kind": {k: {"ms": t / 1e3, "launches": n}
                        for k, (t, n) in sorted(kinds.items())},
            "top_kernels": [{"name": k[:100], "ms": t / 1e3, "calls": n}
                            for k, (t, n) in top]}


def serve_prompts(seed: int, vocab: int):
    """The 16 seeded requests both serve phases send: prompts of 128-1024
    tokens, 32-64 new tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=16)
    news = rng.randint(32, 65, size=16)
    return [(rng.randint(0, vocab, int(n)).tolist(), int(m))
            for n, m in zip(lens, news)]


def decode_side_launches(eng) -> int:
    """Decode-side launches so far: plain and multi-step decode launches
    and speculative verify launches."""
    c = eng.metrics.counters
    return c["decode_launches"] + c["spec_steps"]


def serve_requests(eng, prompts, adapters=None, capture_batches=True):
    """Drive `eng` with `prompts` (tagged with `adapters`, one LoRA
    adapter name or None per prompt): 8 up front, 8 once decoding has
    begun, until it drains. The first decode-only step after a live
    decode batch of >= 8 rows was captured (`capture_batch`) runs under
    torch.profiler and is reported on its own; the other steps' wall
    times are summed by kind. With `capture_batches=False` nothing is
    captured and the step after the first decode-only one (once all 16
    are added) is the profiled one. Checks every request emitted exactly
    its max_new_tokens with finite logits. Returns the serve line's
    fields, the capture and the outputs in prompt order."""
    import torch
    tags = list(adapters or [None] * len(prompts))
    rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
            for (p, m), a in zip(prompts[:8], tags)]
    late_added = False
    capture = None
    armed = False           # the next step runs under the profiler
    profiled = None
    steps = 0
    wall = {"prefill_steps_s": 0.0, "mixed_steps_s": 0.0,
            "decode_steps_s": 0.0}
    decode_only_tokens = decode_only_steps = 0
    t_serve = time.perf_counter()
    while eng.has_work():
        if not late_added and eng.scheduler.running:
            rids += [eng.add_request(p, max_new_tokens=m, adapter=a)
                     for (p, m), a in zip(prompts[8:], tags[8:])]
            late_added = True
        before = decode_side_launches(eng)
        chunks_before = eng.metrics.counters["prefill_chunks"]
        # the first step after the capture runs under torch.profiler; it
        # is reported on its own and left out of the wall sums
        profile_this = armed and profiled is None
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile_this else contextlib.nullcontext())
        ts = time.perf_counter()
        with ctx as prof:
            emitted = eng.step()
        dt = time.perf_counter() - ts
        decoded = decode_side_launches(eng) > before
        chunked = eng.metrics.counters["prefill_chunks"] > chunks_before
        if profile_this:
            profiled = profile_summary(
                prof, dt, decode_only=decoded and not chunked,
                tokens=len(emitted))
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
        if not capture_batches:
            armed = armed or (late_added and decoded and not chunked)
        elif (capture is None and late_added and decoded and not chunked
                and len(running) >= 8):
            capture = capture_batch(eng, running[:15])
            armed = True
    serve_s = time.perf_counter() - t_serve
    c = eng.metrics.counters
    outs = [eng.requests[rid].output_ids for rid in rids]
    for (_, m), rid, out in zip(prompts, rids, outs):
        if len(out) != m:
            raise AssertionError(f"request {rid} emitted {len(out)} "
                                 f"tokens, wanted {m}")
    if c["requests_quarantined"] or c["engine_failures"]:
        raise AssertionError(f"non-finite logits: {c}")
    if capture_batches and capture is None:
        raise AssertionError("no decode batch was captured")
    step_ms = (wall["decode_steps_s"] / decode_only_steps * 1e3
               if decode_only_steps else None)
    if profiled is not None and step_ms:
        # device share of an unprofiled decode-only step: the profiled
        # step's device time over their mean wall time (the profiled
        # step's own wall includes the profiler's start-up)
        profiled["device_busy_share_vs_decode_step"] = \
            profiled["device_ms"] / step_ms
    fields = {"requests": len(rids), "steps": steps,
              "prefill_tokens": c["prefill_tokens"],
              "generated_tokens": sum(len(o) for o in outs),
              "decode_launches": c["decode_launches"],
              "decode_launch_steps": c["decode_launch_steps"],
              "verify_launches": c["spec_steps"],
              "prefill_launches": c["prefill_chunks"],
              "decode_tokens": c["decode_tokens"], "serve_s": serve_s,
              **wall,
              "decode_only_tokens": decode_only_tokens,
              "decode_only_steps": decode_only_steps,
              "decode_step_ms": step_ms,
              "decode_tokens_per_s": (decode_only_tokens
                                      / wall["decode_steps_s"]
                                      if wall["decode_steps_s"] else None),
              "profiled_step": profiled}
    return fields, capture, outs


def phase_serve(seed: int):
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
    eng = ServingEngine(model, page_size=16, num_pages=SERVE_PAGES,
                        batch_buckets=[16], seed=seed)
    prompts = serve_prompts(seed, cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    paged_attention_decode.launches = 0          # the main path starts
    fields, capture, outs = serve_requests(eng, prompts)
    launches = paged_attention_decode.launches   # the main path ended
    if not (launches > 0 and launches == fields["decode_launches"]
            * cfg.num_hidden_layers):
        raise AssertionError(f"paged_attention_decode launches {launches} "
                             f"!= decode launches "
                             f"{fields['decode_launches']} x "
                             f"{cfg.num_hidden_layers} layers")
    peak = torch.cuda.max_memory_allocated()
    eng.reset_prefix_cache()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"{eng.allocator.num_used} pages leaked")
    emit({"phase": "serve", "model": "llama_3_8b", "dtype": "bfloat16",
          "layers": cfg.num_hidden_layers, "params": n_params,
          "weights_build_s": build_s, **fields,
          "num_pages": eng.num_pages,
          "paged_attention_decode_launches": launches,
          "max_memory_allocated": peak,
          "pages_used_after_reset": eng.allocator.num_used})
    pool_bytes = eng.num_pages * eng.kv_page_bytes
    return ({"paged_attention_decode": launches}, capture,
            {"model": model, "prompts": prompts, "outs": outs,
             "pool_bytes": pool_bytes, "peak": peak, "fields": fields})


def serve_engine(model, seed: int, **kw):
    """A ServingEngine on the serve phase's grid (page 16, 2048 pages,
    one batch bucket of 16)."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, page_size=16, num_pages=SERVE_PAGES,
                         batch_buckets=[16], seed=seed, **kw)


def agreement(outs, ref) -> dict:
    """How many requests' tokens equal `ref`'s, and where each other one
    first differs."""
    return {"identical_requests": sum(a == b for a, b in zip(outs, ref)),
            "requests": len(ref),
            "first_divergence": [_first_divergence(a, b)
                                 for a, b in zip(outs, ref)]}


def decode_walls(fields) -> dict:
    """Decode-only steps' tokens/s and wall ms per launch and per token
    (one decode-side launch a decode-only step)."""
    tok = fields["decode_only_tokens"]
    return {"decode_tokens_per_s": fields["decode_tokens_per_s"],
            "decode_ms_per_launch": fields["decode_step_ms"],
            "decode_ms_per_token": (fields["decode_steps_s"] * 1e3 / tok
                                    if tok else None)}


def _pages_left(eng) -> int:
    eng.reset_prefix_cache()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"{eng.allocator.num_used} pages leaked")
    return eng.allocator.num_used


def phase_serve_multi(served, seed: int):
    """Multi-step decode on the serve phase's bf16 model: decode_steps=4
    over the same 16 requests, schedule and grid. Every K-step launch
    runs under torch.cuda.set_sync_debug_mode("error") (a host sync
    inside its K steps raises and fails the engine); the paged-decode
    launches counted in the wrapper must equal the layers times the
    K-loop iterations the engine counted (decode_launch_steps)."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode

    t0 = time.perf_counter()
    model = served["model"]
    cfg = model.cfg
    eng = serve_engine(model, seed, decode_steps=SERVE_K)
    cls = type(model)
    inner = cls.forward_paged_decode_multi

    def no_sync(self, *a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    cls.forward_paged_decode_multi = no_sync
    try:
        paged_attention_decode.launches = 0      # the main path starts
        fields, _, outs = serve_requests(eng, served["prompts"],
                                        capture_batches=False)
        launches = paged_attention_decode.launches   # the path ended
    finally:
        cls.forward_paged_decode_multi = inner
    steps = fields["decode_launch_steps"]
    if not (launches > 0 and launches == steps * cfg.num_hidden_layers):
        raise AssertionError(f"serve_multi paged_attention_decode launches "
                             f"{launches} != {steps} K-loop iterations x "
                             f"{cfg.num_hidden_layers} layers")
    if not steps > fields["decode_launches"]:
        raise AssertionError(f"no launch ran more than one step: {fields}")
    serve = served["fields"]
    emit({"phase": "serve_multi", "model": "llama_3_8b",
          "dtype": "bfloat16", "layers": cfg.num_hidden_layers,
          "decode_steps": SERVE_K, "multi_buckets": eng.multi_buckets,
          "sync_debug_mode_in_launch": "error", **fields,
          **decode_walls(fields),
          "decode_tokens_per_launch_row":
              eng.metrics.snapshot()["decode_tokens_per_launch"],
          "slot_shortfall":
              eng.metrics.counters["multi_decode_slot_shortfall"],
          "paged_attention_decode_launches": launches,
          "serve": decode_walls(serve),
          "serve_device_ms": (serve["profiled_step"] or {}).get("device_ms"),
          "tokens_vs_serve": agreement(outs, served["outs"]),
          "pages_used_after_reset": _pages_left(eng),
          "seconds": time.perf_counter() - t0})
    return launches


def phase_serve_spec(served, seed: int):
    """Speculative decoding on the serve phase's bf16 model, two drains
    of the same 16 requests: (a) NgramProposer, spec_k=4; (b)
    DraftModelProposer with the served model as its own draft (its own
    1536-page pool). Checks verify launches ran, every request
    completes, both pools end empty, and in (b) that drafts were
    accepted, more than one token was emitted per verify step and the
    draft's decode ran the paged kernel. In (b) the first rejected
    draft's logit margin (the target's top logit minus the draft
    token's, at that verify position) is read back once (one host read
    per verify launch until a rejection shows)."""
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.serving import DraftModelProposer, NgramProposer
    from paddle_tpu_torch.serving import engine as engine_mod

    model = served["model"]
    cfg = model.cfg
    accept = engine_mod._verify_accept
    launches = {}
    for kind in ("ngram", "draft"):
        t0 = time.perf_counter()
        proposer = (NgramProposer() if kind == "ngram" else
                    DraftModelProposer(model, num_pages=DRAFT_PAGES,
                                       page_size=16, batch_buckets=[16]))
        eng = serve_engine(model, seed, proposer=proposer, spec_k=SPEC_K)
        verify_s, margin = [], {}
        run_verify = eng._run_verify

        def timed(reqs, drafts):
            ts = time.perf_counter()
            try:
                return run_verify(reqs, drafts)
            finally:
                verify_s.append(time.perf_counter() - ts)

        def observed(lg, ids, dl, *a):
            toks, n_acc, ok = accept(lg, ids, dl, *a)
            if not margin:
                n, d = n_acc.tolist(), dl.tolist()
                b = next((i for i in range(len(d)) if n[i] < d[i]), None)
                if b is not None:
                    j = n[b]
                    row = lg[b, j].float()
                    top, draft = int(row.argmax()), int(ids[b, j + 1])
                    margin.update(verify_launch=len(verify_s) + 1, row=b,
                                  position=j, draft_token=draft,
                                  target_token=top,
                                  logit_margin=float(row[top] - row[draft]))
            return toks, n_acc, ok

        eng._run_verify = timed
        if kind == "draft":
            engine_mod._verify_accept = observed
        try:
            paged_attention_decode.launches = 0   # the main path starts
            fields, _, outs = serve_requests(eng, served["prompts"],
                                             capture_batches=False)
            launches[kind] = paged_attention_decode.launches
        finally:
            engine_mod._verify_accept = accept
        snap = eng.metrics.snapshot()
        if not fields["verify_launches"] > 0:
            raise AssertionError(f"serve_spec {kind}: no verify launch")
        row = {"phase": f"serve_spec_{kind}", "model": "llama_3_8b",
               "dtype": "bfloat16", "layers": cfg.num_hidden_layers,
               "proposer": type(proposer).__name__, "spec_k": SPEC_K,
               "spec_buckets": eng.spec_buckets, **fields,
               **decode_walls(fields),
               "spec_acceptance_rate": snap.get("spec_acceptance_rate"),
               "spec_tokens_per_step": snap.get("spec_tokens_per_step"),
               "spec_drafted_tokens": snap["spec_drafted_tokens"],
               "spec_accepted_tokens": snap["spec_accepted_tokens"],
               "spec_rollback_tokens": snap["spec_rollback_tokens"],
               "spec_draft_oom_drops": snap["spec_draft_oom_drops"],
               "verify_ms_per_launch": (sum(verify_s) / len(verify_s)
                                        * 1e3),
               "paged_attention_decode_launches": launches[kind],
               "tokens_vs_serve": agreement(outs, served["outs"]),
               "pages_used_after_reset": _pages_left(eng)}
        if kind == "draft":
            if not (snap["spec_accepted_tokens"] > 0
                    and snap["spec_tokens_per_step"] > 1.0):
                raise AssertionError(f"target-as-draft accepted nothing: "
                                     f"{snap}")
            if (proposer.disabled or proposer.num_propose_failures
                    or not launches[kind] > 0):
                raise AssertionError(f"the draft model did not decode: "
                                     f"{proposer.disabled_reason!r}, "
                                     f"{proposer.num_propose_failures} "
                                     f"failed rounds, "
                                     f"{launches[kind]} paged launches")
            if proposer._states or proposer.allocator.num_used:
                raise AssertionError(f"{proposer.allocator.num_used} draft "
                                     f"pages leaked")
            row.update(draft_pages=DRAFT_PAGES,
                       draft_launches=proposer.num_draft_launches,
                       draft_propose_failures=proposer.num_propose_failures,
                       draft_pool_skips=proposer.num_pool_skips,
                       draft_pages_used_after=proposer.allocator.num_used,
                       first_rejection=margin or None)
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        del eng, proposer
        gc.collect()
    return launches


def phase_serve_resume(served, seed: int):
    """Snapshot and resume on the serve configuration: the 16 requests
    step until one decodes while another is mid-prefill (a chunked
    prompt); then snapshot(), a json round trip and vacate(), and
    from_snapshot onto a fresh engine with the same model and grid,
    drained. Checks every request completes under its original id with
    its token count and both engines end with zero pages."""
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    t0 = time.perf_counter()
    model = served["model"]
    prompts = served["prompts"]
    eng = serve_engine(model, seed)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    steps = 0
    while True:
        eng.step()
        steps += 1
        states = [eng.requests[r] for r in rids]
        decoding = sum(r.state is RequestState.DECODE for r in states)
        mid_prefill = sum(r.state is RequestState.PREFILL
                          and r.num_computed > 0 for r in states)
        if decoding and mid_prefill:
            break
        if steps > 64:
            raise AssertionError("no step had a request decoding and "
                                 "one mid-prefill")
    snap = json.loads(json.dumps(eng.snapshot(reason="serve_resume")))
    freed = eng.vacate()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"vacate left {eng.allocator.num_used} pages")
    t1 = time.perf_counter()
    res = ServingEngine.from_snapshot(model, snap, page_size=16,
                                      num_pages=SERVE_PAGES,
                                      batch_buckets=[16], seed=seed)
    res.run()
    resume_s = time.perf_counter() - t1
    live = {r["request_id"] for r in snap["requests"]}
    outs = []
    for rid, (_, m) in zip(rids, prompts):
        req = res.requests[rid] if rid in live else eng.requests[rid]
        if len(req.output_ids) != m or req.request_id != rid:
            raise AssertionError(f"request {rid} ended with "
                                 f"{len(req.output_ids)} of {m} tokens")
        outs.append(req.output_ids)
    emit({"phase": "serve_resume", "model": "llama_3_8b",
          "dtype": "bfloat16", "steps_before_snapshot": steps,
          "snapshot_requests": len(snap["requests"]),
          "snapshot_decoding": decoding, "snapshot_mid_prefill": mid_prefill,
          "snapshot_json_bytes": len(json.dumps(snap)),
          "pages_freed_by_vacate": freed,
          "pages_used_after_vacate": eng.allocator.num_used,
          "resume_drain_s": resume_s,
          "requests_adopted": res.metrics.counters["requests_adopted"],
          "tokens_vs_serve": agreement(outs, served["outs"]),
          "pages_used_after_reset": _pages_left(res),
          "seconds": time.perf_counter() - t0})


def phase_trace(served, seed: int):
    """One serve drain with trace=True: every request's trace holds its
    admission, prefill span(s), one decode span per token after the
    first and its finish; export() writes Chrome JSON that json.load
    reads back (build/serve_trace.json)."""
    t0 = time.perf_counter()
    model = served["model"]
    eng = serve_engine(model, seed, trace=True)
    fields, _, outs = serve_requests(eng, served["prompts"],
                                     capture_batches=False)
    tracer = eng.tracer
    traces = tracer.traces()
    if tracer.live or len(traces) != len(outs):
        raise AssertionError(f"{len(tracer.live)} traces left live, "
                             f"{len(traces)} of {len(outs)} recorded")
    by_len = sorted(len(o) for o in outs)
    got = sorted(t.count_spans("decode_step") + 1 for t in traces)
    for tr in traces:
        if not ("admitted" in tr.mark_names()
                and tr.count_spans("prefill_chunk") >= 1
                and tr.count_spans("decode_step") >= 1
                and tr.finish_reason == "length"):
            raise AssertionError(f"incomplete trace {tr!r}: "
                                 f"{tr.mark_names()} {tr.span_names()[:8]}")
    if got != by_len:
        raise AssertionError(f"decode spans + 1 {got} != tokens {by_len}")
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    tracer.export(TRACE_PATH, flight_recorder=eng.recorder)
    with open(TRACE_PATH) as f:
        doc = json.load(f)
    if len(doc["requestTraces"]) != len(outs) or not doc["traceEvents"]:
        raise AssertionError("the Chrome export does not hold the traces")
    serve = served["fields"]
    emit({"phase": "trace", "model": "llama_3_8b", "dtype": "bfloat16",
          **fields, "traced_decode_ms_per_launch": fields["decode_step_ms"],
          "serve_decode_ms_per_launch": serve["decode_step_ms"],
          "trace_events": len(doc["traceEvents"]),
          "export_bytes": os.path.getsize(TRACE_PATH),
          "tokens_vs_serve": agreement(outs, served["outs"]),
          "pages_used_after_reset": _pages_left(eng),
          "seconds": time.perf_counter() - t0})


def spill_prompts(seed: int, vocab: int):
    """serve_spill's 16 requests: the shared prefix + each tail, twice."""
    import numpy as np
    rng = np.random.RandomState(seed + 7)
    shared = rng.randint(0, vocab, SPILL_PREFIX).tolist()
    tails = [rng.randint(0, vocab, SPILL_TAIL).tolist()
             for _ in range(SPILL_TAILS)]
    return [shared + t for t in tails] * 2


def spill_drain(eng, prompts):
    """One request at a time: (outputs, host seconds from add_request to
    the step that emitted its first token)."""
    outs, ttft = [], []
    for p in prompts:
        t0 = time.perf_counter()
        rid = eng.add_request(p, max_new_tokens=SPILL_NEW)
        first = None
        while eng.has_work():
            emitted = eng.step()
            if first is None and any(r == rid for r, _ in emitted):
                first = time.perf_counter() - t0
        outs.append(eng.requests[rid].output_ids)
        ttft.append(first)
    return outs, ttft


def spill_timers(eng):
    """Wrap the engine's page I/O: host seconds of each demotion (the
    gather, its one copy and the encode), of each promotion's decode and
    CRC check, and of its enqueue (the copy into pinned memory, the
    host-to-device copy and the cache writes launched, not waited for).
    Returns the accumulator."""
    acc = {"demote_s": 0.0, "demoted": 0, "check_s": 0.0,
           "enqueue_s": 0.0, "promoted": 0}
    gather, records, scatter = (eng._gather_page_payloads,
                                eng._page_records, eng._scatter_page_records)

    def timed_gather(pids):
        t0 = time.perf_counter()
        out = gather(pids)
        acc["demote_s"] += time.perf_counter() - t0
        acc["demoted"] += len(pids)
        return out

    def timed_records(payload):
        t0 = time.perf_counter()
        out = records(payload)
        acc["check_s"] += time.perf_counter() - t0
        return out

    def timed_scatter(pids, recs):
        t0 = time.perf_counter()
        scatter(pids, recs)
        acc["enqueue_s"] += time.perf_counter() - t0
        acc["promoted"] += len(pids)

    eng._gather_page_payloads = timed_gather
    eng._page_records = timed_records
    eng._scatter_page_records = timed_scatter
    return acc


def spill_costs(eng, model, seed: int):
    """The host cost of the page codec and the copies, and the crossover
    the spill tier trades on, measured on `eng`'s caches: a 32-page
    tail's demotion and promotion (decode + CRC, the pinned copy and the
    cache writes, synchronized), against a recompute of the same tail (a
    prefill chunk of its 512 tokens after a 512-token cached prefix, the
    chunk a default-bucketed engine launches) and the 16-token chunk a
    promoted tail still runs. Median of 3 each."""
    import torch
    from paddle_tpu_torch.serving.kv_cache import pack_page_payload
    n = SPILL_TAIL // 16
    pids = list(range(1, 1 + n))
    times = {}

    def med(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    payloads = eng._gather_page_payloads(pids)
    times["demote_32_pages_ms"] = med(lambda: eng._gather_page_payloads(pids))
    recs = [eng._page_records(p) for p in payloads]
    times["check_32_pages_ms"] = med(
        lambda: [eng._page_records(p) for p in payloads])
    times["scatter_32_pages_ms"] = med(
        lambda: eng._scatter_page_records(pids, recs))
    times["promote_32_pages_ms"] = (times["check_32_pages_ms"]
                                    + times["scatter_32_pages_ms"])
    times["encode_ms_per_page"] = med(lambda: [pack_page_payload(
        eng._page_heads, r) for r in recs]) / n
    times["decode_ms_per_page"] = times["check_32_pages_ms"] / n
    # the copies alone: pinned host -> device, device -> pageable host
    nbytes = n * eng._page_raw_bytes
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    h2d = med(lambda: dev.copy_(pinned, non_blocking=True))
    d2h = med(lambda: pinned.copy_(dev))
    d2h_pageable = med(lambda: dev.cpu())
    times.update(page_bytes=eng._page_raw_bytes, payload_bytes=len(
        payloads[0]), h2d_gb_per_s=nbytes / h2d / 1e6,
        d2h_gb_per_s=nbytes / d2h / 1e6,
        d2h_pageable_gb_per_s=nbytes / d2h_pageable / 1e6)
    # recompute of the tail against the chunk a promoted tail still runs
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, model.cfg.vocab_size, (1, SPILL_TAIL),
                        generator=gen).to("cuda")
    bt = torch.arange(1, 65, dtype=torch.int32, device="cuda")

    def chunk(S, start):
        with torch.inference_mode():
            model.forward_paged_prefill(ids[:, :S], eng.kv_caches, bt,
                                        start, S)

    times["recompute_512_chunk_ms"] = med(lambda: chunk(512, SPILL_PREFIX))
    times["tail_16_chunk_ms"] = med(lambda: chunk(16, 1008))
    times["promote_plus_16_chunk_ms"] = (times["promote_32_pages_ms"]
                                         + times["tail_16_chunk_ms"])
    return times


def phase_serve_spill(served, seed: int):
    """The host spill tier at serve's widths: 16 one-at-a-time requests
    (a 512-token shared prefix + 8 tails of 512, twice) through a device
    pool of 128 usable pages, spill off and on (host pool 512 pages) at
    bf16 and with int8 KV, and a spill-on run with one corrupt host page
    (pass 1 and the first pass-2 request, whose promotion it hits).
    Gates: spill-on tokens == spill-off tokens at bf16 and int8; pages
    demoted, promoted and host hits > 0, no eviction took the drop rung;
    cached + prefilled tokens conserved; both pools empty after
    reset_prefix_cache; the corrupt page counted once and recomputed to
    the same tokens; the paged kernel once per layer per decode launch."""
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.utils import faults

    t0 = time.perf_counter()
    model = served["model"]
    cfg = model.cfg
    prompts = spill_prompts(seed, cfg.vocab_size)
    runs = {}
    launches = {"launches": 0, "int8_launches": 0}
    for name, host, kv, corrupt in (("off", 0, None, False),
                                    ("on", SPILL_HOST, None, False),
                                    ("off_int8", 0, "int8", False),
                                    ("on_int8", SPILL_HOST, "int8", False),
                                    ("on_corrupt", SPILL_HOST, None, True)):
        eng = ServingEngine(model, host_spill_pages=host, kv_dtype=kv,
                            seed=seed, **SPILL_KW)
        acc = spill_timers(eng) if name == "on" else None
        counter = "int8_launches" if kv else "launches"
        before = getattr(paged_attention_decode, counter)
        if corrupt:
            faults.inject("host_spill.corrupt", payload=True, times=1)
        try:
            outs, ttft = spill_drain(
                eng, prompts[:SPILL_TAILS + 1] if corrupt else prompts)
        finally:
            faults.clear()
        n = getattr(paged_attention_decode, counter) - before
        launches[counter] += n
        c = dict(eng.metrics.counters)
        if n != c["decode_launches"] * cfg.num_hidden_layers or not n:
            raise AssertionError(f"serve_spill {name}: {n} paged launches "
                                 f"for {c['decode_launches']} decode "
                                 f"launches x {cfg.num_hidden_layers}")
        if any(len(o) != SPILL_NEW for o in outs):
            raise AssertionError(f"serve_spill {name}: a request ended "
                                 f"short: {[len(o) for o in outs]}")
        if c["requests_quarantined"] or c["engine_failures"]:
            raise AssertionError(f"serve_spill {name}: non-finite logits")
        cached = eng.radix.num_cached_pages
        used = eng.allocator.num_used
        eng.reset_prefix_cache()
        host_left = eng.host_store.num_used if eng.host_store else 0
        if used != cached or eng.allocator.num_used or host_left:
            raise AssertionError(f"serve_spill {name}: {used} pages used "
                                 f"for {cached} cached; after reset "
                                 f"{eng.allocator.num_used} device and "
                                 f"{host_left} host pages")
        run = {"outs": outs, "ttft_pass2_s": ttft[SPILL_TAILS:],
               "counters": {k: c[k] for k in (
                   "kv_pages_demoted", "kv_pages_promoted",
                   "host_prefix_hits", "host_pages_dropped",
                   "radix_evict_demoted", "radix_evict_dropped",
                   "cached_tokens_served", "prefill_tokens",
                   "prefix_hits", "host_spill_corrupt", "decode_launches",
                   "prefill_chunks")}}
        if acc is not None:
            run["page_io"] = {
                "demote_ms_per_page": (acc["demote_s"] * 1e3
                                       / max(1, acc["demoted"])),
                "promote_check_ms_per_page": (acc["check_s"] * 1e3
                                              / max(1, acc["promoted"])),
                "promote_enqueue_ms_per_page": (acc["enqueue_s"] * 1e3
                                                / max(1, acc["promoted"])),
                "demoted": acc["demoted"], "promoted": acc["promoted"]}
            run["costs"] = spill_costs(eng, model, seed)
        runs[name] = run
        del eng
        gc.collect()
    for off, on in (("off", "on"), ("off_int8", "on_int8"),
                    ("off", "on_corrupt")):
        a, b = runs[off], runs[on]
        if a["outs"][:len(b["outs"])] != b["outs"]:
            bad = [i for i, (x, y) in enumerate(zip(a["outs"], b["outs"]))
                   if x != y]
            raise AssertionError(f"serve_spill {on}: tokens differ from "
                                 f"{off} at requests {bad}")
        if on == "on_corrupt":
            continue
        ca, cb = a["counters"], b["counters"]
        if (ca["cached_tokens_served"] + ca["prefill_tokens"]
                != cb["cached_tokens_served"] + cb["prefill_tokens"]):
            raise AssertionError(f"serve_spill {on}: cached + prefilled "
                                 f"tokens not conserved: {ca} {cb}")
    for on in ("on", "on_int8"):
        c = runs[on]["counters"]
        if not (c["kv_pages_demoted"] > 0 and c["kv_pages_promoted"] > 0
                and c["host_prefix_hits"] > 0
                and c["radix_evict_dropped"] == 0):
            raise AssertionError(f"serve_spill {on}: the spill tier did not "
                                 f"run as it should: {c}")
    if runs["on_corrupt"]["counters"]["host_spill_corrupt"] != 1:
        raise AssertionError("serve_spill: the corrupt page was not "
                             "counted once")

    def mean(xs):
        return sum(xs) / len(xs)

    emit({"phase": "serve_spill", "model": "llama_3_8b", "dtype": "bfloat16",
          "layers": cfg.num_hidden_layers, "device_pages": SPILL_PAGES,
          "host_pages": SPILL_HOST, "requests": len(prompts),
          "prompt_tokens": SPILL_PREFIX + SPILL_TAIL, "new_tokens": SPILL_NEW,
          "buckets": {k: SPILL_KW[k] for k in (
              "batch_buckets", "prefill_buckets", "pages_buckets")},
          "counters": {k: r["counters"] for k, r in runs.items()},
          "tokens_equal": {"on_vs_off": True, "int8_on_vs_off": True,
                           "corrupt_vs_off": True},
          "page_io": runs["on"]["page_io"], "costs": runs["on"]["costs"],
          "ttft_pass2_ms": {k: mean(r["ttft_pass2_s"]) * 1e3
                            for k, r in runs.items()},
          "prefill_tokens_saved": {
              "bf16": runs["off"]["counters"]["prefill_tokens"]
              - runs["on"]["counters"]["prefill_tokens"],
              "int8": runs["off_int8"]["counters"]["prefill_tokens"]
              - runs["on_int8"]["counters"]["prefill_tokens"]},
          "paged_attention_decode_launches": launches["launches"],
          "paged_attention_decode_int8_launches": launches["int8_launches"],
          "seconds": time.perf_counter() - t0})
    return launches


def phase_fleet(served, seed: int):
    """The in-process fleet on serve's model: two replicas (1024 pages
    each, pinned buckets) behind PrefixAffinityRouter take serve's 16
    prompts; replica-0 crashes mid-run and its requests migrate. Gates:
    every request completes with its token count, none lost, each stream
    saw every token exactly once, the tokens streamed before the crash a
    prefix of the final ones, every pool empty at the end. Then a prefix
    pull (the crashed replica's vacated engine adopts what the survivor
    exports for a prompt it served, then serves it: adopted == exported
    pages, one prefix hit, the survivor's tokens), a prefill-role
    engine's hand-off (reason "handoff", a page-aligned span; resumed on
    the survivor), and FleetServer + HttpFrontend on 127.0.0.1 (two SSE
    streams == their handles' tokens, one JSON request, /healthz 200,
    /metrics naming the serving counters)."""
    import asyncio
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.profiler.exposition import parse_exposition_names
    from paddle_tpu_torch.serving import (Fleet, FleetServer, HttpFrontend,
                                          PrefixAffinityRouter, ReplicaState,
                                          ServingEngine)
    from paddle_tpu_torch.utils import faults

    t0 = time.perf_counter()
    model = served["model"]
    cfg = model.cfg
    prompts = served["prompts"]
    engines = [ServingEngine(model, seed=seed, **FLEET_KW) for _ in range(2)]
    paged_attention_decode.launches = 0          # the main path starts
    fleet = Fleet(engines, router=PrefixAffinityRouter(),
                  stall_timeout_s=600.0)
    events = {}
    handles = []
    for p, m in prompts:
        h = fleet.submit(p, max_new_tokens=m)
        h.subscribe(lambda ev, rid=h.request_id: events.setdefault(
            rid, []).append(ev))
        handles.append(h)
    placed = {h.request_id: fleet._assign[h.request_id].name
              for h in handles}
    faults.inject("fleet.replica_crash", payload="replica-0",
                  after=FLEET_CRASH_AFTER, times=-1)
    at_crash = None
    t_drain = time.perf_counter()
    try:
        steps = 0
        while fleet.has_work():
            before = [list(h.tokens) for h in handles]
            fleet.step_all()
            steps += 1
            if at_crash is None and \
                    fleet.replica("replica-0").state is ReplicaState.DEAD:
                at_crash = before
            if steps > 5000:
                raise RuntimeError("the fleet did not drain")
    finally:
        faults.clear()
    drain_s = time.perf_counter() - t_drain
    if at_crash is None:
        raise AssertionError("replica-0 never crashed")
    c = dict(fleet.counters)
    for h, (p, m), pre in zip(handles, prompts, at_crash):
        toks = [e["token"] for e in events[h.request_id]
                if e["type"] == "token"]
        if not (h.finished and h.finish_reason in ("length", "stop")
                and len(h.tokens) == m and toks == h.tokens
                and h.tokens[:len(pre)] == pre):
            raise AssertionError(f"fleet request {h.request_id}: "
                                 f"{h.finish_reason}, {len(h.tokens)} of {m} "
                                 f"tokens, {len(toks)} streamed, "
                                 f"{len(pre)} before the crash")
    migrated_with_tokens = sum(1 for h, pre in zip(handles, at_crash)
                               if h.migrations and pre)
    if c["requests_lost"] or not c["requests_migrated"] \
            or not migrated_with_tokens:
        raise AssertionError(f"fleet counters {c}: a loss, or no request "
                             f"migrated mid-stream")
    survivor = fleet.replica("replica-1").engine
    crashed = fleet.replica("replica-0").engine
    # prefix pull: a prompt the survivor served from the start, held to
    # the survivor's batched fleet run and to the survivor serving it
    # alone from its own cache (a row's result does not depend on its
    # batch: the paged kernel splits each row by its own length)
    pick = next(i for i, h in enumerate(handles)
                if placed[h.request_id] == "replica-1" and not h.migrations)
    prompt, m = prompts[pick]
    pull_n, pulled_pages = survivor.export_prefix(prompt)
    hits0 = crashed.metrics.counters["prefix_hits"]
    adopted = crashed.adopt_prefix(prompt[:pull_n], pulled_pages)
    rid = crashed.add_request(prompt, max_new_tokens=m)
    pulled = crashed.run()[rid]
    hits = crashed.metrics.counters["prefix_hits"] - hits0
    rid = survivor.add_request(prompt, max_new_tokens=m)
    own = survivor.run()[rid]
    batched = handles[pick].tokens
    if not (pull_n and adopted == len(pulled_pages) and hits == 1
            and pulled == own == batched):
        raise AssertionError(f"prefix pull: {len(pulled_pages)} exported, "
                             f"{adopted} adopted, {hits} prefix hits, tokens "
                             f"{agreement([pulled, own], [batched] * 2)}")
    # a prefill-role engine hands one request off; the survivor resumes it
    pf = ServingEngine(model, role="prefill", seed=seed,
                       **dict(FLEET_KW, num_pages=256))
    prompt, m = prompts[0]
    rid = pf.add_request(prompt, max_new_tokens=m)
    pf.run()
    req = pf.requests[rid]
    span = req.handoff_prefix_len
    if not (req.finish_reason == "handoff" and span > 0 and span % 16 == 0
            and span <= len(prompt) + len(req.output_ids)):
        raise AssertionError(f"hand-off: {req.finish_reason}, span {span}")
    full = prompt + list(req.output_ids)
    n, payloads = pf.export_prefix(full[:span])
    survivor.reset_prefix_cache()
    handed = survivor.adopt_prefix(full[:n], payloads)
    survivor.adopt_requests([{
        "request_id": rid, "prompt_ids": prompt,
        "output_ids": list(req.output_ids), "max_new_tokens": m,
        "eos_token_id": None, "num_preemptions": 0, "aborted": False,
        "deadline_remaining_s": None, "adapter": None, "colocate": False}])
    resumed = survivor.run()[rid]
    pf.reset_prefix_cache()
    # FleetServer + HttpFrontend over loopback
    for e in engines:
        e.reset_prefix_cache()
    http_fleet = Fleet(engines, stall_timeout_s=600.0)

    async def call(port, method, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        data = b"" if body is None else json.dumps(body).encode()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, rest = raw.partition(b"\r\n\r\n")
        return int(head.split(b" ")[1]), rest

    async def scenario():
        async with FleetServer(http_fleet) as server, \
                HttpFrontend(server, host="127.0.0.1", port=0) as front:
            port = front.port
            streams = await asyncio.gather(*[
                call(port, "POST", "/v1/completions",
                     {"prompt_ids": p[:128], "max_new_tokens": FLEET_HTTP_NEW})
                for p, _ in prompts[1:3]])
            js = await call(port, "POST", "/v1/completions",
                            {"prompt_ids": prompts[3][0][:128],
                             "max_new_tokens": FLEET_HTTP_NEW,
                             "stream": False})
            return (streams, js, await call(port, "GET", "/healthz"),
                    await call(port, "GET", "/metrics"))

    streams, js, health, metrics = asyncio.run(scenario())
    for st, body in streams:
        evs = [json.loads(x[6:]) for x in body.decode().split("\n\n")
               if x.startswith("data: {")]
        toks = [e["token"] for e in evs if e["type"] == "token"]
        fin = evs[-1]
        if not (st == 200 and fin["type"] == "finish"
                and len(toks) == FLEET_HTTP_NEW
                and http_fleet.handle(fin["request_id"]).tokens == toks):
            raise AssertionError(f"SSE stream {st}: {evs[-1:]}")
    doc = json.loads(js[1])
    names = parse_exposition_names(metrics[1].decode())
    want = {f"paddle_serving_{k}" for k in (
        "requests_added", "decode_tokens", "prefill_tokens",
        "kv_pages_exported", "kv_pages_adopted", "fleet_requests_submitted",
        "replica_up")}
    if not (js[0] == 200 and len(doc["tokens"]) == FLEET_HTTP_NEW
            and health[0] == 200 and metrics[0] == 200 and want <= names):
        raise AssertionError(f"HTTP: json {js[0]}, healthz {health[0]}, "
                             f"metrics {metrics[0]}, missing "
                             f"{sorted(want - names)}")
    launches = paged_attention_decode.launches   # the main path ended
    decode = sum(e.metrics.counters["decode_launches"]
                 for e in engines + [pf])
    if not (launches and launches == decode * cfg.num_hidden_layers):
        raise AssertionError(f"fleet: {launches} paged launches for "
                             f"{decode} decode launches")
    left = []
    for e in engines + [pf]:
        e.reset_prefix_cache()
        left.append(e.allocator.num_used)
    if any(left):
        raise AssertionError(f"fleet: pages left {left}")
    summary = fleet.summary()
    emit({"phase": "fleet", "model": "llama_3_8b", "dtype": "bfloat16",
          "replicas": 2, "pages_each": FLEET_PAGES,
          "buckets": {k: FLEET_KW[k] for k in (
              "batch_buckets", "prefill_buckets", "pages_buckets")},
          "requests": len(handles), "crash_after_checks": FLEET_CRASH_AFTER,
          "fleet_counters": c,
          "migrations": [h.migrations for h in handles],
          "migrated_with_tokens_before_crash": migrated_with_tokens,
          "drain_s": drain_s, "steps": steps,
          "tokens_vs_serve": agreement([h.tokens for h in handles],
                                       served["outs"]),
          "merged_decode_tokens": summary["decode_tokens"],
          "prefix_pull": {"prompt_tokens": len(prompts[pick][0]),
                          "pulled_tokens": pull_n,
                          "exported_pages": len(pulled_pages),
                          "adopted_pages": adopted, "prefix_hits": hits,
                          "tokens_equal_fleet_run_and_alone": True},
          "handoff": {"span": span, "first_tokens": len(req.output_ids),
                      "adopted_pages": handed,
                      "resumed_equal_fleet": resumed == handles[0].tokens},
          "http": {"sse_streams": len(streams), "json_tokens":
                   len(doc["tokens"]), "healthz": health[0],
                   "metric_names": len(names)},
          "paged_attention_decode_launches": launches,
          "pages_used_after_reset": left,
          "seconds": time.perf_counter() - t0})
    http_fleet.shutdown()
    return launches


def _worker_log_tails(logs: str, n: int = 3000) -> str:
    """The end of every worker's stderr log (ProcessFleet's stderr_dir)."""
    out = []
    for name in sorted(os.listdir(logs)):
        with open(os.path.join(logs, name), errors="replace") as f:
            out.append(f"--- {name}\n{f.read()[-n:]}")
    return "\n".join(out)


def phase_proc_fleet(served, seed: int):
    """The cross-process fleet on serve's model: two worker processes on
    the one card, p0 (role prefill) and d0 (role decode), each building
    Llama-3-8B at its published widths from the seed (the same weights
    as served["model"]), 1024 pages each, FLEET_KW's pinned buckets.
    Run 1: serve's prompts 0-7, 32 new tokens each: each prefills on p0,
    its KV pages travel through the supervisor's relay to d0, which
    decodes it through the paged kernel. Run 2: prompts 8-15 the same
    way; once d0 has emitted tokens for one of them it is SIGKILLed, its
    requests re-land on p0 (colocated) from its last heartbeat snapshot;
    then d0 is respawned. Gates: every stream of both runs bitwise equal
    to one in-process drain of all 16 (ServingEngine over served["model"]
    on the same grid); none lost, no funnel conflict; run 1: 8 hand-offs
    started and completed, none colocated, the pages shipped equal to the
    donated prefixes' pages; both pools empty with their invariants
    holding at the end; each worker's paged launches 32 x its decode
    launches (d0 at the end of run 1, p0 at the end); the kernel
    libraries loaded, not rebuilt, by the workers; every worker exits 0
    at shutdown but the killed one (-9). Reports worker start seconds,
    each hand-off's ms and relay MB/s, TTFT and drain wall of each run,
    the longest heartbeat gap, migrations and the card's peak memory."""
    import dataclasses
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.paged_attention import KERNEL_SOURCE
    from paddle_tpu_torch.serving import ProcessFleet, ServingEngine

    t_phase = time.perf_counter()
    model = served["model"]
    cfg = model.cfg
    page = FLEET_KW["page_size"]
    prompts = [(p, PROC_NEW) for p, _ in served["prompts"]]
    ref = ServingEngine(model, seed=seed, **FLEET_KW)
    rids = [ref.add_request(p, max_new_tokens=m) for p, m in prompts]
    out = ref.run()
    want = [out[r] for r in rids]
    del ref, out
    gc.collect()
    torch.cuda.empty_cache()

    lib = build.library_path(KERNEL_SOURCE)
    lib_mtime = lib.stat().st_mtime
    total_mem = torch.cuda.mem_get_info()[1]
    low_free = [torch.cuda.mem_get_info()[0]]
    spec = {"model": {"kind": "llama", "config": dataclasses.asdict(cfg),
                      "seed": seed},
            "engine": dict(FLEET_KW, seed=seed), "device": "cuda",
            "heartbeat_interval_s": 0.1}
    logs = PROC_LOGS
    t0 = time.perf_counter()
    pf = ProcessFleet({"p0": dict(spec, role="prefill"),
                       "d0": dict(spec, role="decode")},
                      dead_after_s=120.0, handoff_timeout_s=120.0,
                      stderr_dir=logs)
    # per-request hand-off timing: the first pull's start, the adoption
    handoff = {}
    start_pull, on_frame = pf._start_pull, pf._on_handoff_frame

    def timed_pull(rid, donor, target, tokens, rec, attempts=1):
        handoff.setdefault(rid, {"t0": time.perf_counter(),
                                 "pages": len(tokens) // page})
        return start_pull(rid, donor, target, tokens, rec, attempts)

    def timed_frame(worker, mtype, msg):
        entry = pf._handoffs.get(msg.get("payload", {}).get("pull_id"))
        if mtype == "kv_adopted" and entry is not None:
            handoff[entry["rid"]]["ms"] = \
                (time.perf_counter() - handoff[entry["rid"]]["t0"]) * 1e3
            handoff[entry["rid"]]["adopted"] = \
                msg["payload"]["adopted_pages"]
        return on_frame(worker, mtype, msg)

    pf._start_pull, pf._on_handoff_frame = timed_pull, timed_frame
    gaps = {"max_s": 0.0}

    def watch():
        now = pf._clock()
        for w in pf.workers.values():
            if w.ready and w.state.value in ("healthy", "suspect") \
                    and w.last_beat_host_t is not None:
                gaps["max_s"] = max(gaps["max_s"],
                                    now - w.last_beat_host_t)
        low_free[0] = min(low_free[0], torch.cuda.mem_get_info()[0])

    def pump_until(done, what, limit_s=600.0):
        t = time.perf_counter()
        while not done():
            if not pf.pump():
                time.sleep(0.002)
            watch()
            if time.perf_counter() - t > limit_s:
                raise RuntimeError(f"proc_fleet: {what} not reached in "
                                   f"{limit_s} s: {pf.summary()}")

    def run(batch, kill=None):
        handles = [pf.submit(p, max_new_tokens=m) for p, m in batch]
        t = time.perf_counter()
        if kill is not None:
            pump_until(lambda: any(len(h.tokens) > 1 and pf._assign.get(
                h.request_id) == kill for h in handles), "a d0 token")
            pf.workers[kill].kill()
        pump_until(lambda: all(h.finished for h in handles), "the drain")
        wall = time.perf_counter() - t
        ttft = [(h.first_token_t - h.submit_t) * 1e3 for h in handles]
        return handles, wall, ttft

    try:
        ready_s = {}

        def all_ready():
            for n, w in pf.workers.items():
                if w.ready and n not in ready_s:
                    ready_s[n] = time.perf_counter() - t0
            return len(ready_s) == len(pf.workers)
        pump_until(all_ready, "the workers' ready", limit_s=900.0)
        h1, wall1, ttft1 = run(prompts[:8])
        c1 = dict(pf.counters)
        d0_stats = pf.request_stats("d0")
        donated = sum(v["pages"] for v in handoff.values())
        killed = pf.workers["d0"]
        h2, wall2, ttft2 = run(prompts[8:], kill="d0")
        c2 = dict(pf.counters)
        t_re = time.perf_counter()
        pf.respawn("d0")
        pump_until(lambda: pf.workers["d0"].ready, "d0's respawn",
                   limit_s=900.0)
        respawn_s = time.perf_counter() - t_re
        stats = {n: pf.request_stats(n, reset_prefix_cache=True)
                 for n in pf.workers}
        watch()
    except BaseException:
        pf.shutdown()
        print(_worker_log_tails(logs), file=sys.stderr, flush=True)
        raise
    pf.shutdown()
    exits = {"p0": pf.workers["p0"].poll(), "d0": pf.workers["d0"].poll(),
             "d0_killed": killed.poll()}
    got = [h.tokens for h in h1 + h2]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if bad:
        raise AssertionError(f"proc_fleet: requests {bad} differ from the "
                             f"in-process drain: "
                             f"{agreement(got, want)['first_divergence']}")
    if c2["requests_lost"] or c2["funnel_conflicts"]:
        raise AssertionError(f"proc_fleet counters {c2}")
    if not (c1["handoffs_started"] == c1["handoffs_completed"] == 8
            and c1["handoffs_colocated"] == 0
            and c1["kv_pages_shipped"] == donated):
        raise AssertionError(f"proc_fleet run 1 hand-offs: {c1}, "
                             f"{donated} pages donated")
    for name, st in stats.items():
        if not (st and st["allocator_ok"] and st.get("radix_ok", True)
                and st["kv_used_pages"] == 0):
            raise AssertionError(f"proc_fleet: {name}'s pool {st}")
    layers = cfg.num_hidden_layers
    for name, st in (("d0", d0_stats), ("p0", stats["p0"])):
        n = st["kernel_launches"]["paged_attention_decode"]
        if not (n and n == layers * st["decode_launches"]):
            raise AssertionError(f"proc_fleet: {name} launched the paged "
                                 f"kernel {n} times for "
                                 f"{st['decode_launches']} decode launches")
    if lib.stat().st_mtime != lib_mtime:
        raise AssertionError("proc_fleet: a worker rebuilt the paged kernel")
    if exits != {"p0": 0, "d0": 0, "d0_killed": -9}:
        raise AssertionError(f"proc_fleet: worker exits {exits}")
    launches = (d0_stats["kernel_launches"]["paged_attention_decode"]
                + stats["p0"]["kernel_launches"]["paged_attention_decode"])
    ho = [handoff[h.request_id] for h in h1]
    emit({"phase": "proc_fleet", "model": "llama_3_8b", "dtype": "bfloat16",
          "workers": {"p0": "prefill", "d0": "decode"},
          "pages_each": FLEET_KW["num_pages"],
          "buckets": {k: FLEET_KW[k] for k in (
              "batch_buckets", "prefill_buckets", "pages_buckets")},
          "worker_start_s": ready_s, "respawn_start_s": respawn_s,
          "handoff_ms": [v["ms"] for v in ho],
          "handoff_pages": [v["pages"] for v in ho],
          "relay_mb_per_s": [v["pages"] * 2097152 / 1e6 / (v["ms"] / 1e3)
                             for v in ho],
          "run1": {"drain_s": wall1, "ttft_ms": ttft1},
          "run2": {"drain_s": wall2, "ttft_ms": ttft2},
          "counters_run1": c1, "counters": c2,
          "migrations": [h.migrations for h in h1 + h2],
          "max_heartbeat_gap_s": gaps["max_s"],
          "streams_equal_in_process": len(got),
          "paged_attention_decode_launches": {
              "d0_run1": d0_stats["kernel_launches"]
              ["paged_attention_decode"],
              "p0": stats["p0"]["kernel_launches"]["paged_attention_decode"]},
          "decode_launches": {"d0_run1": d0_stats["decode_launches"],
                              "p0": stats["p0"]["decode_launches"]},
          "card_peak_used_bytes": total_mem - low_free[0],
          "card_total_bytes": total_mem, "worker_exits": exits,
          "seconds": time.perf_counter() - t_phase})
    return launches


def weight_bytes(model) -> int:
    """Device bytes of a model's parameters and persistent buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_serve_quant(served, seed: int):
    """Quantized serving on the serve phase's own model object: wq="int8"
    converts its MLP and LM-head weights in place; int8 KV pages in the
    byte budget of the serve phase's bf16 pool; the same 16 requests on
    the same schedule."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_page_bytes)
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.serving import ServingEngine

    model = served["model"]
    cfg = model.cfg
    bytes_before = weight_bytes(model)
    t0 = time.perf_counter()
    # the flight recorder keeps every step, so each prefill chunk's bucket
    # can be read back
    eng = ServingEngine(model, wq="int8", kv_dtype="int8", page_size=16,
                        batch_buckets=[16], kv_pool_bytes=served["pool_bytes"],
                        seed=seed, flight_recorder_steps=4096)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    bytes_after = weight_bytes(model)
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    want_pages = served["pool_bytes"] // paged_page_bytes(
        cfg.num_key_value_heads, 16, head_dim, "int8")
    if eng.num_pages != want_pages:
        raise AssertionError(f"int8 pool holds {eng.num_pages} pages, "
                             f"paged_page_bytes predicts {want_pages}")
    mlp_and_head = 3 * cfg.num_hidden_layers + 1
    if eng.num_wq_layers != mlp_and_head:
        raise AssertionError(f"{eng.num_wq_layers} layers converted, "
                             f"wanted {mlp_and_head}")

    torch.cuda.reset_peak_memory_stats()
    full_width = paged_attention_decode.launches
    paged_attention_decode.int8_launches = 0     # the main path starts
    quant_matmul.launches = quant_matmul.prefill_launches = 0
    quant_matmul.decode_launches = 0
    fields, capture, outs = serve_requests(eng, served["prompts"])
    launches = {"paged_attention_decode_int8":
                paged_attention_decode.int8_launches,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_decode": quant_matmul.decode_launches,
                "quant_matmul_prefill": quant_matmul.prefill_launches}
    # the main path ended. Every launch takes the kernel quant_matmul_route
    # names for its rows: a decode launch's 16 (the batch bucket) for the
    # MLP linears and the head, a prefill chunk's bucket for its MLP
    # linears (read back from the flight recorder) and 1 for its head row
    chunks = [int(prog.split(":")[1][1:]) for rec in eng.recorder.records()
              for prog in rec["programs"] if prog.startswith("chunk:")]
    if len(chunks) != fields["prefill_launches"]:
        raise AssertionError(f"{len(chunks)} chunk records for "
                             f"{fields['prefill_launches']} chunks")
    want = {"paged_attention_decode_int8":
            fields["decode_launches"] * cfg.num_hidden_layers,
            **_qmm_expected(cfg, 1, fields["decode_launches"], chunks)[0]}
    if launches != want or launches["quant_matmul"] or not all(
            v for k, v in launches.items() if k != "quant_matmul") or \
            paged_attention_decode.launches != full_width:
        raise AssertionError(f"quantized-path launches {launches} != "
                             f"{want}, a bf16 launch on quant_matmul.cu, or "
                             f"a full-width decode launch")
    # the profiled decode-only step: 97 int8 matmul launches, every one the
    # decode stream's, and no second launch to sum K splits
    prof = fields["profiled_step"]
    if prof is not None and prof["decode_only"]:
        qmm = prof["by_kind"].get("quant_matmul", {}).get("launches", 0)
        if qmm != mlp_and_head or prof["reduce_splits_launches"]:
            raise AssertionError(f"profiled decode step: {qmm} int8 matmul "
                                 f"launches (want {mlp_and_head}), "
                                 f"{prof['reduce_splits_launches']} "
                                 f"reduce_splits")
    buckets = {S: chunks.count(S) for S in sorted(set(chunks))}
    peak = torch.cuda.max_memory_allocated()
    eng.reset_prefix_cache()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"{eng.allocator.num_used} pages leaked")
    # where each request's greedy tokens first leave the bf16 phase's
    # (printed, not gated: random weights give near-flat logits)
    diverge = []
    for got, ref in zip(outs, served["outs"]):
        at = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                  None)
        diverge.append(at)
    emit({"phase": "serve_quant", "model": "llama_3_8b", "dtype": "bfloat16",
          "wq": "int8", "kv_dtype": "int8", "layers": cfg.num_hidden_layers,
          "num_wq_layers": eng.num_wq_layers, "convert_s": convert_s,
          "weight_bytes_before": bytes_before,
          "weight_bytes_after": bytes_after,
          "kv_pool_bytes": served["pool_bytes"],
          "num_pages": eng.num_pages, "kv_page_bytes": eng.kv_page_bytes,
          **fields, "kernel_launches": launches,
          "prefill_chunks_by_bucket": buckets,
          "first_divergence_from_bf16": diverge,
          "identical_to_bf16": sum(d is None for d in diverge),
          "max_memory_allocated": peak,
          "serve_bf16_max_memory_allocated": served["peak"],
          "pages_used_after_reset": eng.allocator.num_used})
    return launches, capture, buckets


def lora_registry(dims, seed: int):
    """serve_lora's adapter registry on the card: rank buckets 8 and 16,
    4 slots each, and the three seeded adapters of LORA_ADAPTERS."""
    from paddle_tpu_torch.serving.lora import AdapterRegistry, LoRAAdapter
    reg = AdapterRegistry(dims, rank_buckets=LORA_BUCKETS, slots=LORA_SLOTS,
                          device="cuda")
    for i, (name, rank, quant) in enumerate(LORA_ADAPTERS):
        reg.load(LoRAAdapter.random(name, rank, dims, seed=seed + 11 + i),
                 quant=quant)
    return reg


def _lora_capture(ctx, x, y, module="gate_proj"):
    """A launch's projection input (rows, H) and output (rows, N) (before
    the LoRA kernel adds to it), its row slots and the module's rank
    buckets (`LoRABuckets`: every bucket's stacks and first slot)."""
    return {"x": x.reshape(-1, x.shape[-1]).clone(),
            "y": y.reshape(-1, y.shape[-1]).clone(),
            "slots": ctx.row_slots.clone(), "buckets": ctx.buckets(module)}


def phase_serve_lora(served, seed: int):
    """Multi-LoRA serving on the serve phase's bf16 model (all 32 layers):
    a registry of the three adapters (all seven target modules), the same
    16 requests on the same schedule tagged round-robin a1, a2, a3, base.
    Layer 0's gate_proj input and output of the decode launch with the
    most adapter rows among those mixing all three adapters are captured
    for the kernel check."""
    import torch
    from paddle_tpu_torch.kernels.lora_matmul import lora_apply
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.lora import llama_lora_dims, runtime

    model = served["model"]
    cfg = model.cfg
    t0 = time.perf_counter()
    reg = lora_registry(llama_lora_dims(cfg), seed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = ServingEngine(model, page_size=16, num_pages=SERVE_PAGES,
                        batch_buckets=[16], seed=seed, lora=reg)
    tags = [LORA_TAGS[i % len(LORA_TAGS)]
            for i in range(len(served["prompts"]))]

    cap, best = {}, [0]
    apply = runtime.LoRAContext.apply

    def recording(ctx, module, x, y):
        # the first gate_proj call of a decode launch is layer 0's; keep
        # the launch with the most adapter rows that mixes all three
        # adapters (counted on the host: no device sync)
        if module == "gate_proj" and x.shape[1] == 1 and \
                not getattr(ctx, "_looked", False):
            ctx._looked = True
            tagged = [r.adapter for r in eng.scheduler.running
                      if r.adapter is not None]
            if len(set(tagged)) == len(LORA_ADAPTERS) and \
                    len(tagged) > best[0]:
                best[0] = len(tagged)
                cap.update(_lora_capture(ctx, x, y))
        return apply(ctx, module, x, y)

    torch.cuda.reset_peak_memory_stats()
    runtime.LoRAContext.apply = recording
    try:
        paged_attention_decode.launches = 0      # the main path starts
        lora_apply.launches = 0
        fields, _, outs = serve_requests(eng, served["prompts"], tags)
        launches = {"paged_attention_decode": paged_attention_decode.launches,
                    "lora_apply": lora_apply.launches}  # the path ended
    finally:
        runtime.LoRAContext.apply = apply
    per_launch = len(reg.layout.dims) * cfg.num_hidden_layers
    launched = fields["decode_launches"] + fields["prefill_launches"]
    want = {"paged_attention_decode":
            fields["decode_launches"] * cfg.num_hidden_layers,
            "lora_apply": launched * per_launch}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"serve_lora launches {launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    snap = eng.metrics.snapshot()
    if not snap["adapter_mix_p50"] > 1:
        raise AssertionError(f"decode launches do not mix adapters: "
                             f"adapter_mix_p50 {snap['adapter_mix_p50']}")
    refs = {name: reg.refs_of(name) for name, _, _ in LORA_ADAPTERS}
    if any(refs.values()):
        raise AssertionError(f"adapter refs left after the drain: {refs}")
    reg.check_invariants()
    eng.reset_prefix_cache()
    if eng.allocator.num_used != 0:
        raise AssertionError(f"{eng.allocator.num_used} pages leaked")
    if not cap:
        raise AssertionError("no decode launch mixed all three adapters")
    # base rows: the serve phase's requests, untouched by any adapter
    base_same = [out == ref for out, ref, a in
                 zip(outs, served["outs"], tags) if a is None]
    bf16 = served["fields"]
    emit({"phase": "serve_lora", "model": "llama_3_8b", "dtype": "bfloat16",
          "layers": cfg.num_hidden_layers,
          "adapters": [{"name": n, "rank": r, "payload": q or "float32"}
                       for n, r, q in LORA_ADAPTERS],
          "rank_buckets": list(LORA_BUCKETS), "slots": LORA_SLOTS,
          "targets": list(reg.layout.dims), "load_s": load_s,
          "pool_bytes": (reg.pool.numel() * 4 + reg.quant_pool.numel()),
          "tags": tags, **fields, "kernel_launches": launches,
          "lora_launches_per_engine_launch": per_launch,
          "adapter_mix_p50": snap["adapter_mix_p50"],
          "adapter_mix_p90": snap["adapter_mix_p90"],
          "adapter_refs_after_drain": refs,
          "base_rows_identical_to_serve": base_same,
          "serve_bf16": {k: bf16[k] for k in (
              "decode_step_ms", "decode_tokens_per_s", "prefill_steps_s",
              "mixed_steps_s", "decode_steps_s")},
          "serve_bf16_device_ms": (bf16["profiled_step"] or {}).get(
              "device_ms"),
          "max_memory_allocated": peak,
          "serve_bf16_max_memory_allocated": served["peak"],
          "pages_used_after_reset": eng.allocator.num_used})
    return launches, cap


def synthetic_lora_decode(seed: int):
    """A serve_lora-like decode capture without an engine: the registry
    of phase serve_lora for gate_proj alone at Llama-3-8B's widths, 16
    rows tagged round-robin a1, a2, a3, base, a seeded bf16 input and
    output."""
    import torch
    from paddle_tpu_torch.models.llama import llama_3_8b
    from paddle_tpu_torch.serving.lora import llama_lora_dims
    from paddle_tpu_torch.serving.lora.runtime import build_context
    dims = llama_lora_dims(llama_3_8b(), targets=("gate_proj",))
    reg = lora_registry(dims, seed)
    slots = [reg.slot_of(t) if t else 0 for t in LORA_TAGS] * 4
    ctx = build_context(reg.layout, reg.flat_args(),
                        torch.tensor(slots, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    H, N = dims["gate_proj"]
    x = torch.randn(len(slots), 1, H, generator=gen, device="cuda").bfloat16()
    y = torch.randn(len(slots), 1, N, generator=gen, device="cuda").bfloat16()
    return _lora_capture(ctx, x, y)


def lora_cases(seed: int, decode):
    """{case: (x fp32, y, row slots, LoRABuckets)} of the LoRA checks: the
    decode capture (both rank buckets); a prefill chunk of 512 tokens of
    one request (one entry) at the capture's rank-16 adapter; its 512
    rows as decode rows over every slot; and a ragged shape (H 1100 and N
    72, not multiples of 8, ranks 5 and 3, with slot-0 rows and ids
    naming no slot)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.lora_matmul import LoRABuckets
    bk = decode["buckets"]
    cases = {"decode": (decode["x"].float(), decode["y"], decode["slots"],
                        bk)}
    first16 = bk.firsts[bk.ranks.index(16)]
    slots = [int(s) for s in decode["slots"].tolist()
             if first16 < s < first16 + bk.slots[bk.ranks.index(16)]]
    slot = slots[0] if slots else first16 + 1
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    x = torch.randn(512, bk.H, generator=gen, device="cuda")
    y = torch.randn(512, bk.N, generator=gen, device="cuda").bfloat16()
    cases["prefill"] = (x, y, torch.tensor([slot], dtype=torch.int32,
                                           device="cuda"), bk)
    top = bk.firsts[-1] + bk.slots[-1]
    cases["rows512"] = (x, y, torch.arange(-1, 511, dtype=torch.int32,
                                           device="cuda") % (top + 1), bk)
    rng = np.random.RandomState(seed + 9)
    S, H, N, rows = 3, 1100, 72, 37
    stacks = []
    for bi, R in enumerate((5, 3)):
        a = rng.randn(S, H, R).astype(np.float32) * 0.02
        b = rng.randn(S, R, N).astype(np.float32) * 0.02
        a[0] = b[0] = 0.0
        stacks.append((torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                       bi * S))
    ids = rng.randint(1, 2 * S, rows).astype(np.int32)
    ids[:5] = [1, 4, 0, 3, 2 * S]
    cases["ragged"] = (
        torch.from_numpy(rng.randn(rows, H).astype(np.float32)).cuda(),
        torch.from_numpy(rng.randn(rows, N).astype(np.float32)).cuda()
        .bfloat16(), torch.from_numpy(ids).cuda(), LoRABuckets(stacks))
    return cases


def _lora_null_rows(slots, rows, bk):
    """Rows whose slot is a bucket's slot 0 or in no bucket."""
    import torch
    live = torch.zeros_like(slots, dtype=torch.bool)
    for first, S in zip(bk.firsts, bk.slots):
        live |= (slots > first) & (slots < first + S)
    return (~live).repeat_interleave(rows // slots.shape[0])


def check_lora_kernels(seed: int, decode=None):
    """The LoRA kernel (`lora_apply`) on `lora_cases` (over `decode`, a
    captured serve_lora launch, or a synthetic one) with bf16 and fp32 x
    against its plain version `lora_apply_ref`: the delta-only output
    within 1e-5 of max |ref| (the products are fp32 either way; only the
    summation order differs); the fused output, with y in bf16 and in
    fp32, bitwise y + delta.to(y.dtype) of the kernel's own delta; null
    rows (slot 0 of a bucket, or no bucket) exactly y + 0.0 and delta 0;
    each row's delta and output bitwise unchanged when every other row's
    slot changes; a repeat launch bitwise equal. Returns (errors,
    failures, cases): errors["lora_apply"][case] = {"err", "limit",
    ...}; failures lists the ("lora_apply", case) that missed. Launches
    here are not counted as the main path's."""
    import torch
    from paddle_tpu_torch.kernels.lora_matmul import (lora_apply,
                                                      lora_apply_ref)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    if decode is None:
        decode = synthetic_lora_decode(seed)
    cases = lora_cases(seed, decode)
    errs, failures = {}, []
    for name, (x, y, slots, bk) in cases.items():
        null = _lora_null_rows(slots, x.shape[0], bk)
        for dt in (torch.bfloat16, torch.float32):
            xx = x.to(dt)
            got = lora_apply(xx, None, slots, bk)
            torch.cuda.synchronize()
            want = lora_apply_ref(xx, None, slots, bk)
            case = f"{name}_{str(dt).replace('torch.', '')}"
            err = _max_err(got, want)
            lim = 1e-5 * want.abs().max().item()
            fused = {}
            for ydt in (torch.bfloat16, torch.float32):
                yy = y.to(ydt)
                out = lora_apply(xx, yy, slots, bk)
                fused[ydt] = (torch.equal(out, yy + got.to(ydt)),
                              torch.equal(out[null], yy[null] + 0.0))
            yb = y.to(torch.bfloat16)
            out = lora_apply(xx, yb, slots, bk)
            repeat = torch.equal(lora_apply(xx, yb, slots, bk), out) and \
                torch.equal(lora_apply(xx, None, slots, bk), got)
            indep = True
            if slots.shape[0] > 1:
                # every other row's slot changed; row r0 keeps its bits
                top = bk.firsts[-1] + bk.slots[-1]
                r0 = int((~null).nonzero()[0, 0])
                ar = torch.arange(slots.shape[0], device=slots.device)
                slots2 = torch.where(ar == r0, slots, (slots + 1) % (top + 1))
                indep = torch.equal(lora_apply(xx, None, slots2, bk)[r0],
                                    got[r0]) and \
                    torch.equal(lora_apply(xx, yb, slots2, bk)[r0], out[r0])
            errs[case] = {
                "err": err, "limit": lim,
                "fused_bitwise_bf16_y": fused[torch.bfloat16][0],
                "fused_bitwise_fp32_y": fused[torch.float32][0],
                "null_rows_y_plus_zero": fused[torch.bfloat16][1]
                and fused[torch.float32][1],
                "null_rows_delta_zero": bool(torch.all(got[null] == 0)),
                "row_independent": indep, "repeat_bitwise": repeat}
            ok = all(v for k, v in errs[case].items()
                     if k not in ("err", "limit"))
            if not (err <= lim and torch.isfinite(got).all() and ok):
                failures.append(("lora_apply", case))
    return {"lora_apply": errs}, failures, cases


def _lora_library(x, y, slots, bk):
    """The library composition, never called by the port: per rank bucket
    the gathered slot stacks (A[ids], Bs[ids]) through two torch.bmm, the
    buckets summed in fp32, cast to y's dtype and added. Returns the
    closure timed (index tensors built beforehand)."""
    import torch
    t = x.shape[0] // slots.shape[0]
    g = slots.repeat_interleave(t).long()
    idx = [torch.where((g >= f) & (g < f + S), g - f, 0)
           for f, S in zip(bk.firsts, bk.slots)]

    def run():
        xf = x.float()[:, None]
        total = None
        for (a, b, _), i in zip(bk.stacks, idx):
            d = torch.bmm(torch.bmm(xf, a[i]), b[i])[:, 0]
            total = d if total is None else total + d
        return y + total.to(y.dtype)
    return run


def lora_work(x, slots, bk, y_bytes: int):
    """(bytes each read once / written once, fp32 FMA flops) of one
    lora_apply: x of the live rows, A and B of every slot used, y read
    and out written; the products of the live rows."""
    rows, H = x.shape
    t = rows // slots.shape[0]
    nbytes = 2 * rows * bk.N * y_bytes
    flops = 0
    for (a, _, first), S, R in zip(bk.stacks, bk.slots, bk.ranks):
        in_b = (slots > first) & (slots < first + S)
        live = int(in_b.sum()) * t
        used = len(set(slots[in_b].tolist()))
        nbytes += live * H * x.element_size() + used * R * (H + bk.N) * 4
        flops += 2 * live * R * (H + bk.N)
    return nbytes, flops


def phase_lora_kernels(decode, launches, seed: int, card: str):
    """The LoRA kernel on the serve_lora capture (and the prefill chunk,
    its rows as decode rows, and a ragged shape) against its plain
    version, then timed at the main path's decode capture and at the
    prefill chunk beside the plain version, the library composition and
    the bound."""
    import torch
    from paddle_tpu_torch.kernels.lora_matmul import (lora_apply,
                                                      lora_apply_plan,
                                                      lora_apply_ref)

    errs, failures, cases = check_lora_kernels(seed, decode)
    emit({"phase": "kernel_check", "kernel": "lora", "errors": errs,
          "decode_row_slots": decode["slots"].tolist()})
    if failures:
        raise AssertionError(f"the LoRA kernel disagrees with its plain "
                             f"version: {failures}")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fl = flush_buf.zero_
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_case = {}
    for name in ("decode", "prefill"):
        x, y, slots, bk = cases[name]
        xb, yb = x.bfloat16(), y.bfloat16()
        rows, H = xb.shape
        yw = yb.clone()                  # the main path writes into y
        nbytes, flops = lora_work(xb, slots, bk, 2)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = flops / PEAK_FLOPS["float32"] * 1e3
        per_case[name] = {
            "rows": rows, "entries": slots.shape[0], "H": H, "N": bk.N,
            "ranks": list(bk.ranks), "slots": list(bk.slots),
            "plan": list(lora_apply_plan(rows, slots.shape[0], H, bk.N,
                                         bk.ranks, bk.slots, sms)),
            "ms": time_ms(lambda: lora_apply(xb, yw, slots, bk, out=yw), fl),
            "plain_ms": time_ms(lambda: lora_apply_ref(xb, yb, slots, bk),
                                fl, reps=10, warmup=2),
            "library_ms": time_ms(_lora_library(xb, yb, slots, bk), fl),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": nbytes, "flops": flops}
    head = per_case["decode"]
    e = errs["lora_apply"]
    name, source, replaces = KERNEL["lora_apply"]
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "design": DESIGN[name],
             "launches": launches[name],
             "max_abs_err": e["decode_bfloat16"]["err"],
             "max_abs_err_fp32": e["decode_float32"]["err"],
             "err_of": "the delta-only instantiation vs lora_apply_ref",
             "ms": head["ms"], "kernel_ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": head["library_ms"],
             "library": "per rank bucket torch.bmm over the gathered slot "
                        "stacks (A[ids], Bs[ids]), the fp32 sum, the cast "
                        "and the add",
             "shape": {"rows": head["rows"], "H": head["H"], "N": head["N"],
                       "ranks": head["ranks"], "x": "bfloat16",
                       "y": "bfloat16", "row_is": "decode (gate_proj)"},
             "shapes": per_case, "bytes": head["bytes"],
             "flops": head["flops"], "card": card}]


def capture_batch(eng, reqs):
    """Layer 0's caches (with their scale pages for int8 KV) and a decode
    batch's block tables / seq_lens, padded with one seq_len-0 row to the
    batch bucket."""
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
    layer = [t.clone() for t in eng.kv_caches[0]]
    return {"k": layer[0], "v": layer[1],
            "scales": layer[2:] or None,
            "bt": torch.from_numpy(bt).cuda(),
            "sl": torch.from_numpy(sl).cuda(),
            "heads": eng.num_heads // eng.tp}


def paged_batch(seed: int, B: int, KVH: int, G: int, D: int, page: int,
                P: int, lens, kv: str = "bfloat16"):
    """A seeded paged decode batch on the card: one page per live slot of
    each row, page ids shuffled (page 0 stays the pad page every unused
    slot points at), K/V drawn in bf16 and held as `kv` ("bfloat16",
    "float32" — the same values — or "int8", quantized by `quantize_kv`
    with its fp32 scale pages), and fp32 queries (callers cast them)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.paged_attention import quantize_kv
    rng = np.random.RandomState(seed)
    sl = np.asarray(lens, np.int32)
    need = -(-sl // page)
    pages = int(need.sum()) + 1
    perm = rng.permutation(pages - 1) + 1
    bt = np.zeros((B, P), np.int32)
    n = 0
    for b in range(B):
        bt[b, :need[b]] = perm[n:n + need[b]]
        n += need[b]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, KVH * G, D, generator=gen, device="cuda")
    k, v = (torch.randn(pages, KVH, page, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    scales = None
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = [ks, vs]
    elif kv == "float32":
        k, v = k.float(), v.float()
    return {"q": q, "k": k, "v": v, "scales": scales,
            "bt": torch.from_numpy(bt).cuda(),
            "sl": torch.from_numpy(sl).cuda(), "heads": KVH * G}


def serve_lens(seed: int, B: int = 16, page: int = 16, P: int = 72):
    """Lengths like the serve phase's decode batch: 128 to P pages,
    one ending mid-page, the last row a seq_len-0 pad row."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sl = rng.randint(128, P * page + 1, size=B)
    sl[0] -= 1 if sl[0] % page == 0 else 0
    sl[-1] = 0
    return sl.tolist()


# long-context decode shapes (row 1c): one request over the widest block
# table, and four at Llama-3's context; Llama-3-8B's attention widths
PAGED_LONG = {"b1_32768": (1, 2048, 32768), "b4_8192": (4, 512, 8192)}


def paged_cases(seed: int):
    """{case: (batch builder kwargs, kv types)} of check_paged_kernels. The
    serve shape (B 16, H 32, KVH 8, D 128, page 16, 72-page table); the
    long-context shapes; at the serve widths a batch of edges over a
    64-page table whose rows split at Q pages (`paged_split_pages`: 13
    at 132 SMs) — one token, a seq_len-0 pad row, a length ending
    mid-page, rows ending on the first and second split boundary, one
    token past the first (two splits of 7 and 7 pages), the full table
    (5 splits); then other group sizes, head widths and pages (G 1, 2, 8;
    D 64, 192, 256; pages 8, 16, 32), each with a pad row. Every launch
    has blocks past the batch's splits (the grid's spare rows)."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks, m = pa.paged_decode_plan(8, 16, sms)
    q = pa.paged_split_pages(8, 64, chunks, m)     # a split's most pages
    edges = [1, 0, 3 * 16 + 5, q * 16, 2 * q * 16, q * 16 + 1, 64 * 16, 9]
    rows = pa.paged_decode_splits(edges, 16, 64, chunks, m)
    assert [sp for _, sp, _ in rows] == [1, 1, 1, 1, 2, 2, -(-64 // q),
                                         1], rows
    both = ("bfloat16", "float32", "int8")
    serve = dict(B=16, KVH=8, G=4, D=128, page=16, P=72)
    cases = {"serve": (dict(serve, lens=serve_lens(seed)), both)}
    for name, (B, P, n) in PAGED_LONG.items():
        cases[name] = (dict(serve, B=B, P=P, lens=[n] * B),
                       ("bfloat16", "int8"))
    cases["edges"] = (dict(serve, B=8, P=64, lens=edges), both)
    # a rank's shard of the serve shape under tensor parallelism: H 16
    # over KVH 4 at tp 2 (serve_tp), H 8 over KVH 2 at tp 4
    for tp in (2, 4):
        cases[f"serve_tp{tp}"] = (dict(serve, KVH=8 // tp,
                                       lens=serve_lens(seed + tp)), both)
    for G, D, page in ((1, 64, 8), (2, 256, 32), (8, 64, 16), (8, 256, 16),
                       (2, 192, 16)):
        P = 512 // page
        cases[f"g{G}_d{D}_p{page}"] = (dict(B=5, KVH=2, G=G, D=D, page=page,
                                            P=P, lens=[P * page, 0, 77,
                                                       P * page - 3, 8]),
                                       both)
    return cases


def check_paged_kernels(seed: int):
    """The paged-decode kernel, both variants, on `paged_cases`: bf16 q
    within 2e-2 of the plain version's max abs error (output rounding,
    about 1 ulp at |x| <~ 2) and within 1e-2 relative error ||got - ref||
    / ||ref|| (outputs over 32768 random tokens are ~0.005, below any
    absolute limit that allows the rounding; a kernel that drops a split
    moves them by ~10%), fp32 within 1e-4 (summation order); int8 caches
    with bf16 and fp32 queries at the same limits; seq_len-0 rows exactly
    0; a second launch bitwise equal to the first; at the serve shape,
    each row bitwise equal to the same row launched with every other row
    a pad row (a row's splits depend on its own length alone); the
    merge's ticket counters back at 0. Returns (errors, failures):
    errors[kernel][case] = {"err", "limit", "rel", "repeat_bitwise"
    (, "rows_independent")}; failures lists the (kernel, case) that
    missed. Launches here are not counted as the main path's."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    errs = {"paged_attention_decode": {}, "paged_attention_decode_int8": {}}
    failures = []
    for i, (name, (kw, kvs)) in enumerate(paged_cases(seed).items()):
        for kv in kvs:
            batch = paged_batch(seed + 10 + i, kv=kv, **kw)
            k, v, bt, sl = batch["k"], batch["v"], batch["bt"], batch["sl"]
            extra = {}
            if kv == "int8":
                extra = dict(k_scale=batch["scales"][0],
                             v_scale=batch["scales"][1])
            qdts = ((torch.bfloat16, torch.float32) if kv == "int8"
                    else (getattr(torch, kv),))
            kernel = ("paged_attention_decode_int8" if kv == "int8"
                      else "paged_attention_decode")
            for dt in qdts:
                q = batch["q"].to(dt)
                got = pa.paged_attention_decode(q, k, v, bt, sl, **extra)
                again = pa.paged_attention_decode(q, k, v, bt, sl, **extra)
                torch.cuda.synchronize()
                want = pa.paged_attention_decode_ref(q, k, v, bt, sl,
                                                     **extra)
                tol = 2e-2 if dt == torch.bfloat16 else 1e-4
                err, rel = _max_err(got, want), _rel_err(got, want)
                case = f"{name}_{str(dt).replace('torch.', '')}"
                same = bool(torch.equal(got, again))
                errs[kernel][case] = {"err": err, "limit": tol, "rel": rel,
                                      "repeat_bitwise": same}
                if name == "serve":
                    for r in (sl > 0).nonzero()[:, 0].tolist():
                        alone = torch.where(
                            torch.arange(len(sl), device=sl.device) == r,
                            sl, torch.zeros_like(sl))
                        row = pa.paged_attention_decode(q, k, v, bt, alone,
                                                        **extra)[r]
                        same = same and bool(torch.equal(row, got[r]))
                    errs[kernel][case]["rows_independent"] = same
                pad = (sl == 0).nonzero()[:, 0]
                if not (err <= tol and torch.isfinite(got).all() and same
                        and (dt != torch.bfloat16 or rel <= 1e-2)
                        and torch.all(got[pad] == 0)):
                    failures.append((kernel, case))
                del got, again, want
            del batch, k, v
    scratch = pa._SCRATCH.get(torch.device("cuda", 0))
    if scratch is not None and scratch[2].any():
        failures.append(("paged_attention_decode", "tickets_reset"))
    return errs, failures


def paged_times(batch, flush, q):
    """The paged-decode kernel on `batch` (int8 when it has scales) with
    queries `q`: kernel, plain-version and library times, and the bound.
    The library yardstick is SDPA with GQA over the same KV gathered
    beforehand (and dequantized to bf16 for int8; neither timed), never
    called by the port."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_attention_decode_ref)
    k, v, bt, sl, sc = (batch["k"], batch["v"], batch["bt"], batch["sl"],
                        batch["scales"])
    extra = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
    B, H, D = q.shape
    _, KVH, page, _ = k.shape
    args = (q, k, v, bt, sl)
    ms = time_ms(lambda: paged_attention_decode(*args, **extra), flush)
    plain_ms = time_ms(lambda: paged_attention_decode_ref(*args, **extra),
                       flush, reps=10, warmup=2)
    idx = bt.long()

    def dense(c, s):
        g = (c[idx].float() * s[idx][..., None]).bfloat16() if sc else c[idx]
        return g.permute(0, 2, 1, 3, 4).reshape(B, KVH, -1, D)
    kd, vd = dense(k, sc and sc[0]), dense(v, sc and sc[1])
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < sl[:, None])[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True), flush)
    del kd, vd, mask
    live = int(sl.sum())
    row = D * k.element_size() + (4 if sc else 0)   # a K or V row (+ scale)
    nbytes = (2 * live * KVH * row                  # live K + V, read once
              + 2 * B * H * D * q.element_size()    # q in, out
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * live * H * D                        # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "gb_per_s": nbytes / ms / 1e6,
            "shape": {"B": B, "H": H, "KVH": KVH, "D": D, "page": page,
                      "max_pages": bt.shape[1], "live_tokens": live}}


def paged_long_times(seed: int, kv: str, flush):
    """Row 1c: paged_times at the PAGED_LONG shapes, bf16 queries."""
    import torch
    out = {}
    for i, (name, (B, P, n)) in enumerate(PAGED_LONG.items()):
        batch = paged_batch(seed + 40 + i, B, 8, 4, 128, 16, P, [n] * B, kv)
        out[name] = paged_times(batch, flush, batch["q"].bfloat16())
        del batch
        torch.cuda.empty_cache()
    return out


def check_paged_capture(capture, seed: int):
    """The paged-decode kernel on a live decode batch's layer-0 caches
    (`capture_batch`; int8 with its scale pages when it has them) with
    seeded bf16 and fp32 queries: max abs error within 2e-2 / 1e-4 of the
    plain version (full-width caches cast to the query type), the pad row
    exactly 0. Raises on a miss; returns ({dtype: max abs error}, the
    bf16 queries)."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_attention_decode_ref)
    k, v, bt, sl = capture["k"], capture["v"], capture["bt"], capture["sl"]
    sc = capture["scales"]
    extra = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
    B, H, D = bt.shape[0], capture["heads"], k.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    errs = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        kk, vv = (k, v) if sc else (k.to(dt), v.to(dt))
        args = (q.to(dt), kk, vv, bt, sl)
        got = paged_attention_decode(*args, **extra)
        torch.cuda.synchronize()
        want = paged_attention_decode_ref(*args, **extra)
        err = (got.float() - want.float()).abs().max().item()
        pad = int((sl == 0).nonzero()[0, 0])
        if not (err <= tol and torch.isfinite(got).all()
                and torch.all(got[pad] == 0)):
            raise AssertionError(f"paged_attention_decode {dt} (H {H}, KVH "
                                 f"{k.shape[1]}{', int8' if sc else ''}): "
                                 f"max abs err {err} > {tol} or pad row not "
                                 f"zero")
        errs[str(dt).replace("torch.", "")] = err
    return errs, q


def phase_kernels(capture, launches, seed: int, card: str):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    errs_paged, failures = check_paged_kernels(seed)
    emit({"phase": "kernel_check", "kernel": "paged_attention_decode",
          "cases": errs_paged})
    if failures:
        raise AssertionError(f"paged decode disagrees with its plain "
                             f"version: {failures}")
    errs, q = check_paged_capture(capture, seed + 1)
    emit({"phase": "kernel_check", "kernel": "paged_attention_decode",
          "batch": capture["bt"].shape[0],
          "seq_lens": capture["sl"].tolist(), "max_abs_err": errs,
          "tolerance": {"bfloat16": 2e-2, "float32": 1e-4}})

    # timing at the main path's dtype (bf16), then the long-context rows
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    t = paged_times(capture, flush_buf.zero_, q)
    long_ctx = paged_long_times(seed, "bfloat16", flush_buf.zero_)
    name, source, replaces = KERNELS[0]
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "design": DESIGN[name],
             "launches": launches[name],
             "max_abs_err": errs["bfloat16"],
             "max_abs_err_fp32": errs["float32"],
             "ms": t["ms"], "kernel_ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"],
             "library": "torch.nn.functional.scaled_dot_product_attention"
                        "(enable_gqa=True), KV pre-gathered",
             "shape": dict(t["shape"], dtype="bfloat16"),
             "bytes": t["bytes"], "flops": t["flops"],
             "gb_per_s": t["gb_per_s"],
             "long_context": long_ctx, "card": card}]


def _rel_err(got, want) -> float:
    d = (got.float() - want.float()).norm()
    return (d / want.float().norm().clamp_min(1e-30)).item()


def qmm_shapes():
    """(name: (M, K, N)) of the int8 matmul checks: Llama-3-8B's decode
    GEMMs at the batch bucket (16 rows) and the head's prefill row (1),
    the decode stream's routes; gate/up and down at the prefill token
    budget (512 rows, the wgmma route); a ragged shape on each of the two
    (the decode one: 13 rows, K not a multiple of the 64-row unit, N not
    of the 256-column tile; the prefill one: M not a multiple of 64, N not
    of the 128-column tile, split over K) and one TMA cannot address (N
    not a multiple of 16: quant_matmul.cu)."""
    from paddle_tpu_torch.models.llama import llama_3_8b
    cfg = llama_3_8b()
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"gate_up_m16": (16, h, i), "down_m16": (16, i, h),
              "lm_head_m16": (16, h, v), "lm_head_m1": (1, h, v),
              "gate_up_m512": (512, h, i), "down_m512": (512, i, h),
              "ragged": (5, 200, 72), "ragged_decode": (13, 1000, 4112),
              "ragged_prefill": (200, h, 1040)}
    # a rank's shards under tensor parallelism: gate/up column-split (N
    # i/tp), down row-split (K i/tp), the head vocab-split (N v/tp: 64128
    # at tp 2 and 32064 at tp 4, each ending in a half 256-column tile of
    # the decode stream)
    for tp in (2, 4):
        it, vt = i // tp, v // tp
        shapes.update({f"lm_head_tp{tp}_m16": (16, h, vt),
                       f"lm_head_tp{tp}_m1": (1, h, vt)})
        if tp == TP_DEGREE:
            shapes.update({f"gate_up_tp{tp}_m16": (16, h, it),
                           f"down_tp{tp}_m16": (16, it, h),
                           f"gate_up_tp{tp}_m512": (512, h, it),
                           f"down_tp{tp}_m512": (512, it, h)})
    return shapes


def qmm_inputs(shape, seed: int):
    """Seeded x (M, K) fp32 and a seeded (K, N) weight quantized by
    `weight_quantize` (int8, fp32 per-column scales), on the card."""
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    M, K, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    x = torch.randn(M, K, generator=gen, device="cuda")
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
    qw, scale = weight_quantize(w)
    return x, qw, scale


def check_quant_kernels(seed: int, decode=None):
    """The int8 paged-decode kernel (on `decode`, a captured int8 batch,
    or a seeded one at the serve phase's shape: `paged_batch` over
    `serve_lens`) with bf16 and fp32 queries — max abs error within
    2e-2 / 1e-4 of the plain version, as for the full-width kernel, the
    pad row exact zeros — and the int8 matmul at `qmm_shapes` in bf16
    (||got - ref|| / ||ref|| <= 1e-2, the output's rounding; on the
    decode stream also a repeat launch bitwise equal and its ticket
    counters back at 0) and fp32 (max abs error <= 1e-4 of max |ref|).
    Returns (errors, failures, q): errors[kernel][case] = {"err",
    "limit"}; failures lists the (kernel, case) that missed or gave a
    non-finite value. Launches here are not counted as the main path's."""
    import torch
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_attention_decode_ref)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_ref, quant_matmul_route)

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    if decode is None:
        decode = paged_batch(seed + 5, 16, 8, 4, 128, 16, 72,
                             serve_lens(seed + 5), "int8")
    k8, v8, bt, sl = decode["k"], decode["v"], decode["bt"], decode["sl"]
    ks, vs = decode["scales"]
    B, H, D = bt.shape[0], decode["heads"], k8.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    pad = int((sl == 0).nonzero()[0, 0])
    errs = {"paged_attention_decode_int8": {}, "quant_matmul": {}}
    failures = []
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        args = (q.to(dt), k8, v8, bt, sl)
        got = paged_attention_decode(*args, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = paged_attention_decode_ref(*args, k_scale=ks, v_scale=vs)
        err = _max_err(got, want)
        case = str(dt).replace("torch.", "")
        errs["paged_attention_decode_int8"][case] = {"err": err,
                                                     "limit": tol}
        if not (err <= tol and torch.isfinite(got).all()
                and torch.all(got[pad] == 0)):
            failures.append(("paged_attention_decode_int8", case))
    for name, shape in qmm_shapes().items():
        x, qw, scale = qmm_inputs(shape, seed)
        for dt in (torch.bfloat16, torch.float32):
            xx = x.to(dt)
            got = quant_matmul(xx, qw, scale)
            torch.cuda.synchronize()
            want = quant_matmul_ref(xx, qw, scale)
            case = f"{name}_{str(dt).replace('torch.', '')}"
            if dt == torch.bfloat16:
                err, lim = _rel_err(got, want), 1e-2
            else:
                err = _max_err(got, want)
                lim = 1e-4 * want.float().abs().max().item()
            route = quant_matmul_route(*shape, dt)
            errs["quant_matmul"][case] = {
                "err": err, "limit": lim, "max_abs": _max_err(got, want),
                "route": route}
            ok = err <= lim and torch.isfinite(got).all()
            if route == "decode_sm90":
                again = quant_matmul(xx, qw, scale)
                torch.cuda.synchronize()
                tickets = qm._DECODE_SCRATCH[got.device][1]
                repeat = torch.equal(got, again)
                idle = not tickets.any().item()
                errs["quant_matmul"][case].update(
                    repeat_bitwise=repeat, tickets_zero=idle)
                ok = ok and repeat and idle
                del again
            if not ok:
                failures.append(("quant_matmul", case))
            del got, want, xx
        del x, qw, scale
    return errs, failures, q


def phase_quant_kernels(capture, launches, buckets, seed: int, card: str):
    """The int8 paged-decode kernel on layer 0 of a live serve_quant
    decode batch and the int8 matmul at the main path's shapes (the
    decode stream at M 16 and 1, the wgmma route at M 512 and at each
    prefill bucket serve_quant launched, `buckets`; quant_matmul.cu with
    fp32 x at M 16), against their plain versions, then timed beside
    them, a library call and the bound."""
    import torch
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_ref, quant_matmul_route)
    from paddle_tpu_torch.nn.quant import weight_dequantize

    errs, failures, q = check_quant_kernels(seed, capture)
    bt, sl = capture["bt"], capture["sl"]
    emit({"phase": "kernel_check", "kernel": "quantized", "batch": bt.shape[0],
          "seq_lens": sl.tolist(), "errors": errs})
    if failures:
        raise AssertionError(f"quantized kernels disagree with their plain "
                             f"versions: {failures}")

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    # --- int8 paged decode, bf16 queries (the main path's), then the
    # long-context rows
    t = paged_times(capture, flush_buf.zero_, q)
    long_ctx = paged_long_times(seed, "int8", flush_buf.zero_)
    name, source, replaces = KERNEL["paged_attention_decode_int8"]
    e = errs[name]
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "design": DESIGN["paged_attention_decode"],
                 "launches": launches[name],
                 "max_abs_err": e["bfloat16"]["err"],
                 "max_abs_err_fp32": e["float32"]["err"],
                 "ms": t["ms"], "kernel_ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "library": "torch.nn.functional.scaled_dot_product_attention"
                            "(enable_gqa=True), KV pre-gathered and "
                            "dequantized to bf16",
                 "shape": dict(t["shape"], q="bfloat16",
                               kv="int8 + fp32 scales"),
                 "bytes": t["bytes"], "flops": t["flops"],
                 "gb_per_s": t["gb_per_s"], "long_context": long_ctx,
                 "card": card})

    # --- int8 matmul: the decode stream at M 16 and the head's M 1 row
    # (quant_matmul_decode), the wgmma route (quant_matmul_prefill) at
    # gate/up and down M 512 and at every bucket serve_quant's prefill
    # chunks launched, both with bf16 x, and quant_matmul.cu with fp32 x
    # at M 16, the decode rows it keeps
    def qmm_row(M, K, N, dtype=torch.bfloat16, stream=False):
        x, qw, scale = qmm_inputs((M, K, N), seed)
        xb = x.to(dtype)
        got = quant_matmul(xb, qw, scale)
        err = _rel_err(got, quant_matmul_ref(xb, qw, scale))
        if not (err <= 1e-2 and torch.isfinite(got).all()):
            raise AssertionError(f"int8 matmul {(M, K, N)}: relative error "
                                 f"{err} > 1e-2 or not finite")
        ms = time_ms(lambda: quant_matmul(xb, qw, scale), flush_buf.zero_)
        pms = time_ms(lambda: quant_matmul_ref(xb, qw, scale),
                      flush_buf.zero_, reps=10, warmup=2)
        # library yardstick, never called by the port: the GEMM the int8
        # path replaces on the dequantized weight (bf16: twice the weight
        # bytes; fp32: four times)
        wb = weight_dequantize(qw, scale, out_dtype=str(dtype).replace(
            "torch.", ""))
        lms = time_ms(lambda: torch.matmul(xb, wb), flush_buf.zero_)
        w = xb.element_size()
        nb = K * N + N * 4 + M * K * w + M * N * w
        fl = 2 * M * K * N
        name = str(dtype).replace("torch.", "")
        b_ms = nb / HBM_BYTES_PER_S * 1e3
        o_ms = fl / PEAK_FLOPS[name] * 1e3
        row = {"M": M, "K": K, "N": N, "x": name,
               "route": quant_matmul_route(M, K, N, dtype),
               "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": max(b_ms, o_ms),
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "bytes": nb, "flops": fl, "gb_per_s": nb / ms / 1e6,
               "tflops_per_s": fl / ms / 1e9, "rel_err": err}
        if stream:
            # what a cold start costs a byte stream this size: the kernel
            # after a flush that leaves L2 clean (a read of the flush
            # buffer, where zero_ leaves ~50 MB of dirty lines for the
            # kernel's misses to write back), and one PyTorch read of the
            # same weight bytes (amax) after either flush
            clean = flush_buf.view(torch.float32).amax
            words = qw.view(torch.float32)
            row.update(
                ms_l2_clean=time_ms(lambda: quant_matmul(xb, qw, scale),
                                    clean),
                weight_read_ms=time_ms(words.amax, flush_buf.zero_),
                weight_read_ms_l2_clean=time_ms(words.amax, clean))
        return row

    shapes = qmm_shapes()
    h, i = shapes["gate_up_m16"][1:]
    decode = {n: qmm_row(*shapes[n], stream=True)
              for n in ("gate_up_m16", "down_m16", "lm_head_m16",
                        "lm_head_m1")}
    prefill = {n: qmm_row(*shapes[n]) for n in ("gate_up_m512", "down_m512")}
    # a serve_tp rank's shards (gate/up N i/tp, down K i/tp, head N v/tp)
    for n in ("gate_up", "down", "lm_head"):
        decode[f"{n}_tp{TP_DEGREE}_m16"] = qmm_row(
            *shapes[f"{n}_tp{TP_DEGREE}_m16"])
    decode[f"lm_head_tp{TP_DEGREE}_m1"] = qmm_row(
        *shapes[f"lm_head_tp{TP_DEGREE}_m1"])
    for n in ("gate_up", "down"):
        prefill[f"{n}_tp{TP_DEGREE}_m512"] = qmm_row(
            *shapes[f"{n}_tp{TP_DEGREE}_m512"])
    for S in buckets:
        for n, (K, N) in (("gate_up", (h, i)), ("down", (i, h))):
            if f"{n}_m{S}" not in prefill and \
                    quant_matmul_route(S, K, N, torch.bfloat16) == "sm90":
                prefill[f"{n}_m{S}"] = qmm_row(S, K, N)
    fp32 = {"gate_up_m16_fp32": qmm_row(*shapes["gate_up_m16"],
                                        dtype=torch.float32)}
    e = errs["quant_matmul"]
    for name, per_shape, head, case in (
            ("quant_matmul_decode", decode, "gate_up_m16",
             "gate_up_m16_bfloat16"),
            ("quant_matmul_prefill", prefill, "gate_up_m512",
             "gate_up_m512_bfloat16"),
            ("quant_matmul", fp32, "gate_up_m16_fp32",
             "gate_up_m16_float32")):
        _, source, replaces = KERNEL[name]
        top = per_shape[head]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "design": DESIGN[name],
                     "launches": launches[name],
                     "max_abs_err": e[case]["max_abs"],
                     "rel_err": top["rel_err"],
                     "ms": top["ms"], "kernel_ms": top["ms"],
                     "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                     "bound_by": top["bound_by"],
                     "library_ms": top["library_ms"],
                     "library": "torch.matmul on the dequantized weight "
                                "in x's dtype",
                     "shape": {"M": top["M"], "K": top["K"], "N": top["N"],
                               "x": top["x"], "w": "int8 + fp32 scales",
                               "row_is": head},
                     "shapes": per_shape, "bytes": top["bytes"],
                     "flops": top["flops"], "card": card})
    rows[-3]["max_abs_err_by_case"] = {
        c: v["max_abs"] for c, v in e.items() if v["route"] == "decode_sm90"}
    rows[-2]["prefill_chunks_by_bucket"] = buckets
    rows[-1]["launches_note"] = ("fp32 x and shapes TMA cannot address: "
                                 "no bf16 launch of the main path takes it")
    rows[-1]["max_abs_err_by_case"] = {
        c: v["max_abs"] for c, v in e.items()
        if v["route"] in ("decode", "fp32", "mma")}
    return rows


def tp_fp32_prompts(seed: int, vocab: int):
    """serve_tp's fp32 requests: seeded prompts of 5-64 tokens."""
    import numpy as np
    rng = np.random.RandomState(seed + 17)
    return [(rng.randint(0, vocab, int(n)).tolist(), TP_FP32_NEW)
            for n in rng.randint(5, 65, size=TP_FP32_REQUESTS)]


def _save_capture(capture, path):
    import torch
    torch.save({k: ([t.cpu() for t in v] if isinstance(v, list)
                    else v.cpu() if hasattr(v, "cpu") else v)
                for k, v in capture.items()}, path)


def _load_capture(path):
    import torch
    c = torch.load(path)
    return {k: ([t.cuda() for t in v] if isinstance(v, list)
                else v.cuda() if hasattr(v, "cuda") else v)
            for k, v in c.items()}


def _qmm_expected(cfg, tp, decode_launches, chunks):
    """{kernel: launches} the int8 matmul of one rank must count: each
    decode launch's 16 rows through every layer's gate/up (N i/tp) and
    down (K i/tp) and the head (N v/tp), each prefill chunk's bucket
    through the MLP and its one head row, every launch on the kernel
    `quant_matmul_route` names; and the (route, K, N) -> rows launched."""
    import torch
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul_route
    h, i, v = cfg.hidden_size, cfg.intermediate_size // tp, \
        cfg.vocab_size // tp
    mlp, head, L = ((h, i), (h, i), (i, h)), (h, v), cfg.num_hidden_layers
    kernel_of = {"decode_sm90": "quant_matmul_decode",
                 "sm90": "quant_matmul_prefill"}
    want = {"quant_matmul": 0, "quant_matmul_decode": 0,
            "quant_matmul_prefill": 0}
    shapes = {}
    for rows, K, N, times in (
            [(16, K, N, L * decode_launches) for K, N in mlp]
            + [(16, *head, decode_launches), (1, *head, len(chunks))]
            + [(S, K, N, L) for S in chunks for K, N in mlp]):
        route = quant_matmul_route(rows, K, N, torch.bfloat16)
        want[kernel_of.get(route, "quant_matmul")] += times
        if times:
            shapes.setdefault(f"{route}:{K}x{N}", set()).add(rows)
    return want, {k: sorted(v) for k, v in shapes.items()}


def serve_tp_rank(seed: int, out_dir: str):
    """One rank of phase serve_tp, started by the port's `spawn`: the
    fp32, bf16 and int8 runs on this rank's shard. Checks its own
    launch counts (raises), writes its tokens and fields to
    `out_dir/rank<r>.json` and, on rank 0, each run's capture for the
    parent's kernel checks."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention_decode, paged_page_bytes)
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               llama_3_8b)
    from paddle_tpu_torch.serving import ServingEngine, tp_serving_mesh

    t_start = time.perf_counter()
    env = init_parallel_env(timeout_s=TP_TIMEOUT_S)
    mesh = tp_serving_mesh(TP_DEGREE)
    dev, rank = mesh.device, mesh.rank
    res = {"rank": rank, "device": str(dev), "backend": env.backend,
           "device_count": torch.cuda.device_count(),
           "start_s": time.perf_counter() - t_start}

    def build(cfg, dtype):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return LlamaForCausalLM(cfg, device=dev, dtype=dtype, generator=gen)

    # fp32: the small model with no mesh, then at tp 2
    cfg = LlamaConfig(**TP_FP32)
    prompts = tp_fp32_prompts(seed, cfg.vocab_size)
    res["fp32"] = {}
    for tp in (1, TP_DEGREE):
        eng = ServingEngine(build(cfg, torch.float32),
                            mesh=mesh if tp > 1 else None, device=dev,
                            seed=seed, **TP_FP32_KW)
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
        out = eng.run()
        res["fp32"][f"tp{tp}"] = [out[r] for r in rids]
        del eng

    # bf16: serve's model, weights, grid and requests; the engine splits
    # the whole model as it is built here
    cfg = llama_3_8b(dtype="bfloat16")
    t0 = time.perf_counter()
    eng = ServingEngine(build(cfg, torch.bfloat16), mesh=mesh, page_size=16,
                        num_pages=SERVE_PAGES, batch_buckets=[16], seed=seed)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    prompts = serve_prompts(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(dev)
    paged_attention_decode.launches = 0          # the main path starts
    fields, capture, outs = serve_requests(eng, prompts)
    launches = paged_attention_decode.launches   # the main path ended
    if not (launches > 0 and launches == fields["decode_launches"]
            * cfg.num_hidden_layers and paged_attention_decode.int8_launches
            == 0):
        raise AssertionError(f"rank {rank}: paged launches {launches} != "
                             f"{fields['decode_launches']} decode launches "
                             f"x {cfg.num_hidden_layers} layers")
    heads = (eng.num_heads // eng.tp, eng.kv_heads_shard)
    res["bf16"] = {"outs": outs, "fields": fields, "build_s": build_s,
                   "paged_launches": launches, "heads": heads,
                   "num_pages": eng.num_pages,
                   "kv_page_bytes_shard": eng.kv_page_bytes_shard,
                   "weight_bytes": weight_bytes(eng.model),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(
                       dev),
                   "pages_used_after_reset": _pages_left(eng)}
    if rank == 0:
        _save_capture(capture, os.path.join(out_dir, "capture_bf16.pt"))
    del eng, capture
    gc.collect()
    torch.cuda.empty_cache()

    # int8: quantized whole (as at tp 1), then split; int8 pages in half
    # of serve's pool bytes a rank (each rank holds half of every page)
    cfg = llama_3_8b(dtype="bfloat16", num_hidden_layers=TP_INT8_LAYERS)
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    pool = SERVE_PAGES * paged_page_bytes(
        cfg.num_key_value_heads // TP_DEGREE, 16, head_dim, "bfloat16")
    t0 = time.perf_counter()
    eng = ServingEngine(build(cfg, torch.bfloat16), mesh=mesh, wq="int8",
                        kv_dtype="int8", page_size=16, batch_buckets=[16],
                        kv_pool_bytes=pool, seed=seed,
                        flight_recorder_steps=4096)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    paged_attention_decode.int8_launches = 0     # the main path starts
    quant_matmul.launches = quant_matmul.prefill_launches = 0
    quant_matmul.decode_launches = 0
    fields, capture, outs = serve_requests(eng, prompts[:TP_INT8_REQUESTS])
    got = {"quant_matmul": quant_matmul.launches,
           "quant_matmul_decode": quant_matmul.decode_launches,
           "quant_matmul_prefill": quant_matmul.prefill_launches}
    int8_launches = paged_attention_decode.int8_launches  # the path ended
    chunks = [int(prog.split(":")[1][1:]) for rec in eng.recorder.records()
              for prog in rec["programs"] if prog.startswith("chunk:")]
    want, shapes = _qmm_expected(cfg, TP_DEGREE, fields["decode_launches"],
                                 chunks)
    if got != want or got["quant_matmul"] or int8_launches != \
            fields["decode_launches"] * cfg.num_hidden_layers or \
            len(chunks) != fields["prefill_launches"]:
        raise AssertionError(f"rank {rank}: int8 launches {got} != {want} "
                             f"or int8 paged launches {int8_launches} != "
                             f"{fields['decode_launches']} x "
                             f"{cfg.num_hidden_layers}")
    res["int8"] = {"outs": outs, "fields": fields, "build_s": build_s,
                   "layers": cfg.num_hidden_layers,
                   "num_wq_layers": eng.num_wq_layers,
                   "paged_int8_launches": int8_launches,
                   "quant_matmul_launches": got, "qmm_shapes": shapes,
                   "prefill_chunks_by_bucket": {
                       S: chunks.count(S) for S in sorted(set(chunks))},
                   "num_pages": eng.num_pages,
                   "kv_page_bytes_shard": eng.kv_page_bytes_shard,
                   "weight_bytes": weight_bytes(eng.model),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(
                       dev),
                   "pages_used_after_reset": _pages_left(eng)}
    if rank == 0:
        _save_capture(capture, os.path.join(out_dir, "capture_int8.pt"))
    del eng, capture
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier(group=mesh.host_group)
    dist.destroy_process_group()


def phase_serve_tp(serve_outs, seed: int, card: str):
    """Phase serve_tp: the ranks (`serve_tp_rank`), then the gates that
    span them and rank 0's captures checked and timed here. Returns what
    the kernels line adds to its rows."""
    import shutil

    import torch
    from paddle_tpu_torch.distributed import spawn

    shutil.rmtree(TP_OUT, ignore_errors=True)
    os.makedirs(TP_OUT)
    t0 = time.perf_counter()
    spawn(serve_tp_rank, args=(seed, TP_OUT), nprocs=TP_DEGREE,
          timeout=TP_JOIN_S)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(TP_DEGREE):
        with open(os.path.join(TP_OUT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    for run in ("bf16", "int8"):
        if any(r[run]["outs"] != r0[run]["outs"] for r in ranks):
            raise AssertionError(f"serve_tp {run}: the ranks' tokens differ")
    fp32 = [r["fp32"] for r in ranks]
    if any(f[f"tp{TP_DEGREE}"] != f["tp1"] or f != fp32[0] for f in fp32):
        raise AssertionError(f"serve_tp fp32: tp {TP_DEGREE} tokens != tp 1 "
                             f"tokens, or the ranks differ")
    from paddle_tpu_torch.models.llama import llama_3_8b
    cfg = llama_3_8b()
    want_heads = [cfg.num_attention_heads // TP_DEGREE,
                  cfg.num_key_value_heads // TP_DEGREE]
    if any(r["bf16"]["heads"] != want_heads for r in ranks):
        raise AssertionError(f"serve_tp: a rank's heads are not "
                             f"{want_heads}")
    # rank 0's live captures (layer 0, H 16 / KVH 4) against the plain
    # version, then timed
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shard = {}
    for run, name in (("bf16", "paged_attention_decode"),
                      ("int8", "paged_attention_decode_int8")):
        cap = _load_capture(os.path.join(TP_OUT, f"capture_{run}.pt"))
        errs, q = check_paged_capture(cap, seed + 3)
        t = paged_times(cap, flush_buf.zero_, q)
        shard[name] = {
            "launches_by_rank": [r[run]["paged_launches" if run == "bf16"
                                      else "paged_int8_launches"]
                                 for r in ranks],
            "max_abs_err": errs["bfloat16"],
            "max_abs_err_fp32": errs["float32"],
            **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "bytes", "gb_per_s")},
            "shape": dict(t["shape"], dtype="bfloat16",
                          kv="int8 + fp32 scales" if run == "int8"
                          else "bfloat16")}
        del cap, q
    del flush_buf
    bf = r0["bf16"]["fields"]
    prof = bf["profiled_step"] or {}
    emit({"phase": "serve_tp", "tp": TP_DEGREE, "backend": r0["backend"],
          "device_count": r0["device_count"],
          "rank_devices": [r["device"] for r in ranks],
          "ranks_s": ranks_s, "rank_seconds": [r["seconds"] for r in ranks],
          "rank_start_s": [r["start_s"] for r in ranks],
          "fp32": {"model": TP_FP32, "requests": TP_FP32_REQUESTS,
                   "tokens_equal_tp1": True},
          "bf16": {"model": "llama_3_8b", "layers": cfg.num_hidden_layers,
                   "heads_per_rank": want_heads,
                   "build_s": [r["bf16"]["build_s"] for r in ranks],
                   "weight_bytes": [r["bf16"]["weight_bytes"] for r in ranks],
                   "max_memory_allocated": [
                       r["bf16"]["max_memory_allocated"] for r in ranks],
                   "num_pages": r0["bf16"]["num_pages"],
                   "kv_page_bytes_shard": r0["bf16"]["kv_page_bytes_shard"],
                   "paged_launches": shard["paged_attention_decode"][
                       "launches_by_rank"],
                   "identical_across_ranks": True,
                   "agreement_with_serve": agreement(r0["bf16"]["outs"],
                                                     serve_outs),
                   "allreduce_share_of_profiled_step": (
                       prof["allreduce_host_ms"] / prof["wall_ms_profiled"]
                       if prof else None),
                   "allreduce_share_of_decode_step": (
                       prof["allreduce_host_ms"] / bf["decode_step_ms"]
                       if prof and bf["decode_step_ms"] else None),
                   **{k: v for k, v in bf.items()}},
          "int8": {k: v for k, v in r0["int8"].items() if k != "outs"},
          "int8_identical_across_ranks": True,
          "int8_max_memory_allocated": [
              r["int8"]["max_memory_allocated"] for r in ranks],
          "kernel_checks": shard,
          "note": ("two ranks on one card over gloo measure correctness, not "
                   "tensor-parallel speed" if r0["device_count"] < TP_DEGREE
                   else "one card per rank over NCCL")})
    i8 = r0["int8"]["quant_matmul_launches"]
    return {"paged": shard, "qmm": {
        "quant_matmul_decode": [r["int8"]["quant_matmul_launches"][
            "quant_matmul_decode"] for r in ranks],
        "quant_matmul_prefill": [r["int8"]["quant_matmul_launches"][
            "quant_matmul_prefill"] for r in ranks],
        "quant_matmul": i8["quant_matmul"]},
        "qmm_shapes": r0["int8"]["qmm_shapes"]}


def run_train_steps(model, opt, ids, labels, layers: int, what: str):
    """TRAIN_WARMUP + TRAIN_TIMED steps of forward with the loss, backward
    and the fused AdamW update; the last warm-up step runs under
    torch.profiler. The kernel counters are set to 0 just before the
    first step and read just after the last. Gated: finite losses, the
    last below the first; the flash forward, dQ and dK/dV `layers` times
    a step, each on the wgmma kernels; AdamW once a bucket a step.
    Returns the run's losses, timed step seconds, profiled step, launches,
    wgmma launches, peak memory and bucket count."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_optimizer as fo

    counters = {"flash_attention_fwd": fa.flash_fwd,
                "flash_attention_dq": fa.flash_dq,
                "flash_attention_dkv": fa.flash_dkv,
                "fused_adamw": fo.fused_adamw_bucket}
    flash = [k for k in counters if k.startswith("flash_")]
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():                # the main path starts
        fn.launches = 0
    for k in flash:
        counters[k].sm90_launches = 0
    losses, step_s, profiled = [], [], None
    for step in range(TRAIN_WARMUP + TRAIN_TIMED):
        prof_step = step == TRAIN_WARMUP - 1
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if prof_step else contextlib.nullcontext())
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with ctx as prof:
            loss = model(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        losses.append(loss.item())
        if prof_step:
            profiled = profile_summary(prof, dt)
        if step >= TRAIN_WARMUP:
            step_s.append(dt)
    launches = {k: fn.launches for k, fn in counters.items()}
    sm90 = {k: counters[k].sm90_launches for k in flash}  # the path ended
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_TIMED
    buckets = len(opt._fused_buckets)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses not finite and falling: "
                             f"{losses}")
    want = {k: layers * steps for k in flash}
    want["fused_adamw"] = buckets * steps
    if launches != want or buckets < 1:
        raise AssertionError(f"{what}: kernel launches {launches} != {want}")
    if any(sm90[k] != launches[k] for k in flash):
        raise AssertionError(f"{what}: wgmma launches {sm90} of {launches}: "
                             f"a flash launch of the step took another "
                             f"route")
    return {"losses": losses, "step_s": step_s, "profiled": profiled,
            "launches": launches, "sm90": sm90, "peak": peak,
            "buckets": buckets}


def fused_buckets(opt):
    """Each bucket of a fused AdamW as {master, m, v, step, layout}: the
    state its kernel updated on a training phase's main path."""
    acc = opt._accumulators
    return [{"master": acc["fused_master"][rec["uid"]],
             "m": acc["fused_m"][rec["uid"]],
             "v": acc["fused_v"][rec["uid"]], "step": opt._step_count,
             "layout": rec["layout"]} for rec in opt._fused_buckets.values()]


def phase_train(seed: int):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_3_8b,
                                               llama_step_flops)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_3_8b(num_hidden_layers=TRAIN_LAYERS, dtype="bfloat16",
                     max_position_embeddings=8192)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    opt = AdamW(TRAIN_LR, parameters=model.parameters(),
                multi_precision=True, fused=True, moment_dtype="bfloat16")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    run = run_train_steps(model, opt, ids, labels, cfg.num_hidden_layers,
                          "train")
    step_med = statistics.median(run["step_s"])
    flops, _, attn_flops = llama_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit({"phase": "train", "model": "llama_3_8b", "dtype": "bfloat16",
          "reduced": {"num_hidden_layers": [32, cfg.num_hidden_layers]},
          "layers": cfg.num_hidden_layers, "params": n_params,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "optimizer": {"name": "AdamW", "lr": TRAIN_LR,
                        "multi_precision": True, "fused": True,
                        "moment_dtype": "bfloat16",
                        "buckets": run["buckets"]},
          "weights_build_s": build_s, "losses": run["losses"],
          "timed_step_ms": [t * 1e3 for t in run["step_s"]],
          "step_ms": step_med * 1e3,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_med,
          "flops_per_step": flops, "attention_flops_per_step": attn_flops,
          "mfu_vs_989tflops": flops / step_med / PEAK_FLOPS["bfloat16"],
          "kernel_launches": run["launches"],
          "flash_sm90_launches": run["sm90"],
          "profiled_step": run["profiled"],
          "max_memory_allocated": run["peak"]})
    return run["launches"], fused_buckets(opt)[0]


# ------------------------------------------------------------- generate
def generate_prompts(prompts):
    """generate's B prompts: the first GEN_PROMPT tokens of the first
    GEN_BATCH serve prompts at least that long (the serve phase's seeded
    draw)."""
    rows = [p[:GEN_PROMPT] for p, _ in prompts if len(p) >= GEN_PROMPT]
    if len(rows) < GEN_BATCH:
        raise AssertionError(f"only {len(rows)} serve prompts of >= "
                             f"{GEN_PROMPT} tokens")
    return rows[:GEN_BATCH]


def _first_divergence(a, b):
    """Index of the first position where token lists a and b differ, or
    None when they agree over the shorter one."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_generate(served, seed: int):
    """`LlamaForCausalLM.generate` on the serve phase's bf16 model: 4
    prompts of 512 tokens, 32 new tokens, greedy eager, greedy
    use_jit=True and one sampled run twice. Every forward pass launches
    the wgmma flash forward once per layer (the prefill causal at Sq = Sk
    = 512, each decode step at Sq 1 against the cache), and no other
    attention path runs. Checks the launches, jit == eager, the two
    sampled runs bitwise equal, tokens in the vocabulary and finite
    logits, and one full forward over each returned sequence against
    the logits generate used. Reports where each row's greedy tokens
    first leave a ServingEngine drain of the same prompts (paged decode
    against flash: different rounding), prefill ms, the median decode
    step, tokens/s and peak memory."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.paged_attention import \
        paged_attention_decode
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.nn.functional import flash_attention as tfa
    from paddle_tpu_torch.serving import ServingEngine

    model = served["model"]
    cfg = model.cfg
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    rows = generate_prompts(served["prompts"])
    ids = torch.tensor(rows, dtype=torch.long, device="cuda")
    seen, stamps = [], []
    real_sample, real_ref = generation._sample, tfa.sdpa_ref
    plain_calls = [0]

    def observed_sample(logits, *args, **kw):
        tok = real_sample(logits, *args, **kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        seen.append((logits.clone(), tok.clone()))
        return tok

    def counted_ref(*a, **kw):
        plain_calls[0] += 1
        return real_ref(*a, **kw)

    def run(**kw):
        """One generate call; returns (tokens, its logits (N, B, V), the
        step stamps, wall s, flash / other-path launch deltas)."""
        seen.clear()
        stamps.clear()
        n0 = (fa.flash_fwd.launches, fa.flash_fwd.sm90_launches,
              fa.flash_fwd.decode_launches, fa.flash_fwd.varlen_launches,
              fa.flash_fwd.flashmask_launches,
              paged_attention_decode.launches, plain_calls[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = [a - b for a, b in zip(
            (fa.flash_fwd.launches, fa.flash_fwd.sm90_launches,
             fa.flash_fwd.decode_launches, fa.flash_fwd.varlen_launches,
             fa.flash_fwd.flashmask_launches,
             paged_attention_decode.launches, plain_calls[0]), n0)]
        passes = len(seen)
        # the prefill at Sq = 512, then one decode step at Sq 1 a pass
        want = [L * passes, L * passes, L * (passes - 1), 0, 0, 0, 0]
        if passes != GEN_NEW or d != want:
            raise AssertionError(f"generate({kw}): {passes} forward passes, "
                                 f"launches (flash, wgmma, wgmma at Sq 1, "
                                 f"varlen, flashmask, paged, sdpa_ref) {d} "
                                 f"!= {want}")
        logits = torch.stack([x for x, _ in seen])
        toks = torch.stack([t for _, t in seen], dim=1)
        if not (torch.equal(toks, out[:, GEN_PROMPT:])
                and bool(torch.isfinite(logits).all())
                and int(out.min()) >= 0 and int(out.max()) < V):
            raise AssertionError(f"generate({kw}): tokens outside the "
                                 f"vocabulary or non-finite logits")
        return out, logits, [t0] + list(stamps), wall, passes

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    generation._sample, tfa.sdpa_ref = observed_sample, counted_ref
    fa.flash_fwd.launches = fa.flash_fwd.sm90_launches = 0  # path starts
    fa.flash_fwd.decode_launches = 0
    try:
        greedy, logits, stamps_e, wall_e, passes_e = run()
        jit, _, _, wall_j, passes_j = run(use_jit=True)
        sampled = [run(temperature=GEN_TEMPERATURE, top_p=GEN_TOP_P,
                       seed=GEN_SEED) for _ in range(2)]
    finally:
        generation._sample, tfa.sdpa_ref = real_sample, real_ref
    launches = fa.flash_fwd.sm90_launches     # the main path ended
    decode_launches = fa.flash_fwd.decode_launches
    peak = torch.cuda.max_memory_allocated()
    passes = passes_e + passes_j + sum(r[4] for r in sampled)
    sampled = [r[0] for r in sampled]
    if launches != L * passes or decode_launches != L * (passes - 4):
        raise AssertionError(f"wgmma flash forward launches {launches}, at "
                             f"Sq 1 {decode_launches} != {L} x {passes} "
                             f"forward passes, {L} x {passes - 4} decode "
                             f"steps")
    if not torch.equal(jit, greedy):
        raise AssertionError("use_jit tokens differ from the eager loop's")
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("two sampled runs with one seed differ")
    # one full forward over each returned sequence: its logits at the
    # positions that produced the new tokens against generate's
    with torch.no_grad():
        full = model(greedy)[:, GEN_PROMPT - 1:-1].float()
    got = logits.transpose(0, 1).float()
    rel = ((got - full).norm() / full.norm()).item()
    if not rel <= GEN_LOGIT_LIMIT:
        raise AssertionError(f"generate's logits {rel} from a full forward "
                             f"(limit {GEN_LOGIT_LIMIT})")
    greedy_rows_agree = (greedy[:, GEN_PROMPT:] == full.argmax(-1)).float() \
        .mean().item()
    del full, got, logits
    # the serve path on the same prompts (not gated)
    eng = ServingEngine(model, page_size=16, num_pages=256,
                        batch_buckets=[GEN_BATCH], seed=seed)
    rids = [eng.add_request(r, max_new_tokens=GEN_NEW) for r in rows]
    eng.run()
    served_toks = [eng.requests[r].output_ids for r in rids]
    del eng
    steps = [b - a for a, b in zip(stamps_e[1:-1], stamps_e[2:])]
    emit({"phase": "generate", "model": "llama_3_8b", "dtype": "bfloat16",
          "layers": L, "batch": GEN_BATCH, "prompt_tokens": GEN_PROMPT,
          "new_tokens": GEN_NEW,
          "runs": ["greedy", "greedy use_jit", "sampled seed 0",
                   "sampled seed 0"],
          "sampling": {"temperature": GEN_TEMPERATURE, "top_p": GEN_TOP_P,
                       "seed": GEN_SEED},
          "forward_passes": passes,
          "flash_fwd_sm90_launches": launches,
          "flash_fwd_decode_launches": decode_launches,
          "jit_equals_eager": True, "sampled_bitwise_equal": True,
          "sampled_equals_greedy": bool(torch.equal(sampled[0], greedy)),
          "logits_rel_err_vs_full_forward": rel,
          "logits_limit": GEN_LOGIT_LIMIT,
          "full_forward_argmax_agreement": greedy_rows_agree,
          "first_divergence_from_serve_path": [
              _first_divergence(g, s_) for g, s_ in zip(
                  greedy[:, GEN_PROMPT:].tolist(), served_toks)],
          "prefill_ms": (stamps_e[1] - stamps_e[0]) * 1e3,
          "decode_step_ms_median": statistics.median(steps) * 1e3,
          "decode_step_ms": [t * 1e3 for t in steps],
          "eager_wall_s": wall_e, "jit_wall_s": wall_j,
          "tokens_per_s": GEN_BATCH * GEN_NEW / wall_e,
          "tokens_per_s_jit": GEN_BATCH * GEN_NEW / wall_j,
          "note": "walls include a device sync and a logits copy after "
                  "every step (the phase's observer)",
          "max_memory_allocated": peak,
          "max_memory_above_start": peak - base})
    return {"flash_attention_fwd": launches,
            "flash_attention_fwd_decode": decode_launches}


# ------------------------------------------------------------ train loop
def _grad_norm(grads) -> float:
    """The fp32 global norm of a list of gradients, one tensor at a
    time."""
    import torch
    total = torch.zeros((), dtype=torch.float32, device="cuda")
    for g in grads:
        f = g.reshape(-1).float()
        total += torch.dot(f, f)
        del f
    return total.sqrt().item()


def phase_train_loop(seed: int):
    """The training loop's pieces on the train phase's configuration
    (8 layers at full width, 1 x 4096 seeded tokens, bf16) with
    recompute: first one forward + backward from the same weights with
    recompute off and on (loss and pre-clip gradient norm within 1e-3,
    peak memory of each); then AdamW(LinearWarmup(CosineAnnealingDecay),
    ClipGradByGlobalNorm(1.0), lr_ratio 0.5 for the embedding and the
    head, fp32 master, bf16 moments, fused), 2 warm-up and 4 timed steps,
    the scheduler stepped after each. Gated every step: the flash
    forward 16 times (8 + 8 replays), dQ and dK/dV 8 times, all on the
    wgmma kernels; AdamW once per bucket (2); each bucket's lr the
    schedule's value times its ratio; the clipped gradients' global norm
    <= 1.0 within 1e-2; finite losses, the last below the first."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_3_8b,
                                               llama_step_flops)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import optimizer as optim_mod
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    cfg = llama_3_8b(num_hidden_layers=TRAIN_LAYERS, dtype="bfloat16",
                     max_position_embeddings=8192, recompute=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    rng = np.random.RandomState(seed)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    params = list(model.parameters())
    L = cfg.num_hidden_layers

    # recompute against no recompute: one forward + backward each
    compare = {}
    for rc in (False, True):
        cfg.recompute = rc
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = model(ids, labels=labels)
        loss.backward()
        torch.cuda.synchronize()
        compare[rc] = {"loss": loss.item(),
                       "grad_norm": _grad_norm([p.grad for p in params]),
                       "peak_above_start": torch.cuda.max_memory_allocated()
                       - start}
        if not rc:
            saved = [p.grad for p in params]
        else:
            compare["grads_bitwise_equal"] = all(
                torch.equal(a, p.grad) for a, p in zip(saved, params))
        for p in params:
            p.grad = None
        del loss
    del saved
    a, b = compare[False], compare[True]
    rel = {k: abs(b[k] - a[k]) / abs(a[k]) for k in ("loss", "grad_norm")}
    if not (max(rel.values()) <= 1e-3
            and b["peak_above_start"] < a["peak_above_start"]):
        raise AssertionError(f"recompute against none: relative {rel}, "
                             f"peaks {b['peak_above_start']} vs "
                             f"{a['peak_above_start']}")

    emb, head = model.model.embed_tokens.weight, model.lm_head.weight
    sched = LinearWarmup(CosineAnnealingDecay(TRAIN_LR, T_max=LOOP_T_MAX),
                         warmup_steps=LOOP_WARMUP_STEPS, start_lr=0.0,
                         end_lr=TRAIN_LR)

    class ObservedClip(ClipGradByGlobalNorm):
        """The clip, timed, with the global norms of its input and output
        recorded (and the time that costs)."""
        norms, seconds, clip_seconds = [], [], []

        def __call__(self, params_grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().__call__(params_grads)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.norms.append((_grad_norm([g for _, g in params_grads]),
                               _grad_norm([g for _, g in out])))
            self.clip_seconds.append(t1 - t0)
            self.seconds.append(time.perf_counter() - t1)
            return out

    def ratio(p):
        return LOOP_RATIO if p is emb or p is head else 1.0
    clip = ObservedClip(LOOP_CLIP)
    opt = AdamW(learning_rate=sched, parameters=params, grad_clip=clip,
                lr_ratio=ratio, multi_precision=True,
                moment_dtype="bfloat16", fused=True)
    bucket_lrs = []
    real_bucket = optim_mod.fused_adamw_bucket

    def observed_bucket(grads, weights, m, v, scalars, param_dtype=None):
        bucket_lrs.append(float(scalars[0]))
        return real_bucket(grads, weights, m, v, scalars, param_dtype)

    counters = {"flash_attention_fwd": fa.flash_fwd,
                "flash_attention_dq": fa.flash_dq,
                "flash_attention_dkv": fa.flash_dkv}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():                # the main path starts
        fn.launches = fn.sm90_launches = 0
    fo.fused_adamw_bucket.launches = 0
    optim_mod.fused_adamw_bucket = observed_bucket
    losses, step_s, lrs, profiled = [], [], [], None
    try:
        for step in range(TRAIN_WARMUP + TRAIN_TIMED):
            before = {k: (fn.launches, fn.sm90_launches)
                      for k, fn in counters.items()}
            adamw0 = fo.fused_adamw_bucket.launches
            lr = sched()
            prof_step = step == TRAIN_WARMUP - 1
            ctx = (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
                if prof_step else contextlib.nullcontext())
            del bucket_lrs[:]
            torch.cuda.synchronize()
            ts = time.perf_counter()
            with ctx as prof:
                loss = model(ids, labels=labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                sched.step()
                torch.cuda.synchronize()
            dt = time.perf_counter() - ts
            losses.append(loss.item())
            lrs.append(lr)
            if prof_step:
                profiled = profile_summary(prof, dt)
            if step >= TRAIN_WARMUP:
                step_s.append(dt - clip.seconds[-1])
            got = {k: (fn.launches - before[k][0],
                       fn.sm90_launches - before[k][1])
                   for k, fn in counters.items()}
            want = {"flash_attention_fwd": (2 * L, 2 * L),
                    "flash_attention_dq": (L, L),
                    "flash_attention_dkv": (L, L)}
            n_adamw = fo.fused_adamw_bucket.launches - adamw0
            want_lrs = sorted(float(np.float32(lr * r))
                              for r in (LOOP_RATIO, 1.0))
            if got != want or n_adamw != 2 or len(opt._fused_buckets) != 2:
                raise AssertionError(f"step {step}: flash (launches, "
                                     f"wgmma) {got} != {want}, AdamW "
                                     f"{n_adamw} launches, "
                                     f"{len(opt._fused_buckets)} buckets")
            if sorted(bucket_lrs) != want_lrs:
                raise AssertionError(f"step {step}: bucket lrs "
                                     f"{bucket_lrs} != {want_lrs}")
            if not clip.norms[-1][1] <= LOOP_CLIP * (1 + 1e-2):
                raise AssertionError(f"step {step}: clipped norm "
                                     f"{clip.norms[-1][1]}")
    finally:
        optim_mod.fused_adamw_bucket = real_bucket
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["fused_adamw"] = fo.fused_adamw_bucket.launches
    peak = torch.cuda.max_memory_allocated()   # the main path ended
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_med = statistics.median(step_s)
    flops, _, attn_flops = llama_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit({"phase": "train_loop", "model": "llama_3_8b", "dtype": "bfloat16",
          "reduced": {"num_hidden_layers": [32, L]}, "layers": L,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "recompute": True,
          "optimizer": {"name": "AdamW", "lr": "LinearWarmup("
                        f"CosineAnnealingDecay({TRAIN_LR}, T_max="
                        f"{LOOP_T_MAX}), warmup_steps={LOOP_WARMUP_STEPS}, "
                        f"start_lr=0.0, end_lr={TRAIN_LR})",
                        "grad_clip": f"ClipGradByGlobalNorm({LOOP_CLIP})",
                        "lr_ratio": {"embed_tokens, lm_head": LOOP_RATIO,
                                     "rest": 1.0},
                        "multi_precision": True, "fused": True,
                        "moment_dtype": "bfloat16",
                        "buckets": len(opt._fused_buckets)},
          "recompute_vs_none": {"loss": [a["loss"], b["loss"]],
                                "grad_norm": [a["grad_norm"],
                                              b["grad_norm"]],
                                "relative": rel,
                                "loss_bitwise_equal": a["loss"] == b["loss"],
                                "grad_norm_bitwise_equal":
                                    a["grad_norm"] == b["grad_norm"],
                                "grads_bitwise_equal":
                                    compare["grads_bitwise_equal"],
                                "peak_above_start_bytes": [
                                    a["peak_above_start"],
                                    b["peak_above_start"]]},
          "losses": losses, "lrs": lrs,
          "grad_norms_pre_post_clip": clip.norms,
          "clip_ms": [t * 1e3 for t in clip.clip_seconds],
          "clip_observer_ms": [t * 1e3 for t in clip.seconds],
          "timed_step_ms": [t * 1e3 for t in step_s],
          "step_ms": step_med * 1e3,
          "step_ms_note": "wall less the phase's norm observer",
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_med,
          "flops_per_step": flops, "attention_flops_per_step": attn_flops,
          "mfu_vs_989tflops": flops / step_med / PEAK_FLOPS["bfloat16"],
          "kernel_launches": launches, "profiled_step": profiled,
          "max_memory_allocated": peak})
    return launches


# ------------------------------------------------------------ train_moe
def moe_step_flops(cfg, batch: int, seq: int):
    """Training FLOPs of one Qwen2-MoE step, the train phase's reckoning
    (6 x matmul parameters x tokens, plus 12 * L * B * S^2 * hidden for
    attention) over the work each token does: attention's projections,
    the router, its top-k routed experts, the shared expert and its
    gate, the head. Returns (active flops, executed flops, attention
    flops): executed counts every capacity slot the batched experts run
    (E x C rows a layer, empty slots included) in place of the tokens'
    top-k assignments."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    kvd = cfg.num_key_value_heads * h // cfg.num_attention_heads
    tokens = batch * seq
    expert = 3 * h * cfg.moe_intermediate_size
    per_token = (2 * h * h + 2 * h * kvd + h * cfg.num_experts
                 + cfg.num_experts_per_tok * expert
                 + 3 * h * cfg.shared_expert_intermediate_size + h)
    attn = 12.0 * L * batch * seq * seq * h
    active = 6.0 * (L * per_token + h * cfg.vocab_size) * tokens + attn
    capacity = max(1, int(cfg.capacity_factor * tokens
                          * cfg.num_experts_per_tok / cfg.num_experts))
    extra = (cfg.num_experts * capacity
             - cfg.num_experts_per_tok * tokens) * expert
    return active, active + 6.0 * L * extra, attn


def phase_train_moe(seed: int):
    """Qwen2-57B-A14B training at its published widths, depth cut 28 ->
    1, on the train phase's batch and optimizer setting; the MoE routing
    checked on the card against the CPU, at the step's capacity and at a
    quarter of it (where experts overflow). Returns the launches and the
    fused AdamW buckets, for `check_moe_adamw`. See the module
    docstring."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                                   qwen2_moe_a14b)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = qwen2_moe_a14b(num_hidden_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Qwen2MoeForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                generator=gen)
    opt = AdamW(TRAIN_LR, parameters=model.parameters(),
                multi_precision=True, fused=True, moment_dtype="bfloat16")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    layer = model.model.layers[0].mlp.moe
    captured = []                       # the first step's gate in and out
    gate_forward = layer.gate.forward

    def capture(x):
        out = gate_forward(x)
        if not captured:
            captured.append((x.detach().clone(), out.detach().clone()))
        return out
    layer.gate.forward = capture
    try:
        run = run_train_steps(model, opt, ids, labels,
                              cfg.num_hidden_layers, "train_moe")
    finally:
        layer.gate.forward = gate_forward

    # the bucket packing past 2**31 elements: every parameter is its
    # master's slice rounded to bf16, where the kernel wrote it
    buckets = fused_buckets(opt)
    params = opt._parameter_list
    packed_to = 0
    for bucket in buckets:
        flat = bucket["master"].view(-1)
        for idx, off, size, shp in bucket["layout"].entries:
            want = flat[off:off + size].view(shp).to(params[idx].dtype)
            if not torch.equal(params[idx].detach(), want):
                raise AssertionError(f"parameter {idx} at bucket offset "
                                     f"{off} is not its master's slice")
            packed_to = max(packed_to, off + size)
    del opt, want
    gc.collect()
    torch.cuda.empty_cache()

    # routing: the first step's bf16 gates, routed on the card and on
    # the CPU (the same tensor copied), must agree bitwise; at the
    # step's capacity (which may drop nothing) and at a quarter of it,
    # where the grouping order decides which tokens keep a slot
    x, gates = captured[0]
    T, k, E = gates.shape[0], layer.topk, layer.num_experts
    capacity = max(1, int(layer.capacity_factor * T * k / E))
    routing_equal, dropped, counts = {}, {}, None
    for cap in (capacity, capacity // 4):
        on_card = moe._route(gates, k, cap)
        on_cpu = moe._route(gates.cpu(), k, cap)
        equal = {n: torch.equal(a.cpu(), b)
                 for n, a, b in zip(on_card._fields, on_card, on_cpu)}
        slab_card = moe.moe_dispatch_combine(x, gates, k, cap)[0]
        slab_cpu = moe.moe_dispatch_combine(x.cpu(), gates.cpu(), k, cap)[0]
        equal["expert_in"] = torch.equal(slab_card.cpu(), slab_cpu)
        del slab_card, slab_cpu
        routing_equal[cap] = equal
        dropped[cap] = ((on_card.counts - cap).clamp_min(0).sum().item()
                        / (T * k))
        if counts is None:
            counts = on_card.counts
    if not all(all(eq.values()) for eq in routing_equal.values()):
        raise AssertionError(f"routing on the card differs from the CPU's: "
                             f"{routing_equal}")
    if not dropped[capacity // 4] > 0:
        raise AssertionError(f"capacity {capacity // 4} dropped nothing: "
                             f"the overflow order went unchecked")

    # one MoELayer forward + backward on the captured input with any host
    # sync raising; then the combine twice on the same inputs
    xg = x.clone().requires_grad_()
    dout = torch.randn(x.shape, generator=gen, device="cuda",
                       dtype=x.dtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = layer(xg)
        (out * dout).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    grads_finite = bool(torch.isfinite(xg.grad).all()) and all(
        bool(torch.isfinite(p.grad).all()) for p in layer.parameters())
    if not grads_finite:
        raise AssertionError("MoELayer gradients not finite")
    with torch.no_grad():
        expert_in, info, _ = moe.moe_dispatch_combine(x, gates, k, capacity)
        expert_out = layer.experts(expert_in)
        first = moe.moe_combine(expert_out, info, T)
        again = moe.moe_combine(expert_out, info, T)
    combine_equal = torch.equal(first, again)
    if not combine_equal:
        raise AssertionError("two combines of the same inputs differ")
    del xg, out, dout, expert_in, expert_out, first, again, info

    step_med = statistics.median(run["step_s"])
    active, executed, attn = moe_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit({"phase": "train_moe", "model": "qwen2_moe_a14b",
          "dtype": "bfloat16",
          "reduced": {"num_hidden_layers": [28, cfg.num_hidden_layers]},
          "layers": cfg.num_hidden_layers, "params": n_params,
          "experts": E, "topk": k, "capacity": capacity,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "optimizer": {"name": "AdamW", "lr": TRAIN_LR,
                        "multi_precision": True, "fused": True,
                        "moment_dtype": "bfloat16",
                        "buckets": run["buckets"]},
          "weights_build_s": build_s, "losses": run["losses"],
          "timed_step_ms": [t * 1e3 for t in run["step_s"]],
          "step_ms": step_med * 1e3,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_med,
          "flops_per_step_active": active,
          "flops_per_step_executed": executed,
          "attention_flops_per_step": attn,
          "mfu_vs_989tflops": active / step_med / PEAK_FLOPS["bfloat16"],
          "executed_vs_989tflops": (executed / step_med
                                    / PEAK_FLOPS["bfloat16"]),
          "dropped_assignment_share": dropped[capacity],
          "dropped_share_by_capacity": dropped,
          "expert_counts": counts.tolist(),
          "routing_card_equals_cpu_by_capacity": routing_equal,
          "moe_layer_sync_free": True, "combine_bitwise_repeat":
              combine_equal,
          "bucket_params_equal_master_slices": True,
          "bucket_elements_packed": packed_to,
          "kernel_launches": run["launches"],
          "flash_sm90_launches": run["sm90"],
          "profiled_step": run["profiled"],
          "max_memory_allocated": run["peak"]})
    return run["launches"], buckets


def check_moe_adamw(buckets, seed: int) -> list:
    """The AdamW kernel on train_moe's own buckets (3.10e9 elements at
    A14B, past 2**31), bitwise against its plain version chunk by chunk,
    then timed there. Returns the row's `train_moe_buckets` entry."""
    import torch
    from paddle_tpu_torch.kernels import fused_optimizer as fo

    out = []
    for bucket in buckets:
        master, m, v = bucket["master"], bucket["m"], bucket["v"]
        g, sc, _, err = check_adamw_bucket(bucket, seed)
        flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                device="cuda")
        ms = time_ms(lambda: fo.fused_adamw_bucket(
            g, master, m, v, sc, torch.bfloat16), flush_buf.zero_, reps=10,
            warmup=2)
        n = master.numel()
        nbytes = fo.adamw_update_bytes(n, param_width=2, moment_width=2,
                                       has_master=True, grad_width=2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 13 * n / PEAK_FLOPS["float32"] * 1e3
        out.append({"elements": n, "bitwise_equal": True,
                    "max_abs_err": err, "ms": ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "gb_per_s": nbytes / ms / 1e6})
        emit({"phase": "kernel_check", "kernel": "fused_adamw",
              "bucket_of": "train_moe", "elements": n,
              "bitwise_equal": {"bf16_params_fp32_master_bf16_moments":
                                True}, "max_abs_err": err, "ms": ms})
        del g, sc, flush_buf
    return out


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def flash_error(got, want, output: str, dtype: str):
    """(error, limit) of one flash output against its plain version.
    bf16 outputs: the relative error ||got - ref|| / ||ref||, limit 1e-2
    (bf16 output rounding, and P / dS rounded to bf16 before their
    products, give a few 1e-3; a bound on the largest element would pass
    a kernel that drops a tile of every row's terms, since the largest
    elements sit in the first rows, which see few keys). fp32 outputs:
    the max abs error, limit 1e-4 of max(1, max |ref|) (summation
    order). The lse is fp32 in both types: max abs error, limit 1e-4."""
    import torch
    d = got.float() - want.float()
    if output == "lse":
        return d.abs().max().item(), 1e-4
    if dtype == "bfloat16":
        return ((d.norm() / want.float().norm().clamp_min(1e-30)).item(),
                1e-2)
    return d.abs().max().item(), 1e-4 * max(1.0, want.float().abs().max()
                                            .item())


def flash_case(dtype: str, bh: int, sq: int, sk: int, d: int,
               causal: bool) -> str:
    return f"{dtype}_BH{bh}_S{sq}x{sk}_D{d}" + ("" if causal else "_nc")


def check_flash_kernels(seed: int):
    """The three flash kernels against their plain versions on seeded
    inputs at FLASH_SHAPES in bf16 (the wgmma kernels) and fp32
    (flash_attention.cu). Returns (errors, failures): errors[output][case]
    holds the measured error (see `flash_error`) and the max abs error;
    `dq_no_key_rows` the largest |dQ| over the query rows that see no key
    (limit 0: exactly zero); failures lists (output, case) of every check
    that missed its limit or gave a non-finite value. Launches here are
    not counted as the main path's."""
    import math
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    errs, failures = {}, []
    for bh, sq, sk, d, causal in FLASH_SHAPES:
        base = [torch.randn(bh, s_, d, generator=gen, device="cuda")
                for s_ in (sq, sk, sk, sq)]
        scale = 1.0 / math.sqrt(d)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).replace("torch.", "")
            case = flash_case(name, bh, sq, sk, d, causal)
            q, k, v, do = (t.to(dt) for t in base)
            out, lse = fa.flash_fwd(q, k, v, scale, causal)
            ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, scale, causal)
            delta = fa.flash_delta(ref_out, do)
            args = (q, k, v, do, ref_lse, delta, scale, causal)
            dq = fa.flash_dq(*args)
            dk, dv = fa.flash_dkv(*args)
            torch.cuda.synchronize()
            pairs = {"out": (out, ref_out), "lse": (lse, ref_lse),
                     "dq": (dq, fa.flash_dq_ref(*args))}
            pairs.update(zip(("dk", "dv"),
                             zip((dk, dv), fa.flash_dkv_ref(*args))))
            for output, (got, want) in pairs.items():
                err, lim = flash_error(got, want, output, name)
                errs.setdefault(output, {})[case] = {
                    "err": err, "limit": lim,
                    "max_abs": _max_err(got, want)}
                if not (err <= lim and torch.isfinite(got).all()):
                    failures.append((output, case))
            dead = ref_lse < fa.NEG_INF / 2        # rows that see no key
            if dead.any():
                worst = dq[dead].float().abs().max().item()
                errs.setdefault("dq_no_key_rows", {})[case] = {
                    "err": worst, "limit": 0.0, "rows": int(dead.sum())}
                if worst != 0.0:
                    failures.append(("dq_no_key_rows", case))
            del q, k, v, do, out, lse, ref_out, ref_lse, delta, args
            del dq, dk, dv, pairs
    return errs, failures


def flash_timings(BH: int, S: int, D: int, seed: int, flush):
    """The three flash kernels, their plain versions and SDPA timed on
    seeded bf16 (BH, S, D) tensors, causal; with each kernel's (flops,
    bytes). Returns {kernel: {"ms", "plain_ms", "library_ms", "flops",
    "bytes"}}."""
    import math
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.flash_delta(out, do)
    args = (q, k, v, do, lse, delta, scale, True)
    ms = {"fwd": time_ms(lambda: fa.flash_fwd(q, k, v, scale, True), flush),
          "dq": time_ms(lambda: fa.flash_dq(*args), flush),
          "dkv": time_ms(lambda: fa.flash_dkv(*args), flush)}
    plain = {"fwd": time_ms(lambda: fa.flash_fwd_ref(q, k, v, scale, True),
                            flush, reps=10, warmup=2),
             "dq": time_ms(lambda: fa.flash_dq_ref(*args), flush,
                           reps=10, warmup=2),
             "dkv": time_ms(lambda: fa.flash_dkv_ref(*args), flush,
                            reps=10, warmup=2)}
    # library yardstick, never called by the port: SDPA (B 1, H BH) on the
    # same tensors; its backward (dQ, dK, dV in one call) by subtraction
    q4, k4, v4, do4 = (t.view(1, BH, S, D) for t in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), flush)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do4)
    lib_bwd = time_ms(sdpa_fwd_bwd, flush) - lib_fwd

    pairs = S * (S + 1) // 2                      # causal (q, k) pairs
    qkv_bytes = BH * S * D * q.element_size()
    stats_bytes = BH * S * 4
    work = {"fwd": (4 * BH * D * pairs, 4 * qkv_bytes + stats_bytes),
            "dq": (6 * BH * D * pairs, 5 * qkv_bytes + 2 * stats_bytes),
            "dkv": (8 * BH * D * pairs, 6 * qkv_bytes + 2 * stats_bytes)}
    return {kern: {"ms": ms[kern], "plain_ms": plain[kern],
                   "library_ms": lib_fwd if kern == "fwd" else lib_bwd,
                   "flops": work[kern][0], "bytes": work[kern][1]}
            for kern in ms}


def phase_flash_kernels(launches, seed: int, card: str):
    """The three flash kernels at the training shape (and small ragged
    ones) against their plain versions, then timed there and at the
    train_moe phase's B*H 28."""
    import torch

    BH, S, _, D, _ = FLASH_SHAPES[0]                # B 1 x H 32, causal
    MOE_BH = FLASH_SHAPES[-1][0]                    # train_moe: H 28
    errs, failures = check_flash_kernels(seed)
    emit({"phase": "kernel_check", "kernel": "flash_attention",
          "errors": errs})
    if failures:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {failures}")

    # timing at the main paths' dtype and shapes
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timed = {bh: flash_timings(bh, S, D, seed + 4, flush_buf.zero_)
             for bh in (BH, MOE_BH)}
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}

    def worst(kern, dtype, bh, key):
        return max(errs[o][flash_case(dtype, bh, S, S, D, True)][key]
                   for o in outputs[kern])

    def at(kern, bh):
        t = timed[bh][kern]
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
        return {"max_abs_err": worst(kern, "bfloat16", bh, "max_abs"),
                "rel_err": worst(kern, "bfloat16", bh, "err"),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": t["library_ms"],
                "tflops_per_s": t["flops"] / t["ms"] / 1e9,
                "shape": {"BH": bh, "Sq": S, "Sk": S, "D": D,
                          "causal": True, "dtype": "bfloat16"},
                "bytes": t["bytes"], "flops": t["flops"]}
    rows = []
    for kern, (name, source, replaces) in zip(("fwd", "dq", "dkv"),
                                              KERNELS[1:4]):
        main = at(kern, BH)
        lse_err = ({"lse_max_abs_err": errs["lse"][flash_case(
            "bfloat16", BH, S, S, D, True)]["max_abs"]}
            if kern == "fwd" else {})
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "design": DESIGN.get(name, "mma.sync, flash_attention.cu"),
            "launches": launches[name],
            "max_abs_err": main.pop("max_abs_err"),
            "rel_err": main.pop("rel_err"), **lse_err,
            "max_abs_err_fp32": worst(kern, "float32", BH, "max_abs"),
            "ms": main["ms"], "kernel_ms": main["ms"], **main,
            "library": ("torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True)" if kern == "fwd" else
                        "scaled_dot_product_attention backward (dQ, dK, dV "
                        "in one call): fwd+bwd minus fwd"),
            "train_moe_shape": at(kern, MOE_BH), "card": card})
    return rows


def phase_decode_flash_kernel(launches, seed: int, card: str):
    """The wgmma flash forward at generate's decode shape (B*H 128, one
    query row, D 128, bf16, not causal) against its plain version at
    cache lengths from 1 to 1025 (`flash_error`'s limits), then timed at
    the first and the last decode step's cache beside the plain version,
    SDPA on the same q, k, v, and the bound: the bytes of q, K, V, out
    and lse once (the K/V read) over 3.35 TB/s."""
    import math
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    scale = 1.0 / math.sqrt(DECODE_D)
    errs, failures = {}, []
    for sk in DECODE_CHECK_SK:
        q, k, v = (torch.randn(DECODE_BH, s_, DECODE_D, generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for s_ in (1, sk, sk))
        out, lse = fa.flash_fwd(q, k, v, scale, False)
        ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, scale, False)
        torch.cuda.synchronize()
        for output, (got, want) in (("out", (out, ref_out)),
                                    ("lse", (lse, ref_lse))):
            err, lim = flash_error(got, want, output, "bfloat16")
            errs.setdefault(output, {})[f"Sk{sk}"] = {
                "err": err, "limit": lim, "max_abs": _max_err(got, want)}
            if not (err <= lim and torch.isfinite(got).all()):
                failures.append((output, sk))
    emit({"phase": "kernel_check", "kernel": "flash_attention_fwd_decode",
          "shape": {"BH": DECODE_BH, "Sq": 1, "D": DECODE_D,
                    "causal": False, "dtype": "bfloat16"},
          "errors": errs})
    if failures:
        raise AssertionError(f"the flash forward at Sq 1 disagrees with its "
                             f"plain version: {failures}")

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    times = {}
    for sk in DECODE_TIME_SK:
        q, k, v = (torch.randn(DECODE_BH, s_, DECODE_D, generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for s_ in (1, sk, sk))
        q4, k4, v4 = (t.view(1, DECODE_BH, -1, DECODE_D) for t in (q, k, v))
        nbytes = (2 * DECODE_BH * sk * DECODE_D * 2
                  + 2 * DECODE_BH * DECODE_D * 2 + DECODE_BH * 4)
        flops = 4 * DECODE_BH * sk * DECODE_D
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        times[sk] = {
            "ms": time_ms(lambda: fa.flash_fwd(q, k, v, scale, False),
                          flush_buf.zero_),
            "plain_ms": time_ms(lambda: fa.flash_fwd_ref(q, k, v, scale,
                                                         False),
                                flush_buf.zero_),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4), flush_buf.zero_),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}
        times[sk]["gb_per_s"] = nbytes / times[sk]["ms"] / 1e6
    last = times[DECODE_TIME_SK[-1]]
    name, source, replaces = KERNEL["flash_attention_fwd_decode"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "design": DESIGN[name],
            "launches": launches,
            "max_abs_err": max(e["max_abs"] for e in errs["out"].values()),
            "rel_err": max(e["err"] for e in errs["out"].values()),
            "lse_max_abs_err": max(e["max_abs"]
                                   for e in errs["lse"].values()),
            "ms": last["ms"], "kernel_ms": last["ms"],
            "plain_ms": last["plain_ms"], "bound_ms": last["bound_ms"],
            "bound_by": last["bound_by"], "library_ms": last["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(q (1, 128, 1, 128), not causal)",
            "by_cache_length": {f"Sk{sk}": t for sk, t in times.items()},
            "shape": {"BH": DECODE_BH, "Sq": 1, "Sk": DECODE_TIME_SK[-1],
                      "D": DECODE_D, "causal": False, "dtype": "bfloat16"},
            "bytes": last["bytes"], "flops": last["flops"], "card": card}


def check_adamw_bucket(bucket, seed: int):
    """The AdamW kernel on a training phase's own bucket (fp32 master,
    bf16 moments) with a seeded bf16 gradient, bitwise against the plain
    version chunk by chunk. The bucket is left updated. Returns (grad,
    scalars, new bf16 parameters, max abs error)."""
    import torch
    from paddle_tpu_torch.kernels import fused_optimizer as fo

    master, m, v = bucket["master"], bucket["m"], bucket["v"]
    rows = master.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    g = torch.empty(rows, fo.LANES, dtype=torch.bfloat16, device="cuda")
    for r in range(0, rows, ADAMW_CHUNK_ROWS):
        g[r:r + ADAMW_CHUNK_ROWS].normal_(0.0, 1e-3, generator=gen)
    sc = fo.adamw_scalars(TRAIN_LR, 0.9, 0.999, 1e-8, 0.01,
                          bucket["step"] + 1, device="cuda")
    w0, m0, v0 = master.clone(), m.clone(), v.clone()
    p_new, _, _, _ = fo.fused_adamw_bucket(g, master, m, v, sc,
                                           torch.bfloat16)
    torch.cuda.synchronize()
    err = 0.0
    for r in range(0, rows, ADAMW_CHUNK_ROWS):
        sl = slice(r, r + ADAMW_CHUNK_ROWS)
        want = fo.fused_adamw_bucket_ref(g[sl], w0[sl], m0[sl], v0[sl], sc,
                                         torch.bfloat16)
        for got, ref in zip((p_new[sl], master[sl], m[sl], v[sl]), want):
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"fused_adamw rows {r}+: not bitwise "
                                     f"equal, max {_max_err(got, ref)}")
            err = max(err, _max_err(got, ref))
    return g, sc, p_new, err


def phase_adamw_kernel(launches, bucket, seed: int, card: str):
    """The AdamW kernel on the train phase's own bucket (fp32 master,
    bf16 moments) with a seeded bf16 gradient, bitwise against the plain
    version chunk by chunk; fp32 state on a slice; then timed."""
    import torch
    from paddle_tpu_torch.kernels import fused_optimizer as fo

    master, m, v = bucket["master"], bucket["m"], bucket["v"]
    rows, n = master.shape[0], master.numel()
    chunk_rows = ADAMW_CHUNK_ROWS
    g, sc, p_new, err = check_adamw_bucket(bucket, seed)
    step = bucket["step"] + 1
    # fp32 parameters and fp32 moments, on the first 2**27 elements
    sl = slice(0, chunk_rows)
    args32 = [t[sl].float() for t in (g, master, m, v)]
    want = fo.fused_adamw_bucket_ref(*args32, sc)
    got = fo.fused_adamw_bucket(*args32, sc)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"fused_adamw fp32: not bitwise equal, max "
                                 f"{_max_err(a, b)}")
    del args32, want, got
    emit({"phase": "kernel_check", "kernel": "fused_adamw",
          "bucket_of": "train", "elements": n,
          "bitwise_equal": {"bf16_params_fp32_master_bf16_moments": True,
                            "fp32_state_2pow27_slice": True},
          "max_abs_err": err})

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: fo.fused_adamw_bucket(
        g, master, m, v, sc, torch.bfloat16), flush_buf.zero_, reps=10,
        warmup=2)

    # the plain version runs chunk by chunk: on the whole bucket at once
    # its fp32 temporaries would need ~60 GB
    def plain():
        for r in range(0, rows, chunk_rows):
            s_ = slice(r, r + chunk_rows)
            fo.fused_adamw_bucket_ref(g[s_], master[s_], m[s_], v[s_], sc,
                                      torch.bfloat16)
    plain_ms = time_ms(plain, flush_buf.zero_, reps=5, warmup=1)
    # library yardstick, never called by the port: torch._fused_adamw_ on
    # the same bf16 tensors (it takes one dtype for params, grads and
    # moments, so the bf16 parameters stand in for the fp32 master)
    step_t = torch.tensor(float(step), device="cuda")
    library_ms = time_ms(lambda: torch._fused_adamw_(
        [p_new], [g], [m], [v], [], [step_t], lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False), flush_buf.zero_, reps=10, warmup=2)
    nbytes = fo.adamw_update_bytes(n, param_width=2, moment_width=2,
                                   has_master=True, grad_width=2)
    flops = 13 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    name, source, replaces = KERNELS[4]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library": "torch._fused_adamw_ on the bf16 param, grad and "
                       "moment buckets (no master: 16 B/element)",
            "gb_per_s": nbytes / kernel_ms / 1e6,
            "shape": {"elements": n, "rows": rows, "lanes": fo.LANES,
                      "grad": "bfloat16", "master": "float32",
                      "moments": "bfloat16", "param_out": "bfloat16"},
            "bytes": nbytes, "flops": flops, "card": card}


# ------------------------------------------------------ packed attention
def pack_documents(seed: int, total: int = PACK_TOKENS):
    """Seeded document lengths in PACK_DOC_LENS filling `total` tokens,
    the last cut to fit."""
    import numpy as np
    rng = np.random.RandomState(seed + 12)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.randint(PACK_DOC_LENS[0], PACK_DOC_LENS[1] + 1)))
    lens[-1] -= sum(lens) - total
    return lens


def packed_pairs(lens, window=None) -> int:
    """Allowed (q, k) pairs per head: causal within each document, or
    the causal sliding window over the whole row (w + 1 keys a row)."""
    if window is None:
        return sum(n * (n + 1) // 2 for n in lens)
    S = sum(lens)
    return sum(min(r, window) + 1 for r in range(S))


def packed_masks(lens):
    """The mask kwargs of the flash entries for each packed_attention
    entry kind, on the card: "varlen" (the documents as segment rows),
    "document" (C 1 bounds, each column's document end) and "window"
    (C 1 bounds min(c + PACK_WINDOW + 1, S), what window_size gives)."""
    import numpy as np
    import torch
    S = sum(lens)

    def bounds(b):
        return torch.tensor(b, dtype=torch.int32, device="cuda").view(1, 1, S)
    return {"varlen": dict(seg=_segment_rows(lens, lens), H=PACK_HEADS),
            "document": dict(fm=bounds(np.repeat(np.cumsum(lens), lens)),
                             fm_causal=True, H=PACK_HEADS),
            "window": dict(fm=bounds(np.minimum(np.arange(S) + PACK_WINDOW
                                                + 1, S)),
                           fm_causal=True, H=PACK_HEADS)}


def kernel_tile(dtype, D: int) -> int:
    """The flash kernels' tile rows (csrc Cfg::kTile): 64, or 32 for fp32
    at head_dim > 128."""
    import torch
    return 32 if dtype == torch.float32 and D > 128 else 64


def masked_visits(q, k, v, do, kw, causal, scale):
    """One counted launch of each masked kernel on (BH, S, D) inputs:
    ({"fwd", "dq", "dkv": tile pairs the kernel visited}, the plain
    version's count `flash_visits_ref`, the tile pairs of the grid), all
    summed over B*H."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    counts = {kern: torch.zeros(1, dtype=torch.int32, device=q.device)
              for kern in ("fwd", "dq", "dkv")}
    out, lse = fa.flash_fwd(q, k, v, scale, causal, visits=counts["fwd"],
                            **kw)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), scale, causal)
    fa.flash_dq(*args, visits=counts["dq"], **kw)
    fa.flash_dkv(*args, visits=counts["dkv"], **kw)
    BH, Sq, D = q.shape
    Sk, tile = k.shape[1], kernel_tile(q.dtype, D)
    plain = fa.flash_visits_ref(BH, Sq, Sk, causal, tile=tile, **kw)
    grid = BH * -(-Sq // tile) * -(-Sk // tile)
    return {kern: int(c.item()) for kern, c in counts.items()}, plain, grid


def packed_inputs(seed: int, lens, dtype=None):
    """q (S, 32, 128) and k/v (the 8 KV heads repeated to 32) and a
    seeded dout, bf16 by default, on the card."""
    import torch
    dtype = dtype or torch.bfloat16
    S, H, KVH, D = sum(lens), PACK_HEADS, PACK_KV_HEADS, PACK_DIM
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)

    def draw(heads):
        return torch.randn(S, heads, D, generator=gen, device="cuda")
    q = draw(H).to(dtype)
    k, v = (draw(KVH).repeat_interleave(H // KVH, dim=1).to(dtype)
            for _ in range(2))
    return q, k, v, draw(H).to(dtype)


def packed_entries(lens):
    """The four entry points of packed_attention, each a function of its
    leaves (q, k, v, or the packed qkv) -> out (S, H, D), and how to build
    the leaves from (q, k, v)."""
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.nn import functional as F
    S, D = sum(lens), PACK_DIM
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32,
                      device="cuda")
    ends = torch.tensor(np.repeat(np.cumsum(lens), lens), dtype=torch.int32,
                        device="cuda").view(1, 1, S, 1)
    mx, scale = max(lens), 1.0 / math.sqrt(D)
    three = (lambda q, k, v: (q, k, v))
    return {
        "flash_attn_unpadded": (three, lambda q, k, v: F.flash_attn_unpadded(
            q, k, v, cu, cu, mx, mx, scale, causal=True)[0]),
        "flash_attn_varlen_qkvpacked": (
            lambda q, k, v: (torch.stack([q, k, v], dim=1),),
            lambda qkv: F.flash_attn_varlen_qkvpacked(
                qkv, cu, cu, mx, mx, scale, causal=True)[0]),
        "flashmask_document": (three, lambda q, k, v: F.flashmask_attention(
            q[None], k[None], v[None], ends, causal=True)[0]),
        "flashmask_window": (three, lambda q, k, v: F.flashmask_attention(
            q[None], k[None], v[None], window_size=PACK_WINDOW,
            causal=True)[0]),
    }


def _fwd_bwd(fn, leaves, dout):
    import torch
    xs = [t.detach().requires_grad_() for t in leaves]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, dout)
    return out.detach(), grads


def phase_packed_attention(seed: int):
    """Forward + backward at Llama-3-8B's attention widths over one packed
    row of documents, through flash_attn_unpadded (causal, the
    documents' cu_seqlens), flash_attn_varlen_qkvpacked (the same data),
    flashmask_attention with the causal document mask (C 1, each column's
    bound its document's end) and with window_size=PACK_WINDOW: 2 warm-up
    and 4 timed calls each. Checks each call launched its variant's fwd,
    dQ and dK/dV kernels once, every output and gradient finite, each
    document isolated bitwise, the varlen and document-mask entries in
    agreement, and one whole-row document against the plain causal
    kernel. Returns the main path's launches and the documents."""
    import math
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    lens = pack_documents(seed)
    S, H, D = sum(lens), PACK_HEADS, PACK_DIM
    q, k, v, dout = packed_inputs(seed, lens)
    entries = packed_entries(lens)
    fns = {"fwd": fa.flash_fwd, "dq": fa.flash_dq, "dkv": fa.flash_dkv}
    results, per_entry = {}, {}
    for f in fns.values():                       # the main path starts
        f.launches = f.varlen_launches = f.flashmask_launches = 0
        f.sm90_launches = 0
    for name, (make, fn) in entries.items():
        leaves = make(q, k, v)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        times = []
        for i in range(PACK_WARMUP + PACK_TIMED):
            t0 = time.perf_counter()
            res = _fwd_bwd(fn, leaves, dout)
            torch.cuda.synchronize()
            if i >= PACK_WARMUP:
                times.append(time.perf_counter() - t0)
        results[name] = res
        # what the calls added on top of what was already allocated
        per_entry[name] = {"ms": [t * 1e3 for t in times],
                           "peak_bytes_above_start":
                               torch.cuda.max_memory_allocated() - start}
    launches = {f"{kind}_{k_}": getattr(f, f"{kind}_launches")
                for kind in ("varlen", "flashmask")
                for k_, f in fns.items()}
    plain = {k_: f.launches for k_, f in fns.items()}
    sm90 = {k_: f.sm90_launches for k_, f in fns.items()}
    # the main path ended
    calls = 2 * (PACK_WARMUP + PACK_TIMED)      # two entry points a variant
    if set(launches.values()) != {calls} or any(plain.values()):
        raise AssertionError(f"packed_attention launches {launches} (want "
                             f"{calls} each), plain-mode {plain} (want 0)")
    # every masked forward, dQ and dK/dV on the wgmma kernels
    if sm90 != {"fwd": 2 * calls, "dq": 2 * calls, "dkv": 2 * calls}:
        raise AssertionError(f"packed_attention wgmma launches {sm90} (want "
                             f"{2 * calls} each)")
    for name, (out, grads) in results.items():
        if not all(torch.isfinite(t).all() for t in (out,) + grads):
            raise AssertionError(f"{name}: non-finite output or gradient")
    # the tile pairs each kind's kernels visit, counted by the kernels on
    # the masks its entry points build, against the plain predicate
    visits = {}
    qh, kh, vh, doh = (t.transpose(0, 1).contiguous()
                       for t in (q, k, v, dout))
    for kind, kw in packed_masks(lens).items():
        got, want, grid = masked_visits(qh, kh, vh, doh, kw, True,
                                        1.0 / math.sqrt(D))
        if set(got.values()) != {want}:
            raise AssertionError(f"{kind}: the kernels visited {got} tile "
                                 f"pairs, the plain predicate {want}")
        visits[kind] = {"tiles_visited_per_head": got["fwd"] // H,
                        "tiles_in_grid_per_head": grid // H}
    del qh, kh, vh, doh

    # agreement: the varlen and document-mask entries compute one function
    agree = {}
    a, c = results["flash_attn_unpadded"], results["flashmask_document"]
    for o, (got, want) in zip(("out", "dq", "dk", "dv"),
                              zip((c[0],) + c[1], (a[0],) + a[1])):
        err, lim = flash_error(got, want, o, "bfloat16")
        agree[o] = {"err": err, "limit": lim, "bitwise": torch.equal(got,
                                                                     want)}
        if not err <= lim:
            raise AssertionError(f"varlen and flashmask disagree on {o}: "
                                 f"{err} > {lim}")
    # isolation: one document's q/k/v changed, every other row bitwise equal
    j = len(lens) // 2
    lo = sum(lens[:j])
    other = torch.ones(S, dtype=torch.bool, device="cuda")
    other[lo:lo + lens[j]] = False
    q2, k2, v2 = (t.clone() for t in (q, k, v))
    for t in (q2, k2, v2):
        t[lo:lo + lens[j]] = t[lo:lo + lens[j]] * -1.5 + 0.25
    isolated = {}
    for name in ("flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
                 "flashmask_document"):
        make, fn = entries[name]
        out2, grads2 = _fwd_bwd(fn, make(q2, k2, v2), dout)
        out, grads = results[name]
        # rows are tokens in every output and gradient (qkv's included)
        same = all(torch.equal(x[other], y[other])
                   for x, y in zip((out,) + grads, (out2,) + grads2))
        changed = not torch.equal(out[~other], out2[~other])
        isolated[name] = same
        if not (same and changed):
            raise AssertionError(f"{name}: document {j} leaks into the "
                                 f"others (or its own rows did not change)")
    # one document spanning the row against the plain causal kernel
    whole = packed_entries([S])["flash_attn_unpadded"][1]
    got = _fwd_bwd(whole, (q, k, v), dout)
    want = _fwd_bwd(lambda a_, b_, c_: fa.flash_attention_bshd(
        a_[None], b_[None], c_[None], causal=True)[0], (q, k, v), dout)
    single = {}
    for o, x, y in zip(("out", "dq", "dk", "dv"), (got[0],) + got[1],
                       (want[0],) + want[1]):
        err, lim = flash_error(x, y, o, "bfloat16")
        single[o] = {"err": err, "limit": lim, "bitwise": torch.equal(x, y)}
        if not err <= lim:
            raise AssertionError(f"one-document varlen != causal flash on "
                                 f"{o}: {err} > {lim}")
    # a profiled call of each entry point: device time and launches by kind
    for name, (make, fn) in entries.items():
        leaves = make(q, k, v)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _fwd_bwd(fn, leaves, dout)
            torch.cuda.synchronize()
        per_entry[name]["profiled_call"] = profile_summary(
            prof, time.perf_counter() - t0)
    for name, rec in per_entry.items():
        ms = statistics.median(rec["ms"])
        kind = ("varlen" if "flashmask" not in name
                else name.split("_", 1)[1])
        pairs = H * packed_pairs(lens, PACK_WINDOW if kind == "window"
                                 else None)
        tiles = visits["varlen" if kind == "varlen" else kind]
        rec.update({"ms_median": ms, "allowed_pairs": pairs,
                    "flops": 18 * D * pairs,
                    "tflops_per_s": 18 * D * pairs / ms / 1e9, **tiles,
                    "tile_share": tiles["tiles_visited_per_head"]
                    / tiles["tiles_in_grid_per_head"]})
    emit({"phase": "packed_attention", "tokens": S, "heads": H,
          "kv_heads_repeated": PACK_KV_HEADS, "head_dim": D,
          "dtype": "bfloat16", "documents": len(lens), "doc_lens": lens,
          "window": PACK_WINDOW, "warmup": PACK_WARMUP, "timed": PACK_TIMED,
          "flops_basis": "18 * D per allowed (q, k) pair and head: fwd 4, "
                         "dQ 6, dK/dV 8 (the kernels' products)",
          "entries": per_entry, "kernel_launches": launches,
          "plain_mode_launches": plain, "sm90_launches": sm90,
          "varlen_vs_flashmask": agree,
          "isolated_document": j, "isolation_bitwise": isolated,
          "single_document_vs_causal_flash": single})
    return {f"flash_attention_{k_}" if k_.startswith("varlen") else
            f"flashmask_attention_{k_.split('_')[1]}": n
            for k_, n in launches.items()}, lens


def _by_head_groups(fn, args, kw, group: int = 8):
    """A plain flash version over head groups of `group` (its fp32 score
    tensors at S 8192 stay ~2 GB each), joined along B*H. `args` are
    (BH, ...) tensors or scalars; the segment rows and flashmask bounds in
    `kw` are cut to each group's batch row (or heads, for Hm = H)."""
    import torch
    BH, H = args[0].shape[0], kw.get("H", 1)
    if BH <= group:
        return fn(*args, **kw)
    if H % group:
        raise ValueError(f"H {H} is not a multiple of the group {group}")
    parts = []
    for h0 in range(0, BH, group):
        b = h0 // H
        sub = dict(kw, H=group)
        if kw.get("seg") is not None:
            sub["seg"] = tuple(s_[b:b + 1] for s_ in kw["seg"])
        if kw.get("fm") is not None:
            fm = kw["fm"]
            sub["fm"] = fm[h0:h0 + group] if fm.shape[0] == BH \
                else fm[b:b + 1]
        parts.append(fn(*[a[h0:h0 + group] if torch.is_tensor(a) else a
                          for a in args], **sub))
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p_, dim=0) for p_ in zip(*parts))
    return torch.cat(parts, dim=0)


def _segment_rows(lens_q, lens_k, B=1):
    """(segq, segk) (B, 2, S) int32 rows [id; causal position], query
    positions shifted by each sequence's k_len - q_len."""
    import numpy as np
    import torch

    def rows(lens, shift):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
        pos = np.concatenate([np.arange(n) + d for n, d in zip(lens, shift)])
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            np.stack([ids, pos]), (B, 2, sum(lens))), dtype=np.int32)).cuda()
    shift = [kl - ql for ql, kl in zip(lens_q, lens_k)]
    return rows(lens_q, shift), rows(lens_k, [0] * len(lens_k))


def _bounds(kind, B, Hm, S):
    """(B*Hm, C, S) int32 flashmask bounds, fm_causal: a causal band of
    width 24 + 16·head (C 2), non-causal C 2 (+-20) and C 4."""
    import numpy as np
    import torch
    col = np.arange(S)
    w = (24 + 16 * (np.arange(B * Hm) % Hm))[:, None, None]
    if kind == "band":
        b, causal = [np.minimum(col + w, S), np.full((B * Hm, 1, S), S)], True
    elif kind == "nc2":
        b, causal = [np.minimum(col + w, S), np.maximum(col - w, 0)], False
    else:
        b, causal = [np.minimum(col + w // 2, S), np.minimum(col + w, S),
                     np.zeros((B * Hm, 1, S), int),
                     np.maximum(col - w, 0)], False
    b = [np.broadcast_to(x, (B * Hm, 1, S)) for x in b]
    return torch.from_numpy(np.concatenate(b, 1).astype(np.int32)).cuda(), \
        causal


def packed_cases(seed: int, lens):
    """{case: (q, k, v, dout (BH, S, D) fp32, masks kw, causal)} of the
    masked flash checks: the phase's documents at full width (B*H 32,
    S 8192, D 128) with each entry kind's masks (`packed_masks`: segments,
    the causal document mask, the window), and small ragged ones —
    varlen with non-uniform q/k lengths (Sq 100 != Sk 148, not tile
    multiples; D 64), flashmask causal C 2, non-causal C 2 and C 4, and
    per-head bounds (Hm = H)."""
    import torch
    q, k, v, do = (t.float().transpose(0, 1).contiguous()
                   for t in packed_inputs(seed, lens, torch.float32))
    full = {"varlen": "varlen_full", "document": "flashmask_doc_full",
            "window": "flashmask_window_full"}
    cases = {full[kind]: (q, k, v, do, kw, True)
             for kind, kw in packed_masks(lens).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)

    def draw(bh, s, d):
        return torch.randn(bh, s, d, generator=gen, device="cuda")
    lq, lk = [40, 9, 51], [60, 25, 63]
    cases["varlen_ragged"] = (draw(4, 100, 64), draw(4, 148, 64),
                              draw(4, 148, 64), draw(4, 100, 64),
                              dict(seg=_segment_rows(lq, lk, B=2), H=2), True)
    for name, kind, (B, H, S_, D) in (
            ("flashmask_band_c2", "band", (1, 2, 136, 128)),
            ("flashmask_nc2", "nc2", (1, 2, 136, 64)),
            ("flashmask_nc4", "nc4", (1, 3, 160, 64)),
            ("flashmask_heads", "band", (2, 3, 130, 64))):
        fm, causal = _bounds(kind, B, H if name.endswith("heads") else 1, S_)
        x = [draw(B * H, S_, D) for _ in range(4)]
        cases[name] = (*x, dict(fm=fm, fm_causal=causal, H=H), causal)
    return cases


def check_packed_kernels(seed: int, lens=None):
    """The six masked flash kernels (segment and flashmask modes of fwd,
    dQ, dK/dV) against their plain versions on `packed_cases`, in bf16
    and fp32, with `flash_error`'s limits, and the tile pairs each
    visited against the plain predicate (`flash_visits_ref`): bf16 at
    head_dim <= 128 (every case here) runs the wgmma kernels — the
    forward of flash_fwd_sm90.cu, dQ and dK/dV of flash_bwd_sm90.cu —
    and fp32 flash_attention.cu's. Returns
    (errors, failures): errors[output][case], errors["tiles"][case];
    failures the (output, case) that missed or gave a non-finite value,
    ("tiles", case) where a kernel's count differs. Launches here are
    not the main path's."""
    import math
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    lens = lens or pack_documents(seed)
    errs, failures = {}, []
    for name, (q0, k0, v0, do0, kw, causal) in packed_cases(seed,
                                                           lens).items():
        scale = 1.0 / math.sqrt(q0.shape[-1])
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).replace("torch.", "")
            case = f"{name}_{dname}"
            q, k, v, do = (t.to(dt) for t in (q0, k0, v0, do0))
            counts = torch.zeros(3, dtype=torch.int32, device="cuda")
            out, lse = fa.flash_fwd(q, k, v, scale, causal,
                                    visits=counts[0:1], **kw)
            ref_out, ref_lse = _by_head_groups(
                fa.flash_fwd_ref, (q, k, v, scale, causal), kw)
            delta = fa.flash_delta(ref_out, do)
            args = (q, k, v, do, ref_lse, delta, scale, causal)
            dq = fa.flash_dq(*args, visits=counts[1:2], **kw)
            dk, dv = fa.flash_dkv(*args, visits=counts[2:3], **kw)
            torch.cuda.synchronize()
            BH, Sq, D = q.shape
            tile = kernel_tile(dt, D)
            want = fa.flash_visits_ref(BH, Sq, k.shape[1], causal, tile=tile,
                                       **kw)
            got = dict(zip(("fwd", "dq", "dkv"), counts.tolist()))
            errs.setdefault("tiles", {})[case] = {
                **got, "plain": want,
                "grid": BH * -(-Sq // tile) * -(-k.shape[1] // tile)}
            if set(got.values()) != {want}:
                failures.append(("tiles", case))
            pairs = {"out": (out, ref_out), "lse": (lse, ref_lse),
                     "dq": (dq, _by_head_groups(fa.flash_dq_ref, args, kw))}
            pairs.update(zip(("dk", "dv"), zip(
                (dk, dv), _by_head_groups(fa.flash_dkv_ref, args, kw))))
            for output, (got, want) in pairs.items():
                if output == "lse":         # rows that see no key: -1e30
                    live = want > -1e29
                    got, want = got[live], want[live]
                err, lim = flash_error(got, want, output, dname)
                errs.setdefault(output, {})[case] = {
                    "err": err, "limit": lim,
                    "max_abs": _max_err(got, want)}
                if not (err <= lim and torch.isfinite(got).all()):
                    failures.append((output, case))
            del q, k, v, do, out, lse, ref_out, ref_lse, delta, args
            del dq, dk, dv, pairs
    return errs, failures


def phase_packed_kernels(launches, lens, seed: int, card: str):
    """The masked flash kernels against their plain versions, then each
    timed at the phase's full-width shape (bf16, the documents as
    segments and as the causal document mask) beside its plain version,
    SDPA with the equivalent dense boolean mask, and its bound from the
    allowed pairs."""
    import math
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    errs, failures = check_packed_kernels(seed, lens)
    emit({"phase": "kernel_check", "kernel": "flash_attention_masked",
          "errors": errs})
    if failures:
        raise AssertionError(f"masked flash kernels disagree with their "
                             f"plain versions: {failures}")
    S, H, D = sum(lens), PACK_HEADS, PACK_DIM
    q, k, v, do = (t.transpose(0, 1).contiguous()
                   for t in packed_inputs(seed, lens))       # (H, S, D)
    scale = 1.0 / math.sqrt(D)
    masks = packed_masks(lens)
    variants = {"varlen": masks["varlen"], "flashmask": masks["document"]}
    ids = torch.repeat_interleave(torch.arange(len(lens), device="cuda"),
                                  torch.tensor(lens, device="cuda"))
    pos = torch.arange(S, device="cuda")
    dense = ((ids[:, None] == ids[None, :])
             & (pos[None, :] <= pos[:, None]))[None, None]   # (1,1,S,S)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fl = flush_buf.zero_
    pairs = H * packed_pairs(lens)
    e = q.element_size()
    qkv_bytes, stats_bytes = H * S * D * e, H * S * 4
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=dense), fl, reps=10, warmup=2)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=dense)
        torch.autograd.grad(o, (qg, kg, vg), do4)
    lib_bwd = time_ms(sdpa_fwd_bwd, fl, reps=10, warmup=2) - lib_fwd
    del qg, kg, vg
    rows = []
    for variant, kw in variants.items():
        mask_bytes = (2 * 2 * S * 4 if variant == "varlen" else S * 4)
        # the tile summaries, built once a call by the autograd Functions
        masks_ = (kw.get("seg"), kw.get("fm"), kw.get("fm_causal", True))
        summ_ms = time_ms(lambda: fa.tile_summary(*masks_), fl)
        kern_kw = dict(kw, summary=fa.tile_summary(*masks_))
        out, lse = fa.flash_fwd(q, k, v, scale, True, **kern_kw)
        delta = fa.flash_delta(out, do)
        args = (q, k, v, do, lse, delta, scale, True)
        ms = {"fwd": time_ms(lambda: fa.flash_fwd(q, k, v, scale, True,
                                                  **kern_kw), fl),
              "dq": time_ms(lambda: fa.flash_dq(*args, **kern_kw), fl),
              "dkv": time_ms(lambda: fa.flash_dkv(*args, **kern_kw), fl)}
        plain = {
            "fwd": time_ms(lambda: _by_head_groups(
                fa.flash_fwd_ref, (q, k, v, scale, True), kw), fl, reps=5,
                warmup=1),
            "dq": time_ms(lambda: _by_head_groups(fa.flash_dq_ref, args, kw),
                          fl, reps=5, warmup=1),
            "dkv": time_ms(lambda: _by_head_groups(fa.flash_dkv_ref, args,
                                                   kw), fl, reps=5,
                           warmup=1)}
        work = {"fwd": (4 * D * pairs, 4 * qkv_bytes + stats_bytes),
                "dq": (6 * D * pairs, 5 * qkv_bytes + 2 * stats_bytes),
                "dkv": (8 * D * pairs, 6 * qkv_bytes + 2 * stats_bytes)}
        outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
        case = f"{variant}_full" if variant == "varlen" \
            else "flashmask_doc_full"
        tiles = errs["tiles"][f"{case}_bfloat16"]
        for kern in ("fwd", "dq", "dkv"):
            flops, nbytes = work[kern]
            nbytes += mask_bytes
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
            rname = (f"flash_attention_varlen_{kern}" if variant == "varlen"
                     else f"flashmask_attention_{kern}")
            name, source, replaces = KERNEL[rname]
            worst = {key: max(errs[o][f"{case}_{dt}"][key]
                              for o in outputs[kern])
                     for key, dt in (("max_abs", "bfloat16"),
                                     ("err", "bfloat16"))}
            worst32 = max(errs[o][f"{case}_float32"]["max_abs"]
                          for o in outputs[kern])
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "entry": PACK_ENTRY[variant],
                "design": DESIGN.get(name, "mma.sync, flash_attention.cu"),
                "launches": launches[name],
                "max_abs_err": worst["max_abs"], "rel_err": worst["err"],
                "max_abs_err_fp32": worst32,
                "ms": ms[kern], "kernel_ms": ms[kern],
                "tile_summary_ms": summ_ms,
                "tile_summary_note": "the plain torch ops that build the "
                                     "skip predicate's summaries, once per "
                                     "fwd + bwd call, not in ms",
                "plain_ms": plain[kern], "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib_fwd if kern == "fwd" else lib_bwd,
                "library": ("torch.nn.functional.scaled_dot_product_attention"
                            " with the dense (S, S) boolean document mask" +
                            ("" if kern == "fwd" else
                             ": backward (dQ, dK, dV in one call), fwd+bwd "
                             "minus fwd")),
                "tflops_per_s": flops / ms[kern] / 1e9,
                "allowed_pairs": pairs,
                "tiles_visited": tiles[kern], "tiles_in_grid": tiles["grid"],
                "tiles_note": "(q tile, k tile) pairs over B*H, counted by "
                              "the kernel in the bf16 check",
                "shape": {"BH": H, "S": S, "D": D, "documents": len(lens),
                          "causal": True, "dtype": "bfloat16"},
                "bytes": nbytes, "flops": flops, "card": card})
        del out, lse, delta, args
    return rows


# ----------------------------------------------------------- RMSNorm rows
def check_norm_kernel(seed: int):
    """rms_norm_rows against its plain version at NORM_SHAPES, bf16 and
    fp32 x, with an fp32 weight and one in x's dtype (the timed inputs),
    with and without the residual: bf16 within one bf16 ulp of each
    reference element (the fp32 values before the cast differ by
    summation order and rsqrtf), fp32 within 1e-5 of each element's
    magnitude (+1e-6). Returns (errors, failures)."""
    import torch
    from paddle_tpu_torch.kernels import fused_norm as fn
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    errs, failures = {}, []
    for R, Hd in NORM_SHAPES:
        x, res = (torch.randn(R, Hd, generator=gen, device="cuda") * 2
                  for _ in range(2))
        w = torch.randn(Hd, generator=gen, device="cuda")
        for dt, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
            for wt in dict.fromkeys((torch.float32, dt)):
                for r in (None, res.to(dt)):
                    got = fn.rms_norm_rows(x.to(dt), w.to(wt), r)
                    want = fn.rms_norm_rows_ref(x.to(dt), w.to(wt), r)
                    torch.cuda.synchronize()
                    d = (got.float() - want.float()).abs()
                    ratio = (d / (tol * want.float().abs() + 1e-6)).max() \
                        .item()
                    case = (f"{R}x{Hd}_{str(dt).replace('torch.', '')}"
                            f"{'_residual' if r is not None else ''}"
                            f"{'_fp32_weight' if wt != dt else ''}")
                    errs[case] = {"max_abs": d.max().item(),
                                  "worst_err_over_limit": ratio}
                    if not (ratio <= 1.0 and torch.isfinite(got).all()):
                        failures.append(("rms_norm_rows", case))
    return errs, failures


def phase_norm_kernel(launches: int, seed: int, card: str):
    """rms_norm_rows checked, then timed at (TRAIN_SEQ, 4096) and decode
    rows (16, 4096) beside its plain version, torch.nn.functional.rms_norm
    and its byte bound. No model calls it: `launches`, its count over the
    main paths, is 0."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_norm as fn
    errs, failures = check_norm_kernel(seed)
    emit({"phase": "kernel_check", "kernel": "rms_norm_rows",
          "errors": errs})
    if failures:
        raise AssertionError(f"rms_norm_rows disagrees with its plain "
                             f"version: {failures}")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fl = flush_buf.zero_
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    shapes = {}
    for R, Hd in NORM_SHAPES[:2]:
        for dt in (torch.bfloat16, torch.float32):
            for has_res in (False, True):
                x = torch.randn(R, Hd, generator=gen, device="cuda").to(dt)
                r = x * 0.5 if has_res else None
                w = torch.randn(Hd, generator=gen, device="cuda").to(dt)
                e = x.element_size()
                nbytes = (2 + has_res) * R * Hd * e + Hd * e
                lib = (lambda: F.rms_norm(x if r is None else x + r, (Hd,),
                                          w, 1e-6))
                if not hasattr(F, "rms_norm"):       # torch < 2.4
                    lib = None
                shapes[f"{R}x{Hd}_{str(dt).replace('torch.', '')}"
                       f"{'_residual' if has_res else ''}"] = {
                    "ms": time_ms(lambda: fn.rms_norm_rows(x, w, r), fl),
                    "plain_ms": time_ms(lambda: fn.rms_norm_rows_ref(
                        x, w, r), fl),
                    "library_ms": time_ms(lib, fl) if lib else None,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes}
    head = shapes[f"{TRAIN_SEQ}x4096_bfloat16"]
    name, source, replaces = KERNEL["rms_norm_rows"]
    worst = max(v["max_abs"] for c, v in errs.items() if "bfloat16" in c)
    worst32 = max(v["max_abs"] for c, v in errs.items() if "float32" in c)
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_note": "no reference model calls rms_norm_rows: the "
                              "main paths launch it 0 times",
             "max_abs_err": worst, "max_abs_err_fp32": worst32,
             "ms": head["ms"], "kernel_ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": "bytes", "library_ms": head["library_ms"],
             "library": "torch.nn.functional.rms_norm (residual added "
                        "beforehand where there is one)",
             "gb_per_s": head["bytes"] / head["ms"] / 1e6,
             "shape": {"R": TRAIN_SEQ, "H": 4096, "dtype": "bfloat16",
                       "residual": False, "weight": "bfloat16"},
             "shapes": shapes, "bytes": head["bytes"], "flops": 0,
             "card": card}]


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
    per_source = build.build(src.rsplit("/", 1)[1] for src in SOURCES)
    reports = {}
    for src in SOURCES:
        log = build.library_path(src.rsplit("/", 1)[1])
        log = log.with_name(log.name + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(x.split("Used ")[1].split()[0]) for x in lines
                if "Used " in x and " registers" in x]
        spills, spilling, entry = [], {}, None
        per_fn, spill_of = {}, {}
        for x in lines:        # ptxas names a function, then its spills
            if "Function properties for " in x:
                entry = x.split("Function properties for ")[1].strip()
            elif "bytes spill stores" in x:
                n = int(x.split("bytes spill stores")[0].split(",")[-1])
                spills.append(n)
                spill_of[entry] = n
                if n:
                    spilling[entry] = n
            elif "Used " in x and " registers" in x and entry:
                per_fn[entry] = int(x.split("Used ")[1].split()[0])
        reports[src] = {"kernels": len(regs),
                        "max_registers": max(regs) if regs else None,
                        "max_spill_store_bytes": max(spills) if spills
                        else None, "spilling": spilling}
        if "_sm90" in src:     # each wgmma kernel: (registers, spill bytes)
            reports[src]["registers"] = {
                fn: (r, spill_of.get(fn)) for fn, r in per_fn.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": reports})

    from paddle_tpu_torch.kernels import fused_norm
    fused_norm.rms_norm_rows.launches = 0     # no main path below calls it
    launches, capture, served = phase_serve(args.seed)
    gc.collect()                  # the bf16 engine goes; its model stays
    torch.cuda.empty_cache()
    multi_launches = phase_serve_multi(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches = phase_serve_spec(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_resume(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    phase_trace(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    spill_launches = phase_serve_spill(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_launches = phase_fleet(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    proc_launches = phase_proc_fleet(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches = phase_generate(served, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lora_launches, lora_capture = phase_serve_lora(served, args.seed)
    gc.collect()                  # the LoRA engine and registry go
    torch.cuda.empty_cache()
    quant_launches, quant_capture, quant_buckets = phase_serve_quant(
        served, args.seed)
    serve_outs = served["outs"]
    del served
    gc.collect()                  # the serving model and engine go
    torch.cuda.empty_cache()
    tp = phase_serve_tp(serve_outs, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, bucket = phase_train(args.seed)
    gc.collect()                  # so do the model and the optimizer
    torch.cuda.empty_cache()
    # the AdamW kernel's check on the train phase's bucket goes first,
    # so that the bucket is freed before train_loop builds its own
    adamw_row = phase_adamw_kernel(train_launches, bucket, args.seed, card)
    del bucket
    gc.collect()
    torch.cuda.empty_cache()
    loop_launches = phase_train_loop(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_buckets = phase_train_moe(args.seed)
    gc.collect()                  # the MoE model goes; its buckets stay
    torch.cuda.empty_cache()
    adamw_row["train_moe_buckets"] = check_moe_adamw(moe_buckets,
                                                     args.seed)
    del moe_buckets
    gc.collect()
    torch.cuda.empty_cache()
    packed_launches, lens = phase_packed_attention(args.seed)
    norm_launches = fused_norm.rms_norm_rows.launches   # the main paths ended
    gc.collect()
    torch.cuda.empty_cache()
    kernels = phase_kernels(capture, launches, args.seed, card)
    del capture
    kernels[0]["launches_by_phase"] = {
        "serve": launches["paged_attention_decode"],
        "serve_multi": multi_launches,
        "serve_spec": sum(spec_launches.values()),
        "serve_spec_by_proposer": spec_launches,
        "serve_spill": spill_launches["launches"],
        "fleet": fleet_launches, "proc_fleet": proc_launches,
        "serve_tp": tp["paged"]["paged_attention_decode"]["launches_by_rank"]}
    kernels[0]["tp_shard"] = tp["paged"]["paged_attention_decode"]
    kernels += phase_flash_kernels(train_launches, args.seed, card)
    kernels.append(adamw_row)
    kernels.append(phase_decode_flash_kernel(
        gen_launches["flash_attention_fwd_decode"], args.seed, card))
    for row in kernels:           # the counts of the other main paths
        extra = {phase: counts[row["name"]] for phase, counts in (
            ("train_loop", loop_launches), ("generate", gen_launches),
            ("train_moe", moe_launches))
            if row["name"] in counts}
        if extra and row["name"] != "flash_attention_fwd_decode":
            row["launches_by_phase"] = {"train": row["launches"], **extra}
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_quant_kernels(quant_capture, quant_launches,
                                   quant_buckets, args.seed, card)
    for row in kernels:
        if row["name"] == "paged_attention_decode_int8":
            shard = tp["paged"]["paged_attention_decode_int8"]
            row["launches_by_phase"] = {
                "serve_quant": row["launches"],
                "serve_spill": spill_launches["int8_launches"],
                "serve_tp": shard["launches_by_rank"]}
            row["tp_shard"] = shard
        elif row["name"] in tp["qmm"]:
            row["launches_by_phase"] = {"serve_quant": row["launches"],
                                        "serve_tp": tp["qmm"][row["name"]]}
            row["serve_tp_shapes"] = tp["qmm_shapes"]
    del quant_capture
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_lora_kernels(lora_capture, lora_launches, args.seed,
                                  card)
    del lora_capture
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_packed_kernels(packed_launches, lens, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += phase_norm_kernel(norm_launches, args.seed, card)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
