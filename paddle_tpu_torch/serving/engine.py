"""ServingEngine: continuous-batching inference over the paged-KV kernel
(port of `paddle_tpu/serving/engine.py`, single-card plain-decode
slice).

Scheduling, block-based KV management and the radix prefix cache run on
the host (scheduler.py / kv_cache.py / radix_cache.py); device work is
two kinds of eager launches, each padded to a shape bucket exactly as
the reference pads its compiled programs, so shapes match the reference
and a bucket can later be captured as one CUDA graph:

  * prefill CHUNK, bucketed by (chunk length S, block-table width P):
    one span of ONE padded prompt through `model.forward_paged_prefill`
    — rope at absolute positions, `paged_cache_write_range` at the
    chunk's offset, attention over the gathered paged prefix — and a
    token drawn from the chunk's last live position (used only when the
    chunk completes the prompt). Whole-prompt prefill, chunked prefill
    and radix prefix-cache hits are all this one launch.
  * DECODE, bucketed by (batch B, block-table width P): one batched
    step through `model.forward_paged_decode` — per-row rope, the
    current token's `paged_cache_write`, the paged-decode CUDA kernel
    over the block tables — plus sampling of the live rows.

Resilience: per-request deadlines and `abort()` take effect at the next
iteration boundary in any state; the waiting queue is bounded
(`EngineOverloaded`); every launch runs under a `StepSupervisor` that
retries transient device errors, NaN/Inf logits quarantine only their
own request, and anything else fails the engine (`EngineFailure`).

Determinism: greedy decode is deterministic and, given the same shape
buckets, a request's tokens do not depend on what it is batched with
(rows are independent). Random numbers for sampling are drawn from the
engine's `torch.Generator` once per launch, BEFORE the supervised call,
so a retried launch replays bit-identically.

Quantized serving: `kv_dtype="int8"` keeps every layer's K/V pages as
int8 with fp32 per-slot scale pages (quantized on write, dequantized by
the paged-decode kernel's int8 variant and by the prefill gather), so a
`kv_pool_bytes` budget holds ~1.94x the pages; `wq="int8"` / `"int4"`
converts the model's MLP and LM-head linears in place to weight-only
quantized ones before the first launch (`nn.quant.quantize_for_serving`;
int8 runs the dequant-matmul kernel).

Multi-LoRA serving: pass `lora` (a `serving.lora.AdapterRegistry` built
for this model's dims on the engine's device) and tag requests with
`add_request(adapter=...)`. Adapter A/B factors live paged in the
registry's pools (refcount pinning, LRU eviction of idle adapters); each
launch gathers the loaded adapters into per-rank-bucket slot stacks and
the model's projection hooks add every row's OWN adapter delta through
the LoRA kernels, so rows of one launch may mix adapters. Radix keys are
namespaced by (adapter, load generation): prefixes never cross adapters.

Refused for now (`UnsupportedFeature`): speculative decoding
(`proposer`), `decode_steps > 1`, tensor parallelism (`mesh`), the
host spill tier, disaggregated roles, the persistent compile cache and
per-request tracing. Snapshot and resume are not ported: a failed engine
raises `EngineFailure` with no snapshot.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.paged_attention import (alloc_paged_cache,
                                       check_supported_paged,
                                       paged_page_bytes)
from ..models.generation import _sample, sample_noise
from ..nn.quant import quantize_for_serving
from ..utils import faults
from .errors import EngineFailure, EngineOverloaded, UnsupportedFeature
from .kv_cache import PAD_PAGE, BlockAllocator
from .metrics import ServingMetrics
from .lora.adapter import AdapterNotLoaded
from .lora.runtime import build_context, lora_scope
from .lora.store import AdapterRegistry
from .radix_cache import RadixCache
from .scheduler import Request, RequestState, Scheduler
from .supervisor import POISON, RetryPolicy, StepSupervisor, classify_failure
from .trace import FlightRecorder

__all__ = ["ServingEngine"]

_engine_counter = itertools.count()

# Fault-injection points. The step-exception points fire BEFORE the
# launch, so an injected transient retries the identical launch;
# nan_logits poisons the per-row finiteness flags AFTER the launch;
# deadline_storm returns seconds of forward clock skew applied at the
# next boundary.
FAULT_CHUNK = faults.register_point("serving.engine.prefill_chunk")
FAULT_DECODE = faults.register_point("serving.engine.decode_step")
FAULT_NAN = faults.register_point("serving.engine.nan_logits")
FAULT_STORM = faults.register_point("serving.engine.deadline_storm")


def _bucket_for(value: int, buckets: List[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def _refuse_unported(*, proposer, decode_steps, host_spill_pages, mesh,
                     role, compile_cache, trace):
    """Raise UnsupportedFeature naming every requested feature this
    slice of the port does not have (ValueError for invalid values)."""
    if int(decode_steps) < 1:
        raise ValueError("decode_steps must be >= 1")
    if int(host_spill_pages) < 0:
        raise ValueError("host_spill_pages must be >= 0")
    asked = {
        "proposer": proposer is not None,
        "decode_steps>1": int(decode_steps) > 1,
        "host_spill_pages": int(host_spill_pages) > 0,
        "mesh": mesh is not None,
        "role": role != "both",
        "compile_cache": compile_cache is not None,
        "trace": bool(trace),
    }
    refused = [name for name, on in asked.items() if on]
    if refused:
        raise UnsupportedFeature(
            f"not ported to paddle_tpu_torch yet: {', '.join(refused)}",
            features=refused)


class ServingEngine:
    """Continuous-batching engine over a causal LM with paged-KV decode.

    model: a LlamaForCausalLM-protocol module (`forward_paged_prefill`,
    `forward_paged_decode`) whose parameters live on `device` — the card
    unless `device="cpu"` is passed. The engine owns the per-layer
    paged caches (in the model's dtype, or int8 with scale pages for
    kv_dtype="int8") on the same device. wq="int8"/"int4" quantizes the
    model's MLP and LM-head weights IN PLACE at construction, as the
    reference does. lora (an AdapterRegistry on the same device) turns
    on multi-LoRA serving.
    """

    def __init__(self, model, *, device=None, num_pages: int = 128,
                 page_size: int = 16, max_batch_size: int = 8,
                 token_budget: int = 512,
                 batch_buckets: Optional[List[int]] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 pages_buckets: Optional[List[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 max_retained_finished: int = 1024,
                 enable_prefix_cache: bool = True,
                 max_queue_len: Optional[int] = None,
                 default_ttl_s: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 clock=None,
                 kv_pool_bytes: Optional[int] = None,
                 flight_recorder_steps: int = 128,
                 proposer=None, decode_steps: int = 1,
                 kv_dtype: Optional[str] = None, wq: Optional[str] = None,
                 host_spill_pages: int = 0, mesh=None, lora=None,
                 role: str = "both", compile_cache=None, trace=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got "
                             f"{kv_dtype!r}")
        if wq not in (None, "int8", "int4"):
            raise ValueError(f"wq must be None, 'int8' or 'int4', got "
                             f"{wq!r}")
        _refuse_unported(proposer=proposer, decode_steps=decode_steps,
                         host_spill_pages=host_spill_pages, mesh=mesh,
                         role=role, compile_cache=compile_cache,
                         trace=trace)
        if lora is not None and not isinstance(lora, AdapterRegistry):
            raise TypeError(f"lora must be a serving.lora.AdapterRegistry, "
                            f"got {type(lora).__name__}")
        self.device = resolve_device(device)
        first = next(model.parameters())
        if first.device != self.device:
            raise ValueError(f"model parameters live on {first.device}, "
                             f"the engine on {self.device}: build the "
                             f"model on the engine's device")
        if lora is not None and lora.device != self.device:
            raise ValueError(f"the adapter registry's pools live on "
                             f"{lora.device}, the engine on {self.device}: "
                             f"build the registry with the engine's device")
        # adapter pools, page tables and per-row slots reach every launch
        # as device tensors; request refs pin adapters until terminal
        self.lora = lora
        # in place, before the first launch: the MLP and LM-head weights
        # become int8/int4 buffers read by every launch
        self.num_wq_layers = (quantize_for_serving(
            model, algo=f"weight_only_{wq}") if wq is not None else 0)
        params = list(model.parameters())
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.page_size = int(page_size)
        self.dtype = next(p.dtype for p in params if p.is_floating_point())
        dtype_name = str(self.dtype).replace("torch.", "")
        # what one page costs in THIS engine (int8 values + fp32 scales,
        # or the model dtype's full-width pages): the pool sizing, the
        # capacity gauge and the bytes-moved counters hang off it
        kv_name = kv_dtype or dtype_name
        self.kv_page_bytes = paged_page_bytes(
            self.num_kv, self.page_size, self.head_dim, kv_name)
        if kv_pool_bytes is not None:
            num_pages = max(2, int(kv_pool_bytes) // self.kv_page_bytes)
        self.num_pages = int(num_pages)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # fail at construction, not at the first decode launch
        check_supported_paged(
            (1, self.num_heads, self.head_dim),
            (self.num_pages, self.num_kv, self.page_size, self.head_dim),
            self.dtype, kv_dtype=kv_dtype)

        # longest sequence a request may ever reach (rope table and page
        # supply both bound it)
        self.max_seq_len = min(int(cfg.max_position_embeddings),
                               (self.num_pages - 1) * self.page_size)
        max_pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.batch_buckets = sorted(batch_buckets or
                                    _pow2_buckets(1, int(max_batch_size)))
        self.prefill_buckets = sorted(
            prefill_buckets or _pow2_buckets(
                min(16, self.max_seq_len), self.max_seq_len))
        self.pages_buckets = sorted(
            pages_buckets or _pow2_buckets(
                min(2, max_pages_per_seq), max_pages_per_seq))
        # the widest block table a decode launch supports also bounds
        # how long any sequence may grow
        self.max_seq_len = min(self.max_seq_len,
                               self.pages_buckets[-1] * self.page_size)
        if self.prefill_buckets[-1] > self.max_seq_len:
            raise ValueError("prefill bucket exceeds max sequence length")

        self.allocator = BlockAllocator(self.num_pages, self.page_size)
        self.radix = (RadixCache(self.allocator)
                      if enable_prefix_cache else None)
        self.scheduler = Scheduler(
            self.allocator, max_batch_size=self.batch_buckets[-1],
            token_budget=min(token_budget, self.prefill_buckets[-1]),
            max_prompt_len=self.max_seq_len,
            prefix_cache=self.radix,
            max_queue_len=max_queue_len)
        # deadlines use an injectable clock so expiry stays deterministic
        self._clock = clock if clock is not None else time.monotonic
        self._clock_skew = 0.0
        self.default_ttl_s = default_ttl_s
        self.supervisor = StepSupervisor(
            policy=retry_policy,
            on_retry=lambda label, attempt: self.metrics.on_step_retry())
        self.failed = False
        self.metrics = ServingMetrics(name=f"serving-{next(_engine_counter)}")
        if self.lora is not None:
            # registry lifecycle counters land in this engine's metrics
            # (loads done before the engine existed carry in)
            self.lora.bind_counters(self.metrics.counters)
        self.recorder = FlightRecorder(flight_recorder_steps)
        self._step_ev = {"programs": []}
        self._step_t0: Optional[float] = None
        self._last_launch_s: Optional[float] = None

        # one (k, v) pair per layer — (k, v, k_scale, v_scale) for int8 —
        # written in place by the launches
        self._kv = [alloc_paged_cache(self.num_kv, self.num_pages,
                                      self.page_size, self.head_dim,
                                      dtype=self.dtype, device=self.device,
                                      kv_dtype=kv_dtype)
                    for _ in range(self.num_layers)]
        # one token's K+V across every layer, scales included
        # (bytes-moved accounting)
        self.kv_bytes_per_token = (self.num_layers * self.kv_page_bytes
                                   // self.page_size)
        self.metrics.set_kv_info(
            kv_dtype=kv_name, page_bytes=self.kv_page_bytes,
            pool_bytes=self.kv_page_bytes * self.num_pages,
            bytes_per_token=self.kv_bytes_per_token)

        self.requests: Dict[int, Request] = {}
        self._finished_order: List[int] = []
        # only the most recent `max_retained_finished` stay readable
        self.max_retained_finished = int(max_retained_finished)
        self.num_evicted_finished = 0

    @property
    def kv_caches(self):
        """The per-layer paged caches: (k_cache, v_cache), each
        (num_pages, KVH, page_size, D) — plus (k_scale, v_scale), each
        (num_pages, KVH, page_size) fp32, for int8 KV; page ids come from
        the allocator."""
        return self._kv

    # ------------------------------------------------------------- intake
    def _now(self) -> float:
        return self._clock() + self._clock_skew

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    ttl_s: Optional[float] = None,
                    deadline: Optional[float] = None,
                    adapter: Optional[str] = None) -> int:
        """Queue one request. `ttl_s` (or an absolute engine-clock
        `deadline`) bounds its total lifetime. Raises `EngineOverloaded`
        when the bounded waiting queue is full.

        `adapter` names a LoRA adapter the registry must currently hold:
        an unknown one is shed typed (`AdapterNotLoaded`) at the door,
        never served with base weights. An admitted request pins its
        adapter until it reaches a terminal state."""
        if self.failed:
            raise EngineFailure("engine has failed")
        if adapter is not None:
            if self.lora is None:
                raise AdapterNotLoaded(
                    f"request names adapter {adapter!r} but this engine "
                    f"has no adapter registry (lora=None)",
                    adapter=adapter)
            if not self.lora.has(adapter):
                self.metrics.counters["adapter_rejects"] += 1
                raise AdapterNotLoaded(
                    f"adapter {adapter!r} is not loaded "
                    f"(loaded: {self.lora.adapter_names()})",
                    adapter=adapter)
        req = Request(prompt_ids, max_new_tokens, eos_token_id,
                      adapter=adapter)
        if len(req.prompt_ids) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(req.prompt_ids)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if ttl_s is None and deadline is None and \
                self.default_ttl_s is not None:
            ttl_s = self.default_ttl_s
        if ttl_s is not None and deadline is not None:
            raise ValueError("pass ttl_s or deadline, not both")
        if ttl_s is not None:
            deadline = self._now() + float(ttl_s)
        req.deadline = deadline
        try:
            self.scheduler.add_request(req)
        except EngineOverloaded:
            self.metrics.on_shed()
            raise
        if adapter is not None:
            self.lora.acquire(adapter)     # pinned until terminal
            # versioned radix namespace: a reload of the same name never
            # matches KV cached under the replaced weights
            req.adapter_key = self.lora.namespace_of(adapter)
        self.requests[req.request_id] = req
        self.metrics.on_add(req.request_id)
        return req.request_id

    def abort(self, request_id: int) -> bool:
        """Client abort, honored at the next iteration boundary in any
        state (valid KV donated to the radix cache). False when the
        request is unknown or already finished."""
        req = self.requests.get(request_id)
        if req is None or req.state is RequestState.FINISHED:
            return False
        req.aborted = True
        return True

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # -------------------------------------------------------- multi-LoRA
    def load_adapter(self, adapter, quant: Optional[str] = None) -> int:
        """Load a LoRAAdapter into the registry at runtime (only page and
        table values change). Returns the global launch slot;
        quant="int8" stores the payload quantized."""
        if self.lora is None:
            raise AdapterNotLoaded("engine has no adapter registry "
                                   "(construct with lora=...)")
        return self.lora.load(adapter, quant=quant)

    def unload_adapter(self, name: str):
        """Unload an IDLE adapter (typed AdapterBusy while live requests
        still pin it)."""
        if self.lora is None:
            raise AdapterNotLoaded("engine has no adapter registry "
                                   "(construct with lora=...)")
        self.lora.unload(name)

    def _lora_launch_args(self, reqs, B: int) -> tuple:
        """One launch's LoRA inputs: (row_slots (B,), *registry flat
        args), on the device; empty when lora is off. Padded batch rows
        map to global slot 0 (every bucket's null adapter: an exact zero
        delta)."""
        if self.lora is None:
            return ()
        rows = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            if r.adapter is not None:
                rows[i] = self.lora.slot_of(r.adapter)
        return (self._to_device(rows),) + self.lora.flat_args()

    def _lora_scope(self, largs):
        """Scope around a launch's model call: builds the launch's
        LoRAContext and activates the projection hooks (a null context
        when lora is off)."""
        if not largs:
            return contextlib.nullcontext()
        return lora_scope(build_context(self.lora.layout, largs[1:],
                                        largs[0]))

    # ----------------------------------------------------------- launches
    def _noise(self, rows: int) -> Optional[torch.Tensor]:
        """Sampling noise for one launch, drawn before the supervised
        call (None for greedy)."""
        if self.temperature <= 0.0:
            return None
        return sample_noise((rows, self.cfg.vocab_size), self._gen,
                            self.device)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _run_chunk(self, chunk):
        req = chunk.request
        ids = req.resume_ids[chunk.start:chunk.start + chunk.length]
        S = _bucket_for(chunk.length, self.prefill_buckets)
        P = _bucket_for(
            self.allocator.pages_needed(chunk.start + chunk.length),
            self.pages_buckets)
        bt = np.full((P,), PAD_PAGE, np.int32)
        npages = min(len(req.seq.pages), P)
        bt[:npages] = req.seq.pages[:npages]
        padded = np.zeros((1, S), np.int64)
        padded[0, :chunk.length] = ids
        ids_t, bt_t = self._to_device(padded), self._to_device(bt)
        # non-final chunks draw nothing: the engine's random stream
        # advances once per token actually emitted
        noise = self._noise(1) if chunk.is_last else None
        largs = self._lora_launch_args([req], 1)

        def launch():
            faults.fire(FAULT_CHUNK)
            with torch.inference_mode(), self._lora_scope(largs):
                logits, _ = self.model.forward_paged_prefill(
                    ids_t, self._kv, bt_t, chunk.start, chunk.length)
                last = logits[0, 0]      # head ran at the chunk end only
                ok = torch.isfinite(last).all()
                if chunk.is_last:
                    tok = _sample(last[None], self.temperature, self.top_k,
                                  self.top_p, noise)[0]
                else:                    # a non-final chunk emits nothing
                    tok = torch.zeros_like(ok, dtype=torch.long)
                res = torch.stack([tok, ok.long()]).cpu()
            return int(res[0]), bool(res[1])

        self._step_ev["programs"].append(f"chunk:S{S}:P{P}")
        tok, ok = self.supervisor.run(launch, label="prefill_chunk")
        if faults.fire(FAULT_NAN) is not None:
            ok = False
        self.metrics.on_prefill(chunk.length)
        # the chunk wrote its own tokens' K/V and its attention gathered
        # the whole live prefix (cached tokens + this chunk) per layer
        self.metrics.on_kv_bytes(
            written=chunk.length * self.kv_bytes_per_token,
            read=(chunk.start + chunk.length) * self.kv_bytes_per_token)
        return tok, ok

    def _run_decode(self, reqs: List[Request]):
        n = len(reqs)
        B = _bucket_for(n, self.batch_buckets)
        P = _bucket_for(max(len(r.seq.pages) for r in reqs),
                        self.pages_buckets)
        ids = np.zeros((B, 1), np.int64)
        sl = np.zeros((B,), np.int32)
        bt = np.full((B, P), PAD_PAGE, np.int32)
        bt[:n] = self.allocator.block_table([r.seq for r in reqs], P)
        for i, r in enumerate(reqs):
            ids[i, 0] = r.output_ids[-1]
            sl[i] = r.seq.num_tokens
        ids_t, bt_t, sl_t = (self._to_device(a) for a in (ids, bt, sl))
        noise = self._noise(n)    # drawn once: retries re-run identically
        largs = self._lora_launch_args(reqs, B)
        if self.lora is not None:
            self.metrics.on_adapter_mix(
                len({r.adapter for r in reqs if r.adapter is not None}))

        def launch():
            faults.fire(FAULT_DECODE)
            with torch.inference_mode(), self._lora_scope(largs):
                logits, _ = self.model.forward_paged_decode(
                    ids_t, self._kv, bt_t, sl_t)
                # finiteness and sampling look at the live rows only;
                # rows are independent, so a poisoned request flags only
                # its own row
                rows = logits[:n, 0]
                oks = torch.isfinite(rows).all(dim=-1)
                toks = _sample(rows, self.temperature, self.top_k,
                               self.top_p, noise)
                res = torch.stack([toks, oks.long()]).cpu().numpy()
            return res[0], res[1].astype(bool)

        self._step_ev["programs"].append(f"decode:B{B}:P{P}")
        t0 = time.perf_counter()
        toks, oks = self.supervisor.run(launch, label="decode_step")
        self._last_launch_s = time.perf_counter() - t0
        # this step wrote one token per live row and the attention
        # kernel read every live token's K/V
        self.metrics.on_kv_bytes(
            written=n * self.kv_bytes_per_token,
            read=sum(r.seq.num_tokens for r in reqs)
            * self.kv_bytes_per_token)
        oks = oks.copy()
        poison = faults.fire(FAULT_NAN)
        if poison is not None:
            for i in self._poison_rows(poison, reqs):
                oks[i] = False
        for r in reqs:
            # this step wrote the K/V of each row's input token
            r.num_computed = r.seq.num_tokens
        self.metrics.on_decode(n)
        return toks, oks

    @staticmethod
    def _poison_rows(poison, reqs) -> List[int]:
        """Normalize a nan_logits fault payload into row indices:
        callable(reqs) -> rows, True/'all' -> every row, int or list of
        ints -> those rows (out-of-range ignored)."""
        if callable(poison):
            rows = poison(reqs)
        elif poison is True or poison == "all":
            rows = range(len(reqs))
        elif isinstance(poison, int):
            rows = [poison]
        else:
            rows = poison
        return [int(i) for i in rows if 0 <= int(i) < len(reqs)]

    def _apply_copies(self, copies):
        """Device-side copy-on-write: copy a page's rows to a fresh page
        in every layer's K and V — and, for int8 KV, its scale rows,
        which are part of the page: a fork that copied only the values
        would dequantize them with another page's scales."""
        for src, dst in copies:
            for layer in self._kv:
                for t in layer:
                    t[dst].copy_(t[src])

    # ------------------------------------------------------------- step
    def _emit(self, req: Request, tok: int, emitted):
        """Record one generated token + run the finish checks."""
        first = req.num_generated == 0
        req.output_ids.append(tok)
        if first:
            self.metrics.on_first_token(req.request_id)
        emitted.append((req.request_id, tok))
        if req.eos_token_id is not None and tok == req.eos_token_id:
            return "stop"
        if req.remaining_new_tokens() <= 0:
            return "length"
        return None

    def _cancel_boundary(self):
        """Iteration-boundary sweep: apply any injected clock skew, then
        cancel aborted and past-deadline requests in ANY state."""
        skew = faults.fire(FAULT_STORM)
        if skew is not None:
            self._clock_skew += float(skew)
        now = self._now()
        for req in list(self.requests.values()):
            if req.state is RequestState.FINISHED:
                continue
            if req.aborted:
                if self.scheduler.cancel(req, "abort"):
                    self.metrics.on_abort(req.request_id)
                    self._retain(req)
            elif req.deadline is not None and now >= req.deadline:
                if self.scheduler.cancel(req, "expired"):
                    self.metrics.on_expire(req.request_id)
                    self._retain(req)

    def _quarantine(self, req: Request):
        """Fail ONE poisoned request, not the engine: no token is
        emitted, its pages are freed WITHOUT donation (they may hold
        NaN K/V — the radix tree must never serve them)."""
        if self.scheduler.cancel(req, "quarantined", donate=False):
            self.metrics.on_quarantine(req.request_id)
            self._retain(req)

    def _fail(self, exc: BaseException):
        """Unrecoverable: record the failing step, refuse further work
        and raise EngineFailure (no snapshot in this port)."""
        self.metrics.on_engine_failure()
        self.recorder.record({
            "step": int(self.metrics.counters["engine_steps"]) + 1,
            "failed": repr(exc),
            "programs": list(self._step_ev.get("programs", ())),
            "queue_depth": int(self.scheduler.queue_depth),
            "running": len(self.scheduler.running),
            "kv_used_pages": int(self.allocator.num_used),
        })
        self.failed = True
        raise EngineFailure(f"unrecoverable engine error: {exc!r}",
                            cause=exc) from exc

    def step(self):
        """One engine iteration: cancellation sweep, schedule, run
        prefill chunks, run the batched decode step. Returns
        [(request_id, token)] in emission order (empty when idle).

        Failure semantics per launch: transients retried by the
        supervisor; a poison failure quarantines the offending
        request(s) and the step continues; anything else raises
        EngineFailure."""
        if self.failed:
            raise EngineFailure("engine has failed")
        emitted = []
        self._step_t0 = time.perf_counter()
        self._step_ev = {"programs": []}
        pre_prefill = self.metrics.counters["prefill_tokens"]
        self._cancel_boundary()
        sched = self.scheduler.schedule()
        for _ in sched.preempted:
            self.metrics.on_preempt()

        for chunk in sched.prefills:
            req = chunk.request
            if req.state is RequestState.FINISHED:
                continue               # quarantined earlier this step
            if chunk.is_first:
                self.metrics.on_admission(req.request_id,
                                          req.cached_tokens,
                                          resumed=req.num_preemptions > 0)
            try:
                tok, ok = self._run_chunk(chunk)
            except Exception as exc:   # noqa: BLE001
                if classify_failure(exc) == POISON:
                    self._quarantine(req)
                    continue
                self._fail(exc)
            if not ok:
                self._quarantine(req)
                continue
            req.num_computed = chunk.start + chunk.length
            if chunk.is_last:
                reason = self._emit(req, tok, emitted)
                if reason is not None:
                    self.scheduler.finish(req, reason)
                    self._on_finished(req)
                else:
                    self.scheduler.on_prefilled(req)

        decodes = [r for r in sched.decodes
                   if r.state is not RequestState.FINISHED]
        if decodes:
            for req in decodes:
                self._apply_copies(req.pending_copies)
                req.pending_copies = []
            self._plain_decode_step(decodes, emitted)

        self.metrics.on_step()
        self.metrics.update_gauges(
            queue_depth=self.scheduler.queue_depth,
            running=len(self.scheduler.running),
            kv_used_pages=self.allocator.num_used,
            kv_occupancy=self.allocator.occupancy(),
            cached_pages=self.radix.num_cached_pages if self.radix else 0,
            radix_nodes=self.radix.num_nodes if self.radix else 0,
            radix_evicted_pages=(self.radix.num_evicted_pages
                                 if self.radix else None))
        if self._step_ev["programs"] or emitted or sched.preempted:
            self.recorder.record({
                "step": int(self.metrics.counters["engine_steps"]),
                "t_wall_ms": round((time.perf_counter()
                                    - self._step_t0) * 1e3, 3),
                "programs": list(self._step_ev["programs"]),
                "prefill_chunks": len(sched.prefills),
                "prefill_tokens": int(self.metrics.counters["prefill_tokens"]
                                      - pre_prefill),
                "decode_batch": len(decodes),
                "tokens_out": len(emitted),
                "preempted": len(sched.preempted),
                "queue_depth": int(self.scheduler.queue_depth),
                "running": len(self.scheduler.running),
                "kv_used_pages": int(self.allocator.num_used),
            })
        return emitted

    def timeline(self) -> List[dict]:
        """Flight-recorder view: the last N non-idle step records,
        oldest first."""
        return self.recorder.records()

    def _plain_decode_step(self, decodes: List[Request], emitted):
        """One batched single-token decode launch + emission."""
        degraded = False
        try:
            toks, oks = self._run_decode(decodes)
        except Exception as exc:   # noqa: BLE001
            if classify_failure(exc) == POISON:
                # unattributed poison: isolate by running rows solo
                toks, oks = self._isolate_poisoned(decodes)
                degraded = True
            else:
                self._fail(exc)
        n0 = len(emitted)
        for i, req in enumerate(decodes):
            if not oks[i]:
                self._quarantine(req)
                continue
            reason = self._emit(req, int(toks[i]), emitted)
            if reason is not None:
                self.scheduler.finish(req, reason)
                self._on_finished(req)
        # TPOT sample: launch wall seconds / tokens emitted (none for
        # the solo isolation launches — they are not a batch launch)
        self.metrics.on_decode_launch(
            len(decodes), 0 if degraded else len(emitted) - n0,
            None if degraded else self._last_launch_s)

    def _isolate_poisoned(self, reqs: List[Request]):
        """Degraded mode for an UNATTRIBUTED poison failure of a decode
        batch: re-run each row solo to find the poisoned request(s).
        Solo launches rewrite the same K/V at the same positions but use
        the B=1 bucket — a different launch shape."""
        toks = np.zeros((len(reqs),), np.int64)
        oks = np.ones((len(reqs),), bool)
        for i, req in enumerate(reqs):
            try:
                t, o = self._run_decode([req])
            except Exception as exc:   # noqa: BLE001
                if classify_failure(exc) == POISON:
                    oks[i] = False
                    continue
                self._fail(exc)
            toks[i] = int(t[0])
            oks[i] = bool(o[0])
        return toks, oks

    def _retain(self, req: Request):
        """Terminal-request retention (bounded window). Every terminal
        path funnels here, so it also unpins the request's adapter."""
        if self.lora is not None and req.adapter is not None:
            self.lora.release(req.adapter)
        self._finished_order.append(req.request_id)
        while len(self._finished_order) > self.max_retained_finished:
            self.requests.pop(self._finished_order.pop(0), None)
            self.num_evicted_finished += 1

    def _on_finished(self, req: Request):
        self.metrics.on_finish(req.request_id)
        self._retain(req)

    # --------------------------------------------------- prefix cache ops
    def reset_prefix_cache(self) -> int:
        """Drop every cached prefix; returns the number of pages
        returned to the free list. With no live requests this brings
        allocator occupancy back to zero."""
        if self.radix is None:
            return 0
        return self.radix.clear()

    # ------------------------------------------------------- convenience
    def run(self) -> Dict[int, List[int]]:
        """Drain everything; returns {request_id: generated tokens} for
        every request alive when run() was called."""
        out = {rid: list(r.output_ids) for rid, r in self.requests.items()}
        guard = 0
        limit = 16 * (self.max_seq_len + 2) * max(1, len(self.requests))
        while self.has_work():
            for rid, tok in self.step():
                out.setdefault(rid, []).append(tok)
            guard += 1
            if guard > limit:
                raise RuntimeError("serving engine failed to drain "
                                   f"after {guard} steps")
        return out
