"""Serving counters and gauges (port of `paddle_tpu/serving/metrics.py`,
the subset the ported engine drives; profiler registration and the
Prometheus exposition are not ported).

Per-request queue-wait / TTFT / TPOT percentiles come from bounded
reservoirs — a long-lived server keeps the last `PERCENTILE_WINDOW`
samples, not one entry per request ever served.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

__all__ = ["ServingMetrics", "percentile"]

PERCENTILE_WINDOW = 1024


def percentile(samples, q):
    """Nearest-rank percentile over a small window (the rule of
    `paddle_tpu/profiler/exposition.py`). Returns None on an empty
    window."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


class ServingMetrics:
    """Counters/gauges for one ServingEngine."""

    def __init__(self, name: str = "serving"):
        self.name = name
        self.counters: Dict[str, int] = {
            "requests_added": 0,
            "requests_finished": 0,
            "requests_preempted": 0,
            "prefill_tokens": 0,
            "decode_tokens": 0,
            "engine_steps": 0,
            # prefix cache / chunked prefill
            "prefill_chunks": 0,           # chunk launches (incl. final)
            "admissions": 0,               # first-chunk admissions
            "prefix_hits": 0,              # admissions with a cache match
            "cached_tokens_served": 0,     # matched tokens reused from cache
            "radix_evicted_pages": 0,
            # failure modes
            "requests_aborted": 0,         # client abort() honored
            "deadline_expired": 0,         # TTL/deadline cancellations
            "requests_shed": 0,            # EngineOverloaded rejections
            "step_retries": 0,             # transient-failure re-launches
            "requests_quarantined": 0,     # poisoned (NaN) requests failed
            "engine_failures": 0,          # unrecoverable
            # device bytes the KV writes landed / the attention reads
            # streamed (host-computed from token counts x bytes/token)
            "kv_bytes_written": 0,
            "kv_bytes_read": 0,
            # decode-side launches
            "decode_launches": 0,
            "decode_launch_rows": 0,
            # multi-LoRA: registry lifecycle (AdapterRegistry.
            # bind_counters homes them here) — loads, explicit unloads,
            # LRU evictions of idle adapters, typed load failures (the
            # injected serving.lora.load_fail fault included), evict-race
            # guard refusals — and requests rejected at the door for
            # naming an adapter that is not loaded
            "adapters_loaded": 0,
            "adapters_unloaded": 0,
            "adapters_evicted": 0,
            "adapter_load_failures": 0,
            "lora_evict_refusals": 0,
            "adapter_rejects": 0,
        }
        self._t_start = time.perf_counter()
        self._arrive_t: Dict[int, float] = {}   # in-flight only
        self._reservoirs: Dict[str, deque] = {}
        self._reservoir_fmt: Dict[str, tuple] = {}
        self._ttft_samples = self.add_reservoir("ttft", scale=1e3,
                                                suffix="_ms")
        self._queue_wait_samples = self.add_reservoir("queue_wait",
                                                      scale=1e3,
                                                      suffix="_ms")
        # TPOT: decode launch wall seconds / tokens emitted by it
        self._tpot_samples = self.add_reservoir("tpot", scale=1e3,
                                                suffix="_ms")
        # distinct adapters per decode launch: p50 > 1 means launches
        # really mix adapters
        self._adapter_mix_samples = self.add_reservoir("adapter_mix",
                                                       digits=2)
        # gauges updated by the engine each step
        self.queue_depth = 0
        self.running = 0
        self.kv_used_pages = 0
        self.kv_occupancy = 0.0
        self.cached_pages = 0
        self.radix_nodes = 0
        # static KV-geometry gauges (set once at engine construction)
        self.kv_dtype = None
        self.kv_page_bytes = 0
        self.kv_pool_bytes = 0
        self.kv_bytes_per_token = 0

    # ---- reservoir registry ---------------------------------------------
    def add_reservoir(self, name: str, scale: float = 1.0,
                      suffix: str = "", digits: int = 3) -> deque:
        """Register a bounded percentile reservoir; snapshot() exposes
        `{name}_p50{suffix}` / p90 / p99 (sample * scale)."""
        d = self._reservoirs.setdefault(
            name, deque(maxlen=PERCENTILE_WINDOW))
        self._reservoir_fmt[name] = (float(scale), suffix, int(digits))
        return d

    def reservoir_percentiles(self, name):
        return {f"p{q}": percentile(self._reservoirs.get(name, ()), q)
                for q in (50, 90, 99)}

    # ---- event hooks -----------------------------------------------------
    def on_add(self, request_id: int):
        self.counters["requests_added"] += 1
        self._arrive_t[request_id] = time.perf_counter()

    def on_admission(self, request_id: int, cached_tokens: int,
                     resumed: bool = False):
        """First chunk of an admission scheduled; the queue-wait sample
        is taken only for the ORIGINAL admission."""
        self.counters["admissions"] += 1
        if cached_tokens > 0:
            self.counters["prefix_hits"] += 1
            self.counters["cached_tokens_served"] += cached_tokens
        if not resumed:
            t0 = self._arrive_t.get(request_id)
            if t0 is not None:
                self._queue_wait_samples.append(time.perf_counter() - t0)

    def on_first_token(self, request_id: int):
        t0 = self._arrive_t.get(request_id)
        if t0 is not None:
            self._ttft_samples.append(time.perf_counter() - t0)

    def on_prefill(self, num_tokens: int):
        self.counters["prefill_tokens"] += num_tokens
        self.counters["prefill_chunks"] += 1

    def on_decode(self, num_tokens: int):
        self.counters["decode_tokens"] += num_tokens

    def on_decode_launch(self, rows: int, tokens: int,
                         seconds: Optional[float] = None):
        """One decode launch over `rows` live rows that emitted `tokens`
        tokens in `seconds` of launch wall time."""
        self.counters["decode_launches"] += 1
        self.counters["decode_launch_rows"] += int(rows)
        if seconds is not None and seconds > 0 and tokens > 0:
            self._tpot_samples.append(seconds / tokens)

    def on_adapter_mix(self, distinct: int):
        """Distinct adapters (base rows excluded) in one decode launch."""
        self._adapter_mix_samples.append(int(distinct))

    def set_kv_info(self, *, kv_dtype, page_bytes, pool_bytes,
                    bytes_per_token):
        self.kv_dtype = str(kv_dtype)
        self.kv_page_bytes = int(page_bytes)
        self.kv_pool_bytes = int(pool_bytes)
        self.kv_bytes_per_token = int(bytes_per_token)

    def on_kv_bytes(self, written: int = 0, read: int = 0):
        self.counters["kv_bytes_written"] += int(written)
        self.counters["kv_bytes_read"] += int(read)

    def on_finish(self, request_id: int):
        self.counters["requests_finished"] += 1
        self._arrive_t.pop(request_id, None)

    def on_preempt(self):
        self.counters["requests_preempted"] += 1

    def on_abort(self, request_id: int):
        self.counters["requests_aborted"] += 1
        self._arrive_t.pop(request_id, None)

    def on_expire(self, request_id: int):
        self.counters["deadline_expired"] += 1
        self._arrive_t.pop(request_id, None)

    def on_shed(self):
        self.counters["requests_shed"] += 1

    def on_step_retry(self):
        self.counters["step_retries"] += 1

    def on_quarantine(self, request_id: int):
        self.counters["requests_quarantined"] += 1
        self._arrive_t.pop(request_id, None)

    def on_engine_failure(self):
        self.counters["engine_failures"] += 1

    def on_step(self):
        self.counters["engine_steps"] += 1

    def update_gauges(self, *, queue_depth, running, kv_used_pages,
                      kv_occupancy, cached_pages=0, radix_nodes=0,
                      radix_evicted_pages=None):
        self.queue_depth = queue_depth
        self.running = running
        self.kv_used_pages = kv_used_pages
        self.kv_occupancy = kv_occupancy
        self.cached_pages = cached_pages
        self.radix_nodes = radix_nodes
        if radix_evicted_pages is not None:
            self.counters["radix_evicted_pages"] = radix_evicted_pages

    # ---- derived ---------------------------------------------------------
    def tokens_per_second(self) -> float:
        dt = time.perf_counter() - self._t_start
        total = (self.counters["prefill_tokens"]
                 + self.counters["decode_tokens"])
        return total / dt if dt > 0 else 0.0

    def prefix_hit_rate(self) -> Optional[float]:
        if not self.counters["admissions"]:
            return None
        return self.counters["prefix_hits"] / self.counters["admissions"]

    def snapshot(self) -> dict:
        snap = dict(self.counters)
        snap.update({
            "queue_depth": self.queue_depth,
            "running": self.running,
            "kv_used_pages": self.kv_used_pages,
            "kv_occupancy": round(self.kv_occupancy, 4),
            "cached_pages": self.cached_pages,
            "radix_nodes": self.radix_nodes,
            "tokens_per_second": round(self.tokens_per_second(), 2),
            "kv_dtype": self.kv_dtype,
            "kv_page_bytes": self.kv_page_bytes,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_bytes_per_token": self.kv_bytes_per_token,
        })
        hr = self.prefix_hit_rate()
        if hr is not None:
            snap["prefix_hit_rate"] = round(hr, 4)
        for name, (scale, suffix, digits) in self._reservoir_fmt.items():
            for q, v in self.reservoir_percentiles(name).items():
                if v is not None:
                    snap[f"{name}_{q}{suffix}"] = round(v * scale, digits)
        return snap
