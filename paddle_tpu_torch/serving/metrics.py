"""Serving counters and gauges (port of `paddle_tpu/serving/metrics.py`):
what the engine counts, the host spill tier's and the fleet's counters
and gauges, the cross-replica merge and the Prometheus exposition. The
reference's profiler registration is not ported, nor are the counters of
the feature the port does not have (`recompiles` and `compile_cache_*`
of the compiled-program cache). Under tensor parallelism the KV
geometry gauges are global (summed over the shards) and
`kv_tp_degree`, `kv_page_bytes_shard` and `kv_pool_bytes_shard` record
what one rank pays.

Per-request queue-wait / TTFT / TPOT percentiles come from bounded
reservoirs — a long-lived server keeps the last `PERCENTILE_WINDOW`
samples, not one entry per request ever served.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from ..profiler.exposition import percentile, prometheus_lines

__all__ = ["ServingMetrics", "percentile"]

PERCENTILE_WINDOW = 1024


class ServingMetrics:
    """Counters/gauges for one ServingEngine."""

    def __init__(self, name: str = "serving"):
        self.name = name
        self.counters: Dict[str, int] = {
            "requests_added": 0,
            # snapshot-restored intake (from_snapshot / adopt_requests),
            # kept apart from requests_added so a resumed request is not
            # counted as two arrivals
            "requests_adopted": 0,
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
            "prefill_tokens_skipped": 0,   # prefill work those tokens saved
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
            # speculative decoding
            "spec_steps": 0,               # verify launches
            "spec_verified_rows": 0,       # sequence-steps verified
            "spec_drafted_tokens": 0,      # draft tokens scored
            "spec_accepted_tokens": 0,     # drafts that survived verify
            "spec_emitted_tokens": 0,      # tokens emitted by verify steps
            "spec_rollback_tokens": 0,     # rejected-draft KV truncated
            "spec_draft_oom_drops": 0,     # drafts dropped: pool pressure
            # decode-side launches (plain K=1 and multi-step K)
            "decode_launches": 0,
            "decode_launch_steps": 0,      # K summed over those launches
            "decode_launch_rows": 0,       # live rows summed over them
            "multi_decode_slot_shortfall": 0,  # K-1 slots the pool denied
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
            # host spill tier: demotion/promotion traffic (synced from
            # the radix tree at the gauge sites, like
            # radix_evicted_pages), the eviction rung taken, host-tier
            # hits and drops, the fleet's prefix pulls and releases, and
            # the three host_spill fault outcomes (counted where the
            # degradation happens)
            "kv_pages_demoted": 0,         # device pages spilled to host
            "kv_pages_promoted": 0,        # host pages copied back
            "host_prefix_hits": 0,         # matches that promoted a span
            "host_pages_dropped": 0,       # host-tier LRU/cascade drops
            "radix_evict_demoted": 0,      # eviction rung: demoted
            "radix_evict_dropped": 0,      # eviction rung: dropped
            "kv_pages_exported": 0,        # prefix pull, donor side
            "kv_pages_adopted": 0,         # prefix pull, receiver side
            # prefill-role engines: requests finished "handoff", and
            # pages released (made coldest or dropped) once a decode
            # engine adopted them
            "prefill_handoffs": 0,
            "kv_pages_released": 0,
            "host_spill_corrupt": 0,       # CRC reject -> recompute
            "host_spill_slow": 0,          # deadline miss -> retry later
            "host_spill_lost": 0,          # buffer gone -> recompute
        }
        self._t_start = time.perf_counter()
        self._arrive_t: Dict[int, float] = {}   # in-flight only
        self._ttft_sum = 0.0
        self._ttft_count = 0
        self._reservoirs: Dict[str, deque] = {}
        self._reservoir_fmt: Dict[str, tuple] = {}
        self._ttft_samples = self.add_reservoir("ttft", scale=1e3,
                                                suffix="_ms")
        self._queue_wait_samples = self.add_reservoir("queue_wait",
                                                      scale=1e3,
                                                      suffix="_ms")
        # accepted drafts per verify step: mean > 1 is the "speculation
        # pays" signal
        self._accepted_samples = self.add_reservoir("spec_accepted")
        # TPOT: decode launch wall seconds / tokens emitted by it, so the
        # per-token percentiles stay comparable across K
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
        # tensor parallelism: the degree, and one rank's page and pool
        # bytes (its KVH/tp heads)
        self.kv_tp_degree = 0
        self.kv_page_bytes_shard = 0
        self.kv_pool_bytes_shard = 0
        # host spill pool: geometry set once (set_host_info), occupancy
        # each step; host_pool_pages == 0 means no spill tier, and the
        # snapshot's host block is gated on it
        self.host_pool_pages = 0
        self.host_page_bytes = 0
        self.host_pool_bytes = 0
        self.host_pages_used = 0
        self.host_occupancy = 0.0

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

    def on_adopt(self, request_id: int):
        """Snapshot-restored request entering this engine: counted as
        adopted, not added, and with no arrival stamp — its queue-wait
        and TTFT belong to its original admission."""
        self.counters["requests_adopted"] += 1

    def on_admission(self, request_id: int, cached_tokens: int,
                     resumed: bool = False):
        """First chunk of an admission scheduled; the queue-wait sample
        is taken only for the ORIGINAL admission."""
        self.counters["admissions"] += 1
        if cached_tokens > 0:
            self.counters["prefix_hits"] += 1
            self.counters["cached_tokens_served"] += cached_tokens
            self.counters["prefill_tokens_skipped"] += cached_tokens
        if not resumed:
            t0 = self._arrive_t.get(request_id)
            if t0 is not None:
                self._queue_wait_samples.append(time.perf_counter() - t0)

    def on_first_token(self, request_id: int):
        t0 = self._arrive_t.get(request_id)
        if t0 is not None:
            dt = time.perf_counter() - t0
            self._ttft_sum += dt
            self._ttft_count += 1
            self._ttft_samples.append(dt)

    def on_prefill(self, num_tokens: int):
        self.counters["prefill_tokens"] += num_tokens
        self.counters["prefill_chunks"] += 1

    def on_decode(self, num_tokens: int):
        self.counters["decode_tokens"] += num_tokens

    def on_decode_launch(self, k: int, rows: int, tokens: int,
                         seconds: Optional[float] = None):
        """One decode-side launch of `k` steps (1 for plain decode) over
        `rows` live rows that emitted `tokens` tokens in `seconds` of
        launch wall time; the TPOT sample is seconds / tokens."""
        self.counters["decode_launches"] += 1
        self.counters["decode_launch_steps"] += int(k)
        self.counters["decode_launch_rows"] += int(rows)
        if seconds is not None and seconds > 0 and tokens > 0:
            self._tpot_samples.append(seconds / tokens)

    def on_adapter_mix(self, distinct: int):
        """Distinct adapters (base rows excluded) in one decode launch."""
        self._adapter_mix_samples.append(int(distinct))

    def tokens_per_launch(self) -> Optional[float]:
        """Mean decode tokens emitted per row per decode-side launch
        (None before any): 1.0 for plain decode, up to K for multi-step
        decode."""
        if not self.counters["decode_launch_rows"]:
            return None
        return (self.counters["decode_tokens"]
                / self.counters["decode_launch_rows"])

    def on_spec_step(self, drafted: int, accepted: int, emitted: int,
                     rolled_back: int, rows: int):
        """One verify launch over `rows` emitting sequences: `drafted`
        draft tokens scored, `accepted` kept, `emitted` tokens in all
        (accepted + corrections/bonuses), `rolled_back` rejected-draft
        slots truncated out of the paged cache."""
        self.counters["spec_steps"] += 1
        self.counters["spec_verified_rows"] += rows
        self.counters["spec_drafted_tokens"] += drafted
        self.counters["spec_accepted_tokens"] += accepted
        self.counters["spec_emitted_tokens"] += emitted
        self.counters["spec_rollback_tokens"] += rolled_back
        self._accepted_samples.append(accepted)

    def on_spec_draft_oom(self, dropped: int):
        self.counters["spec_draft_oom_drops"] += dropped

    def spec_acceptance_rate(self) -> Optional[float]:
        """accepted / drafted over the engine's life (None before any
        draft was scored)."""
        if not self.counters["spec_drafted_tokens"]:
            return None
        return (self.counters["spec_accepted_tokens"]
                / self.counters["spec_drafted_tokens"])

    def spec_tokens_per_step(self) -> Optional[float]:
        """Mean tokens emitted per sequence per verify launch (1.0 =
        speculation never paid)."""
        if not self.counters["spec_verified_rows"]:
            return None
        return (self.counters["spec_emitted_tokens"]
                / self.counters["spec_verified_rows"])

    def set_kv_info(self, *, kv_dtype, page_bytes, pool_bytes,
                    bytes_per_token, tp_degree=1, page_bytes_shard=None,
                    pool_bytes_shard=None):
        """Static KV-pool geometry: page and pool bytes summed over the
        tensor-parallel shards, one token's K+V over every layer, and
        what ONE rank pays (its shard's page and pool bytes; the
        `kv_pool_bytes` budget is per rank)."""
        self.kv_dtype = str(kv_dtype)
        self.kv_page_bytes = int(page_bytes)
        self.kv_pool_bytes = int(pool_bytes)
        self.kv_bytes_per_token = int(bytes_per_token)
        self.kv_tp_degree = int(tp_degree)
        self.kv_page_bytes_shard = int(
            page_bytes if page_bytes_shard is None else page_bytes_shard)
        self.kv_pool_bytes_shard = int(
            pool_bytes if pool_bytes_shard is None else pool_bytes_shard)

    def set_host_info(self, *, pool_pages, page_bytes):
        """Static host spill pool geometry: slot count and the bytes ONE
        host page carries — a radix page's K+V across every layer, scale
        rows included (num_layers x kv_page_bytes)."""
        self.host_pool_pages = int(pool_pages)
        self.host_page_bytes = int(page_bytes)
        self.host_pool_bytes = int(pool_pages) * int(page_bytes)

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
                      radix_evicted_pages=None,
                      host_pages_used=None, host_occupancy=None,
                      radix_evict_demoted=None, radix_evict_dropped=None,
                      kv_pages_demoted=None, kv_pages_promoted=None,
                      host_prefix_hits=None, host_pages_dropped=None):
        """None for an optional field means "leave it untouched": the
        engine passes its radix and spill values only when it has a
        prefix cache and a host pool, so an engine never zeroes a
        counter it does not own."""
        self.queue_depth = queue_depth
        self.running = running
        self.kv_used_pages = kv_used_pages
        self.kv_occupancy = kv_occupancy
        self.cached_pages = cached_pages
        self.radix_nodes = radix_nodes
        if radix_evicted_pages is not None:
            self.counters["radix_evicted_pages"] = radix_evicted_pages
        if host_pages_used is not None:
            self.host_pages_used = host_pages_used
        if host_occupancy is not None:
            self.host_occupancy = host_occupancy
        # radix-owned counters, synced by assignment (idempotent)
        for key, val in (("radix_evict_demoted", radix_evict_demoted),
                         ("radix_evict_dropped", radix_evict_dropped),
                         ("kv_pages_demoted", kv_pages_demoted),
                         ("kv_pages_promoted", kv_pages_promoted),
                         ("host_prefix_hits", host_prefix_hits),
                         ("host_pages_dropped", host_pages_dropped)):
            if val is not None:
                self.counters[key] = val

    # ---- derived ---------------------------------------------------------
    def tokens_per_second(self) -> float:
        dt = time.perf_counter() - self._t_start
        total = (self.counters["prefill_tokens"]
                 + self.counters["decode_tokens"])
        return total / dt if dt > 0 else 0.0

    def mean_ttft(self) -> Optional[float]:
        if not self._ttft_count:
            return None
        return self._ttft_sum / self._ttft_count

    def prefix_hit_rate(self) -> Optional[float]:
        if not self.counters["admissions"]:
            return None
        return self.counters["prefix_hits"] / self.counters["admissions"]

    def ttft_percentiles(self):
        """{p50, p90, p99} seconds over the bounded TTFT window."""
        return self.reservoir_percentiles("ttft")

    def queue_wait_percentiles(self):
        return self.reservoir_percentiles("queue_wait")

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
        })
        # pool bytes gate the block (not page bytes): a heterogeneous
        # merge zeroes the per-page gauges while the pooled bytes stay
        # exact, and they must still surface
        if self.kv_page_bytes or self.kv_pool_bytes:
            snap.update({
                "kv_dtype": self.kv_dtype,
                "kv_page_bytes": self.kv_page_bytes,
                "kv_pool_bytes": self.kv_pool_bytes,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "kv_tp_degree": self.kv_tp_degree,
                "kv_page_bytes_shard": self.kv_page_bytes_shard,
                "kv_pool_bytes_shard": self.kv_pool_bytes_shard,
            })
        if self.host_pool_pages:
            snap.update({
                "host_pool_pages": self.host_pool_pages,
                "host_page_bytes": self.host_page_bytes,
                "host_pool_bytes": self.host_pool_bytes,
                "host_pages_used": self.host_pages_used,
                "host_occupancy": round(self.host_occupancy, 4),
            })
        hr = self.prefix_hit_rate()
        if hr is not None:
            snap["prefix_hit_rate"] = round(hr, 4)
        ar = self.spec_acceptance_rate()
        if ar is not None:
            snap["spec_acceptance_rate"] = round(ar, 4)
        tps = self.spec_tokens_per_step()
        if tps is not None:
            snap["spec_tokens_per_step"] = round(tps, 4)
        tpl = self.tokens_per_launch()
        if tpl is not None:
            snap["decode_tokens_per_launch"] = round(tpl, 4)
        ttft = self.mean_ttft()
        if ttft is not None:
            snap["mean_ttft_ms"] = round(ttft * 1e3, 3)
        for name, (scale, suffix, digits) in self._reservoir_fmt.items():
            for q, v in self.reservoir_percentiles(name).items():
                if v is not None:
                    snap[f"{name}_{q}{suffix}"] = round(v * scale, digits)
        return snap

    # ---- Prometheus exposition -------------------------------------------
    def prometheus_text(self, *, prefix: str = "paddle_serving",
                        labels: Optional[dict] = None,
                        emit_type: bool = True) -> str:
        """This metrics object as Prometheus exposition text, rendered
        from `snapshot()`, so the scrape cannot disagree with it: every
        counter, gauge and reservoir percentile surfaces. Keys of the
        counters dict are typed `counter`, the rest `gauge`."""
        lines = prometheus_lines(self.snapshot(),
                                 counter_keys=set(self.counters),
                                 prefix=prefix, labels=labels,
                                 emit_type=emit_type)
        return "\n".join(lines) + "\n" if lines else ""

    # ---- cross-replica aggregation ---------------------------------------
    @classmethod
    def merge(cls, *metrics: "ServingMetrics",
              name: str = "fleet") -> "ServingMetrics":
        """Combine per-replica metrics into ONE summary: counters and TTFT
        aggregates sum, every percentile reservoir merges by a balanced
        NEWEST-first draw across replicas (bounded by the window, so an
        overflowing union keeps each replica's freshest samples), count
        gauges sum, and kv_occupancy becomes the pooled used/total ratio.
        Per-page geometry that differs between replicas becomes a
        sentinel (0, or "mixed" for the dtype). tokens_per_second spans
        the earliest source's start, so the merged rate is the fleet's
        throughput."""
        out = cls(name=name)
        total_pages_used = 0
        total_pages = 0.0
        for m in metrics:
            for k, v in m.counters.items():
                out.counters[k] = out.counters.get(k, 0) + v
            out._ttft_sum += m._ttft_sum
            out._ttft_count += m._ttft_count
            out._t_start = min(out._t_start, m._t_start)
            out.queue_depth += m.queue_depth
            out.running += m.running
            out.kv_used_pages += m.kv_used_pages
            out.cached_pages += m.cached_pages
            out.radix_nodes += m.radix_nodes
            out.kv_pool_bytes += m.kv_pool_bytes
            # pool-weighted occupancy: each replica's page count from its
            # byte geometry
            if m.kv_page_bytes:
                total_pages += m.kv_pool_bytes / m.kv_page_bytes
                total_pages_used += m.kv_used_pages
        if total_pages:
            out.kv_occupancy = total_pages_used / total_pages
        pbs = {m.kv_page_bytes for m in metrics if m.kv_page_bytes}
        dts = {m.kv_dtype for m in metrics if m.kv_page_bytes}
        bpts = {m.kv_bytes_per_token for m in metrics if m.kv_page_bytes}
        out.kv_page_bytes = pbs.pop() if len(pbs) == 1 else 0
        out.kv_dtype = dts.pop() if len(dts) == 1 \
            else ("mixed" if dts else None)
        out.kv_bytes_per_token = bpts.pop() if len(bpts) == 1 else 0
        # the per-rank geometry follows the same rule: a fleet mixing TP
        # degrees gets sentinels, while the pooled kv_pool_bytes and
        # occupancy above, from each replica's global geometry, stay
        # exact
        tps = {m.kv_tp_degree for m in metrics if m.kv_page_bytes}
        pbss = {m.kv_page_bytes_shard for m in metrics if m.kv_page_bytes}
        plss = {m.kv_pool_bytes_shard for m in metrics if m.kv_page_bytes}
        out.kv_tp_degree = tps.pop() if len(tps) == 1 else 0
        out.kv_page_bytes_shard = pbss.pop() if len(pbss) == 1 else 0
        out.kv_pool_bytes_shard = plss.pop() if len(plss) == 1 else 0
        # host pools: slots, bytes and use sum over the replicas that
        # spill; per-page bytes follow the same sentinel rule
        out.host_pool_pages = sum(m.host_pool_pages for m in metrics)
        out.host_pool_bytes = sum(m.host_pool_bytes for m in metrics)
        out.host_pages_used = sum(m.host_pages_used for m in metrics)
        if out.host_pool_pages:
            out.host_occupancy = out.host_pages_used / out.host_pool_pages
        hpbs = {m.host_page_bytes for m in metrics if m.host_pool_pages}
        out.host_page_bytes = hpbs.pop() if len(hpbs) == 1 else 0
        # reservoirs: per name, walk every source from its freshest
        # sample backwards, round-robin, until the window fills; reversed
        # so the merged deque stays oldest -> newest like a live one
        fmts = {}
        for m in metrics:
            for rname in m._reservoirs:
                fmts.setdefault(rname, m._reservoir_fmt[rname])
        for rname, (scale, suffix, digits) in fmts.items():
            srcs = [list(m._reservoirs[rname]) for m in metrics
                    if rname in m._reservoirs]
            picked = []
            depth = 1
            while len(picked) < PERCENTILE_WINDOW and \
                    any(depth <= len(s) for s in srcs):
                for src in srcs:
                    if depth <= len(src) and len(picked) < PERCENTILE_WINDOW:
                        picked.append(src[-depth])
                depth += 1
            out.add_reservoir(rname, scale=scale, suffix=suffix,
                              digits=digits).extend(reversed(picked))
        return out
