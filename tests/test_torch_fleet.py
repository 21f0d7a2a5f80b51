"""The port's in-process fleet against the reference's on the CPU.

Same seeded weights on both sides (through models/convert.py), pinned
single buckets, greedy at fp32, one fake clock per fleet:

* the radix `match_len` probe is read-only (no LRU bump, no refcount);
* the three routers make the reference routers' picks on the same
  candidates (`RandomRouter` with the same seed included), and
  `role_candidates` filters and falls back as the reference's does;
* a replica crash mid-run and a deliberate drain lose no request and no
  token: every stream equals the reference `Fleet`'s crash run (one
  reference run, in a module fixture), with the same fleet counters and
  the same per-handle migrations, and every pool reclaims;
* `ServingMetrics.merge` against the reference test's hand-computed
  merge; the fleet's Prometheus scrape names the reference fleet's
  metrics, less those of features the port does not have;
* a prefill-role engine's hand-off and `release_prefix` (make cold, then
  drop) against the reference engine's requests and counters;
* the `FleetServer` stream's event shape, tenant and SLO shedding, and
  one `HttpFrontend` exchange over loopback (SSE, JSON, /metrics,
  /healthz, 404, 400).
"""
import asyncio
import json

import numpy as np
import pytest

from paddle_tpu.serving import Fleet as JaxFleet
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.fleet import router as ref_router
from paddle_tpu.serving.kv_cache import BlockAllocator as JaxAllocator
from paddle_tpu.serving.radix_cache import RadixCache as JaxRadix
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch.profiler.exposition import parse_exposition_names
from paddle_tpu_torch.serving import (EngineOverloaded, Fleet, FleetServer,
                                      HttpFrontend, ReplicaState,
                                      ServingEngine, ServingMetrics)
from paddle_tpu_torch.serving.fleet import (PrefixAffinityRouter,
                                            RandomRouter, RoundRobinRouter,
                                            SloUnattainable,
                                            TenantThrottled, role_candidates)
from paddle_tpu_torch.serving.kv_cache import BlockAllocator
from paddle_tpu_torch.serving.radix_cache import RadixCache
from paddle_tpu_torch.utils import faults

from _torch_parity import model_pair

KW = dict(num_pages=64, page_size=8, token_budget=64, batch_buckets=[8],
          prefill_buckets=[32], pages_buckets=[8], temperature=0.0)
# metrics of the reference feature the port does not have: the
# compiled-program cache
UNPORTED = {"recompiles", "compile_cache_hits", "compile_cache_misses",
            "compile_cache_rejects"}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=0)


def _prompts(k, seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 128, (rng.randint(4, 20),)).tolist(),
             int(rng.randint(3, 9))) for _ in range(k)]


# ------------------------------------------------------------ match_len
@pytest.mark.parametrize("side", ["port", "reference"])
def test_match_len_is_read_only(side):
    """The router's probe leaves refcounts, LRU stamps and the tick
    untouched and agrees with `match` — on both sides alike."""
    alloc_cls, radix_cls = ((BlockAllocator, RadixCache) if side == "port"
                            else (JaxAllocator, JaxRadix))
    alloc = alloc_cls(num_pages=64, page_size=8)
    cache = radix_cls(alloc)
    old, new = list(range(16)), list(range(100, 116))
    for toks in (old, new):
        seq = alloc.alloc_sequence(16)
        cache.insert(toks, seq.pages)
        alloc.free_sequence(seq)
    refs = dict(alloc._refs)
    lru = {id(n): n.last_use for n in cache._iter_nodes()}
    tick = cache._tick
    for _ in range(10):
        assert cache.match_len(old) == 16
    assert dict(alloc._refs) == refs and cache._tick == tick
    assert {id(n): n.last_use for n in cache._iter_nodes()} == lru
    assert cache.evict(1) >= 1                 # `old` is still the victim
    assert cache.match_len(old) == 0 and cache.match_len(new) == 16
    for probe in (new, new[:8] + [99] * 8, new + [1, 2], [7] * 24):
        assert cache.match_len(probe) == cache.match(probe)[1]


# --------------------------------------------------------------- routers
class _Cand:
    """A router candidate: name, load, cached prefix and adapters."""

    def __init__(self, name, load, cached, adapters=(), role="both"):
        self.name, self.load, self.role = name, load, role
        self._cached, self._adapters = cached, set(adapters)

    def match_len(self, tokens, adapter=None):
        n = 0
        for a, b in zip(self._cached, tokens):
            if a != b:
                break
            n += 1
        return (n // 8) * 8 if adapter is None or \
            adapter in self._adapters else 0

    def has_adapter(self, adapter):
        return adapter is None or adapter in self._adapters


def _picks(mod, seed):
    rng = np.random.RandomState(seed)
    cands = [_Cand(f"r{i}", int(rng.randint(0, 4)),
                   rng.randint(0, 4, (24,)).tolist(),
                   adapters=["a"] if i % 2 else []) for i in range(4)]
    routers = [mod.PrefixAffinityRouter(), mod.RandomRouter(seed=seed),
               mod.RoundRobinRouter()]
    picks = []
    for _ in range(40):
        toks = rng.randint(0, 4, (rng.randint(4, 24),)).tolist()
        adapter = "a" if rng.rand() < 0.3 else None
        live = [c for c in cands if rng.rand() < 0.8] or cands[:1]
        picks.append([r.route(toks, live, adapter=adapter).name
                      for r in routers])
    return picks


@pytest.mark.parametrize("seed", [0, 1])
def test_routers_pick_what_the_reference_routers_pick(seed):
    import paddle_tpu_torch.serving.fleet.router as port_router
    got, want = _picks(port_router, seed), _picks(ref_router, seed)
    assert got == want
    assert len({p[0] for p in want}) > 1 and len({p[1] for p in want}) > 1


def test_role_candidates_filter_and_fall_back():
    ws = [_Cand("p", 0, [], role="prefill"), _Cand("d", 0, [], role="decode"),
          _Cand("b", 0, [])]
    for phase in ("prefill", "decode"):
        assert role_candidates(ws, phase) == \
            ref_router.role_candidates(ws, phase)
    assert [w.name for w in role_candidates(ws, "decode")] == ["d", "b"]
    assert role_candidates(ws[:1], "decode") == ws[:1]    # starved: all
    with pytest.raises(KeyError):
        role_candidates(ws, "bogus")


# ------------------------------------------------------------- failover
def _crash_run(engine_cls, fleet_cls, model, flt, prompts, **engine_kw):
    """Three replicas on one fake clock; replica-0 crashes after two
    fault checks and stays dead."""
    clock = FakeClock()
    fleet = fleet_cls([engine_cls(model, clock=clock, **engine_kw, **KW)
                       for _ in range(3)], clock=clock)
    flt.inject("fleet.replica_crash", payload="replica-0", after=2,
               times=-1)
    try:
        handles = [fleet.submit(p, max_new_tokens=m) for p, m in prompts]
        fleet.run()
    finally:
        flt.clear()
    return fleet, handles


@pytest.fixture(scope="module")
def reference_crash(models):
    prompts = _prompts(6)
    fleet, handles = _crash_run(JaxEngine, JaxFleet, models[0], ref_faults,
                                prompts)
    names = parse_exposition_names(fleet.prometheus_text())
    res = {"tokens": [h.tokens for h in handles],
           "reasons": [h.finish_reason for h in handles],
           "migrations": [h.migrations for h in handles],
           "counters": dict(fleet.counters),
           "states": {r.name: r.state.value for r in fleet.replicas},
           "names": names}
    fleet.shutdown()
    return prompts, res


def _reclaimed(fleet):
    for r in fleet.replicas:
        r.engine.reset_prefix_cache()
        assert r.engine.allocator.num_used == 0
        r.engine.allocator.check_invariants()


def test_crash_failover_equals_the_reference_fleet(models, reference_crash):
    prompts, ref = reference_crash
    fleet, handles = _crash_run(ServingEngine, Fleet, models[1], faults,
                                prompts, device="cpu")
    assert fleet.replica("replica-0").state is ReplicaState.DEAD
    assert [h.tokens for h in handles] == ref["tokens"]
    assert [h.finish_reason for h in handles] == ref["reasons"]
    assert [h.migrations for h in handles] == ref["migrations"]
    assert dict(fleet.counters) == ref["counters"]
    assert ref["counters"]["requests_migrated"] >= 1
    assert ref["counters"]["requests_lost"] == 0
    assert {r.name: r.state.value for r in fleet.replicas} == ref["states"]
    _reclaimed(fleet)
    # the scrape names the reference fleet's metrics, less the unported
    names = parse_exposition_names(fleet.prometheus_text())
    unported = {f"paddle_serving_{k}" for k in UNPORTED}
    assert names == ref["names"] - unported
    assert unported <= ref["names"]


def test_drain_is_zero_loss(models, reference_crash):
    """A drain mid-run migrates every live request with its tokens so
    far; the streams equal the reference fleet's."""
    prompts, ref = reference_crash
    clock = FakeClock()
    fleet = Fleet([ServingEngine(models[1], device="cpu", clock=clock, **KW)
                   for _ in range(3)], clock=clock)
    seen = {}
    handles = [fleet.submit(p, max_new_tokens=m) for p, m in prompts]
    for h in handles:
        h.subscribe(lambda ev, rid=h.request_id: seen.setdefault(
            rid, []).append(ev))
    for _ in range(3):
        fleet.step_all()
    victim = fleet._assign[handles[0].request_id].name
    before = {h.request_id: list(h.tokens) for h in handles}
    assert fleet.drain(victim) >= 1
    fleet.run()
    assert [h.tokens for h in handles] == ref["tokens"]
    for h in handles:
        assert h.tokens[:len(before[h.request_id])] == before[h.request_id]
        toks = [e["token"] for e in seen[h.request_id] if e["type"] == "token"]
        assert toks == h.tokens          # each token streamed exactly once
    assert fleet.counters["requests_lost"] == 0
    assert fleet.counters["requests_migrated"] >= 1
    assert fleet.replica(victim).state is ReplicaState.DRAINED
    _reclaimed(fleet)


# --------------------------------------------------------------- metrics
def test_merge_hand_computed():
    """The reference test's hand-computed merge."""
    a, b = ServingMetrics(name="a"), ServingMetrics(name="b")
    a.counters["requests_added"], b.counters["requests_added"] = 3, 5
    a.counters["decode_tokens"], b.counters["decode_tokens"] = 100, 40
    a.counters["prefix_hits"] = 2
    a.counters["admissions"], b.counters["admissions"] = 4, 6
    a._ttft_samples.extend([0.010, 0.030])
    b._ttft_samples.extend([0.020, 0.040])
    a._queue_wait_samples.extend([0.001])
    b._queue_wait_samples.extend([0.003, 0.005])
    a._ttft_sum, a._ttft_count = 0.040, 2
    b._ttft_sum, b._ttft_count = 0.060, 2
    a.set_host_info(pool_pages=4, page_bytes=100)
    a.host_pages_used = 3
    m = ServingMetrics.merge(a, b)
    assert m.counters["requests_added"] == 8
    assert m.counters["decode_tokens"] == 140
    assert m.counters["admissions"] == 10 and m.counters["prefix_hits"] == 2
    assert m.mean_ttft() == pytest.approx(0.025)
    pct = m.ttft_percentiles()
    assert pct["p50"] == pytest.approx(0.030)
    assert pct["p99"] == pytest.approx(0.040)
    assert m.queue_wait_percentiles()["p50"] == pytest.approx(0.003)
    assert m.prefix_hit_rate() == pytest.approx(0.2)
    snap = m.snapshot()
    assert snap["ttft_p50_ms"] == pytest.approx(30.0)
    assert snap["queue_wait_p50_ms"] == pytest.approx(3.0)
    assert snap["mean_ttft_ms"] == pytest.approx(25.0)
    assert (snap["host_pool_pages"], snap["host_pages_used"],
            snap["host_occupancy"]) == (4, 3, 0.75)
    text = m.prometheus_text()
    assert "# TYPE paddle_serving_requests_added counter" in text
    assert "paddle_serving_requests_added 8" in text
    assert "# TYPE paddle_serving_queue_depth gauge" in text


# ---------------------------------------------------- prefill role
ENG = dict(num_pages=40, page_size=8, token_budget=48, batch_buckets=[8],
           prefill_buckets=[32], pages_buckets=[8], temperature=0.0)
PROMPTS = [(list(range(1, 21)), 6),
           ([5, 5, 5, 5] + list(range(40, 56)), 5),
           (list(range(100, 118)), 7)]


def _handoff_and_release(make):
    """The reference tests' prefill-role hand-off (with a colocate-pinned
    adoption) and release_prefix (make cold, then drop)."""
    eng = make(role="prefill")
    prompt, m = PROMPTS[0]
    rid = eng.add_request(prompt, max_new_tokens=m)
    while eng.has_work():
        eng.step()
    req = eng.requests[rid]
    toks = (prompt + list(req.output_ids))[:req.handoff_prefix_len]
    n, payloads = eng.export_prefix(toks)
    rec = {"request_id": 777, "prompt_ids": prompt, "output_ids": [],
           "max_new_tokens": m, "eos_token_id": None,
           "num_preemptions": 0, "aborted": False, "adapter": None,
           "colocate": True, "deadline_remaining_s": None}
    eng.adopt_requests([rec])
    colocated = eng.run()[777]
    res = {"reason": req.finish_reason, "out": list(req.output_ids),
           "handoff_len": req.handoff_prefix_len, "exported": n,
           "payloads": len(payloads), "colocated": colocated,
           "colocated_reason": eng.requests[777].finish_reason,
           "handoffs": eng.metrics.counters["prefill_handoffs"]}
    eng.shutdown()
    eng = make()
    prompt, m = PROMPTS[2]
    eng.add_request(prompt, max_new_tokens=m)
    eng.run()
    toks = prompt[:(len(prompt) // 8) * 8]
    used0 = eng.allocator.num_used
    res["released"] = eng.release_prefix(toks)
    res["used_after_release"] = eng.allocator.num_used - used0
    res["still_cached"] = eng.radix.match_len(toks)
    res["dropped"] = eng.release_prefix(toks, drop=True)
    res["used_after_drop"] = used0 - eng.allocator.num_used
    res["unknown"] = eng.release_prefix([99, 98, 97])
    res["counted"] = eng.metrics.counters["kv_pages_released"]
    eng.radix.check_invariants()
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.shutdown()
    return res


def test_prefill_role_and_release_equal_the_reference(models):
    ref = _handoff_and_release(
        lambda **kw: JaxEngine(models[0], **ENG, **kw))
    got = _handoff_and_release(
        lambda **kw: ServingEngine(models[1], device="cpu", **ENG, **kw))
    assert got == ref
    assert ref["reason"] == "handoff" and 1 <= len(ref["out"]) < 6
    assert ref["handoff_len"] == 16 and ref["payloads"] == 2
    assert ref["out"] == ref["colocated"][:len(ref["out"])]
    assert ref["dropped"] >= 1 and ref["used_after_release"] == 0


# ---------------------------------------------------- server and HTTP
def _fleet(models, n, clock=None, **fleet_kw):
    return Fleet([ServingEngine(models[1], device="cpu", clock=clock, **KW)
                  for _ in range(n)], clock=clock, **fleet_kw)


def test_stream_event_shape(models):
    fleet = _fleet(models, 2)

    async def go():
        async with FleetServer(fleet, idle_sleep_s=0.0) as server:
            stream = await server.submit([1, 2, 3, 4, 5], max_new_tokens=3)
            return [ev async for ev in stream]

    events = asyncio.run(go())
    fleet.shutdown()
    assert [e["type"] for e in events] == ["token"] * 3 + ["finish"]
    assert [e["index"] for e in events[:3]] == [0, 1, 2]
    assert events[-1]["finish_reason"] == "length"
    assert events[-1]["num_tokens"] == 3
    assert len({e["request_id"] for e in events}) == 1


def test_tenant_and_slo_shedding(models):
    fleet = _fleet(models, 2, max_inflight_per_tenant=2)
    fleet.submit([1, 2, 3], max_new_tokens=2, tenant="a")
    fleet.submit([4, 5, 6], max_new_tokens=2, tenant="a")
    with pytest.raises(TenantThrottled) as ei:
        fleet.submit([7, 8, 9], max_new_tokens=2, tenant="a")
    assert ei.value.tenant == "a" and ei.value.limit == 2
    assert isinstance(ei.value, EngineOverloaded)
    hb = fleet.submit([7, 8, 9], max_new_tokens=2, tenant="b")
    fleet.run()
    assert hb.finished and fleet.counters["tenant_throttled"] == 1

    fleet = _fleet(models, 2, est_ttft_per_queued_s=1.0)
    for r in fleet.replicas:                  # queue depth 1 everywhere
        r.engine.add_request([1, 2, 3], max_new_tokens=1)
    with pytest.raises(SloUnattainable) as ei:
        fleet.submit([4, 5, 6], max_new_tokens=2, ttft_slo_s=0.5)
    assert ei.value.est_ttft_s == 1.0 and fleet.counters["slo_sheds"] == 1
    h = fleet.submit([4, 5, 6], max_new_tokens=2, tpot_slo_s=1e3)
    fleet.run()
    assert h.finished
    # targets become deadlines: a hopeless TPOT expires on the clock
    clock = FakeClock()
    fleet = _fleet(models, 1, clock=clock)
    h = fleet.submit(list(range(1, 9)), max_new_tokens=4, ttft_slo_s=1e-4,
                     tpot_slo_s=1e-5)
    fleet.step_all()
    clock.t += 1.0
    fleet.run()
    assert h.finish_reason == "expired"


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = dict(ln.split(": ", 1) for ln in lines[1:] if ": " in ln)
    return int(lines[0].split(" ")[1]), headers, rest


def test_http_frontend_end_to_end(models):
    fleet = _fleet(models, 2)

    async def scenario():
        out = {}
        async with FleetServer(fleet) as server, \
                HttpFrontend(server, port=0) as front:
            port = front.port
            out["healthz"] = await _http(port, "GET", "/healthz")
            out["sse"] = await asyncio.gather(*[
                _http(port, "POST", "/v1/completions",
                      {"prompt_ids": p, "max_new_tokens": 5})
                for p in ([1, 2, 3, 4, 5], list(range(30, 42)))])
            out["json"] = await _http(port, "POST", "/v1/completions",
                                      {"prompt_ids": [1, 2, 3, 4, 5],
                                       "max_new_tokens": 5,
                                       "stream": False})
            out["metrics"] = await _http(port, "GET", "/metrics")
            out["missing"] = await _http(port, "GET", "/nope")
            out["bad"] = await _http(port, "POST", "/v1/completions",
                                     {"wrong": True})
        return out

    r = asyncio.run(scenario())
    st, _, body = r["healthz"]
    doc = json.loads(body)
    assert st == 200 and doc["status"] == "ok"
    assert set(doc["replicas"]) == {"replica-0", "replica-1"}
    streamed = []
    for st, hdr, body in r["sse"]:
        assert st == 200 and hdr["Content-Type"] == "text/event-stream"
        events = [c[len("data: "):] for c in body.decode().split("\n\n")
                  if c.startswith("data: ")]
        assert events[-1] == "[DONE]"
        events = [json.loads(e) for e in events[:-1]]
        assert events[-1]["type"] == "finish"
        streamed.append([e["token"] for e in events[:-1]])
        assert [e["index"] for e in events[:-1]] == [0, 1, 2, 3, 4]
        rid = events[-1]["request_id"]
        assert fleet.handle(rid).tokens == streamed[-1]
    st, _, body = r["json"]
    assert st == 200 and json.loads(body)["tokens"] == streamed[0]
    st, hdr, body = r["metrics"]
    text = body.decode()
    assert st == 200 and hdr["Content-Type"].startswith("text/plain")
    assert "# TYPE paddle_serving_requests_added counter" in text
    assert 'replica="replica-0"' in text
    assert r["missing"][0] == 404 and r["bad"][0] == 400
    fleet.shutdown()
