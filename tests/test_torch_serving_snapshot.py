"""The port's snapshot/resume and request tracing on the CPU.

Snapshot: the same run on the reference engine and the port's (same
seeded weights through models/convert.py, same pinned single buckets,
the same injectable clock, greedy at fp32) snapshots the same request
records — keys, types and values, `rng_key` excepted (the port keeps
its torch.Generator state there) — and survives a JSON round trip. A
resumed engine completes every request with the uninterrupted run's
tokens: mid-prefill and mid-decode, at a K boundary of a multi-step
engine (resumed at K=4 and at K=1), and with drafts in flight. A schema
version mismatch is refused typed; a fatal fault drains to the snapshot
`EngineFailure` carries; `vacate` gives back every page.

Tracing: the reference engine and the port's, each with a tracer on
the same counting clock, record for every request the same spans and
marks — names, arguments (engine names excepted) and clock stamps — on
16 mixed requests and on a shed/abort/retry/quarantine run (the K-step
and verify launches' traces are held in the multi-step and speculative
files, on their reference drains). Beside that, every request of the
16-request workload has its queue wait, admission, prefill spans
covering its prompt, one decode span per token after the first, its
first-token mark and its finish; sheds, aborts, retries, quarantines and
preemptions are marked; with tracing off nothing trace-related is
built; the Chrome export loads with json.

The reference engine drains once in each snapshot fixture and once per
trace-parity case.
"""
import json

import numpy as np
import pytest

from paddle_tpu import serving as ref_serving
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.serving import (EngineFailure, EngineOverloaded,
                                      FlightRecorder, NgramProposer,
                                      RequestTracer, RetryPolicy,
                                      ServingEngine, SnapshotVersionError,
                                      TransientDeviceError)
from paddle_tpu_torch.serving import trace as trace_mod
from paddle_tpu_torch.serving.engine import SNAPSHOT_MINOR, SNAPSHOT_VERSION
from paddle_tpu_torch.utils import faults

from _torch_parity import (assert_traces_equal, counting_clock,
                           model_pair, trace_view)

ENGINE_KW = dict(num_pages=64, page_size=8, token_budget=32,
                 batch_buckets=[8], prefill_buckets=[32], pages_buckets=[8],
                 temperature=0.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _workload(n=8, seed=4):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 128, (16,)).tolist()
    work = []
    for i in range(n):
        p = (shared + rng.randint(0, 128, (rng.randint(2, 6),)).tolist()
             if i % 3 == 0 else
             rng.randint(0, 128, (rng.randint(3, 28),)).tolist())
        work.append((p, int(rng.randint(4, 12))))
    return work


def _drive(eng, steps, work, ttl=True):
    """Add the workload (every other request with a TTL), then `steps`
    engine steps with the clock advancing 0.25 s a step."""
    clock = eng._clock
    rids = [eng.add_request(p, max_new_tokens=m,
                            ttl_s=30.0 if ttl and i % 2 else None)
            for i, (p, m) in enumerate(work)]
    for _ in range(steps):
        eng.step()
        clock.t += 0.25
    return rids


def _records(snap, rids):
    """The snapshot's request records with ids replaced by their
    position in the workload."""
    pos = {r: i for i, r in enumerate(rids)}
    return [dict(r, request_id=pos[r["request_id"]])
            for r in snap["requests"]]


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=2)


@pytest.fixture(scope="module")
def reference_snapshot(models):
    eng = JaxEngine(models[0], clock=FakeClock(), **ENGINE_KW)
    rids = _drive(eng, 3, _workload())
    return eng.snapshot(reason="test"), rids


@pytest.fixture(scope="module")
def uninterrupted(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in _workload()]
    out = eng.run()
    return [out[r] for r in rids]


# ------------------------------------------------------------- snapshot
def test_snapshot_records_equal_the_reference(models, reference_snapshot):
    """Same run, same clock: the same request records (mid-prefill,
    mid-decode and queued ones among them), version and minor; the
    port's rng_key is its generator state; a JSON round trip is
    lossless."""
    ref_snap, ref_rids = reference_snapshot
    eng = ServingEngine(models[1], device="cpu", clock=FakeClock(),
                        **ENGINE_KW)
    rids = _drive(eng, 3, _workload())
    snap = eng.snapshot(reason="test")
    assert _records(snap, rids) == _records(ref_snap, ref_rids)
    for key in ("version", "minor", "reason"):
        assert snap[key] == ref_snap[key]
    assert (snap["version"], snap["minor"]) == (SNAPSHOT_VERSION,
                                                SNAPSHOT_MINOR)
    assert snap["rng_key"] == eng._gen.get_state().tolist()
    assert json.loads(json.dumps(snap)) == snap
    outs = [len(r["output_ids"]) for r in snap["requests"]]
    assert 0 in outs and max(outs) > 1    # queued and decoding both
    assert snap["flight_recorder"]


def test_from_snapshot_continues_the_uninterrupted_run(models,
                                                       uninterrupted):
    """Snapshot mid-run, JSON round trip, vacate, resume on a fresh
    engine: every request completes under its original id with the
    uninterrupted run's tokens; both engines end with zero pages."""
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in _workload()]
    done = {}
    for _ in range(4):
        for rid, tok in eng.step():
            done.setdefault(rid, []).append(tok)
    snap = json.loads(json.dumps(eng.snapshot()))
    live = {r["request_id"] for r in snap["requests"]}
    assert eng.vacate() > 0
    assert eng.allocator.num_used == 0
    res = ServingEngine.from_snapshot(models[1], snap, device="cpu",
                                      **ENGINE_KW)
    assert res.metrics.counters["requests_adopted"] == len(live)
    assert res.metrics.counters["requests_added"] == 0
    res.run()
    for i, rid in enumerate(rids):
        if rid in live:
            assert res.requests[rid].output_ids == uninterrupted[i]
        else:
            assert eng.requests[rid].output_ids == uninterrupted[i]
    res.reset_prefix_cache()
    assert res.allocator.num_used == 0
    # ids restored past the counter: a new request does not collide
    assert res.add_request([1, 2, 3], max_new_tokens=1) > max(rids)


def test_resume_at_a_k_boundary_on_k4_and_k1(models):
    """A fatal multi-step launch drains to the snapshot EngineFailure
    carries; resumed on a K=4 and a K=1 engine, every request completes
    with the uninterrupted K=4 run's tokens."""
    kw = dict(ENGINE_KW, enable_prefix_cache=False)
    work = _workload(4)
    clean_eng = ServingEngine(models[1], device="cpu", decode_steps=4, **kw)
    rids = [clean_eng.add_request(p, max_new_tokens=m) for p, m in work]
    out = clean_eng.run()
    clean = [out[r] for r in rids]
    eng = ServingEngine(models[1], device="cpu", decode_steps=4, **kw)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
    eng.step()
    eng.step()
    with faults.injected("serving.engine.multi_decode_step",
                         exc=RuntimeError("INVALID_ARGUMENT: boom"),
                         times=1):
        with pytest.raises(EngineFailure) as ei:
            while eng.has_work():
                eng.step()
    snap = ei.value.snapshot
    assert snap is eng.last_snapshot and snap["requests"]
    assert "boom" in snap["flight_recorder"][-1]["failed"]
    with pytest.raises(EngineFailure):
        eng.step()
    for k in (4, 1):
        res = ServingEngine.from_snapshot(models[1], snap, device="cpu",
                                          decode_steps=k, **kw)
        res.run()
        for i, rid in enumerate(rids):
            got = (res.requests[rid] if rid in res.requests
                   else eng.requests[rid]).output_ids
            assert got == clean[i]
    assert eng.vacate() >= 0 and eng.allocator.num_used == 0


def test_resume_with_drafts_in_flight(models, uninterrupted):
    """Abort one request and snapshot the rest while speculation runs;
    the resumed spec engine completes the others with plain decode's
    tokens; no page leaks on either engine."""
    kw = dict(ENGINE_KW, spec_k=4, spec_buckets=[4])
    work = [(p, 11) for p, _ in _workload()]
    plain = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    prids = [plain.add_request(p, max_new_tokens=m) for p, m in work]
    out = plain.run()
    want = [out[r] for r in prids]
    eng = ServingEngine(models[1], device="cpu", proposer=NgramProposer(),
                        **kw)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
    while eng.metrics.counters["spec_steps"] < 2:
        eng.step()
    assert eng.abort(rids[2])
    eng.step()
    assert eng.requests[rids[2]].finish_reason == "abort"
    snap = json.loads(json.dumps(eng.snapshot(reason="test kill")))
    res = ServingEngine.from_snapshot(models[1], snap, device="cpu",
                                      proposer=NgramProposer(), **kw)
    res.run()
    for i, rid in enumerate(rids):
        if i == 2:
            continue
        got = (res.requests[rid] if rid in res.requests
               else eng.requests[rid]).output_ids
        assert got == want[i], i
    eng.vacate()
    for e in (eng, res):
        e.reset_prefix_cache()
        assert e.allocator.num_used == 0
        e.allocator.check_invariants()


def test_snapshot_version_is_checked(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    eng.add_request([1, 2, 3, 4], max_new_tokens=3)
    snap = eng.snapshot()
    with pytest.raises(SnapshotVersionError) as ei:
        ServingEngine.from_snapshot(models[1], dict(snap, version=2),
                                    device="cpu", **ENGINE_KW)
    assert (ei.value.found, ei.value.expected) == (2, SNAPSHOT_VERSION)
    newer = dict(snap, minor=SNAPSHOT_MINOR + 1, future_field=[1])
    with pytest.warns(RuntimeWarning, match="newer same-major"):
        res = ServingEngine.from_snapshot(models[1], newer, device="cpu",
                                          **ENGINE_KW)
    assert len(res.run()) == 1


def test_engine_failure_carries_the_snapshot(models):
    """An unclassified decode error fails the engine: EngineFailure's
    snapshot holds the live request and a flight recorder whose last
    record is the failing step; the engine refuses further work."""
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=8)
    with faults.injected("serving.engine.decode_step",
                         exc=RuntimeError("INTERNAL wedge"), times=1):
        with pytest.raises(EngineFailure) as ei:
            eng.run()
    snap = ei.value.snapshot
    assert len(snap["requests"]) == 1
    json.dumps(snap)
    assert "INTERNAL wedge" in snap["flight_recorder"][-1]["failed"]
    assert any(r.get("programs") for r in snap["flight_recorder"])
    with pytest.raises(EngineFailure) as again:
        eng.add_request([1], max_new_tokens=1)
    assert again.value.snapshot is snap


def test_vacate_reclaims_every_page(models):
    """Mid-flight requests and cached prefixes: vacate cancels every
    live request without donation and drops the tree, so the pool is
    empty; terminal states and gauges follow."""
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    for p, m in _workload():
        eng.add_request(p, max_new_tokens=m)
    for _ in range(5):
        eng.step()
    used = eng.allocator.num_used
    assert used > 0
    assert eng.vacate() == used
    assert eng.allocator.num_used == 0
    assert not eng.has_work()
    assert eng.metrics.kv_used_pages == 0
    eng.allocator.check_invariants()


# -------------------------------------------------------------- tracing
def test_trace_completeness_mixed_16(models):
    """16 mixed requests, no preemption: one queue wait, one admission,
    chunk tokens + cached tokens == the prompt, one decode span per
    token after the first, spans inside the trace's life."""
    work = _workload(16, seed=0)
    eng = ServingEngine(models[1], device="cpu", trace=True,
                        **dict(ENGINE_KW, num_pages=128, token_budget=64))
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
    out = eng.run()
    tracer = eng.tracer
    assert not tracer.live
    traces = {t.request_id: t for t in tracer.traces()}
    assert set(traces) == set(rids)
    for rid, (prompt, _) in zip(rids, work):
        tr = traces[rid]
        assert tr.finish_reason == "length"
        assert tr.count_spans("queue_wait") == 1
        assert tr.mark_names().count("admitted") == 1
        assert tr.mark_names().count("first_token") == 1
        admitted = next(m for m in tr.marks if m["name"] == "admitted")
        chunk_tokens = sum(s["args"]["length"] for s in tr.spans
                           if s["name"] == "prefill_chunk")
        assert chunk_tokens + admitted["args"]["cached_tokens"] == \
            len(prompt)
        assert tr.count_spans("decode_step") == len(out[rid]) - 1
        for s in tr.spans:
            assert tr.t_begin <= s["t0"] <= s["t1"] <= tr.t_end
        qw = next(s for s in tr.spans if s["name"] == "queue_wait")
        assert all(s["t0"] >= qw["t1"] for s in tr.spans
                   if s["name"] in ("prefill_chunk", "decode_step"))
    assert eng.metrics.counters["prefix_hits"] > 0


def test_trace_marks_shed_abort_retry_quarantine(models):
    eng = ServingEngine(models[1], device="cpu", trace=True, max_queue_len=2,
                        retry_policy=RetryPolicy(max_retries=4, base_s=0.0,
                                                 sleep=lambda s: None),
                        **ENGINE_KW)
    r0 = eng.add_request([1, 2, 3], max_new_tokens=6)
    r1 = eng.add_request([4, 5, 6], max_new_tokens=4)
    with pytest.raises(EngineOverloaded):
        eng.add_request([7, 8, 9], max_new_tokens=4)
    shed = [t for t in eng.tracer.completed if t.finish_reason == "shed"]
    assert len(shed) == 1 and "shed" in shed[0].mark_names()
    eng.step()
    eng.abort(r1)
    faults.inject("serving.engine.decode_step",
                  exc=TransientDeviceError("UNAVAILABLE"), times=1)
    faults.inject("serving.engine.nan_logits", payload=[0], after=1,
                  times=1)
    try:
        eng.run()
    finally:
        faults.clear()
        faults.reset_counts()
    traces = {t.request_id: t for t in eng.tracer.traces()}
    assert traces[r1].finish_reason == "abort"
    assert "retry" in traces[r0].mark_names()
    assert traces[r0].finish_reason == "quarantined"
    assert "quarantined" in traces[r0].mark_names()


def test_trace_spans_of_multi_step_and_verify_launches(models):
    """The K-step and verify launch families get their own spans."""
    work = _workload(4)
    for kw, name in ((dict(decode_steps=4), "multi_decode_step"),
                     (dict(proposer=NgramProposer(), spec_k=2),
                      "verify_step")):
        eng = ServingEngine(models[1], device="cpu", trace=True,
                            **ENGINE_KW, **kw)
        for p, m in work:
            eng.add_request(p, max_new_tokens=m)
        eng.run()
        for tr in eng.tracer.traces():
            assert tr.count_spans(name) > 0
            assert tr.count_spans("decode_step") == 0
            assert tr.finish_reason == "length"


def _trace_case(pkg, flt, model, case):
    """Run one tracing case on an engine of `pkg` (the reference's
    serving package or the port's, `flt` its fault registry) with a
    tracer on a counting clock; returns the trace view."""
    tracer = pkg.RequestTracer(clock_ns=counting_clock())
    extra = {"device": "cpu"} if pkg is port_serving else {}
    if case == "mixed16":
        eng = pkg.ServingEngine(model, trace=tracer, **extra, **dict(
            ENGINE_KW, num_pages=128, token_budget=64))
        for p, m in _workload(16, seed=0):
            eng.add_request(p, max_new_tokens=m)
        eng.run()
        return trace_view(tracer)
    eng = pkg.ServingEngine(model, trace=tracer, max_queue_len=2,
                            retry_policy=pkg.RetryPolicy(
                                max_retries=4, base_s=0.0,
                                sleep=lambda s: None),
                            **extra, **ENGINE_KW)
    eng.add_request([1, 2, 3], max_new_tokens=6)
    r1 = eng.add_request([4, 5, 6], max_new_tokens=4)
    with pytest.raises(pkg.EngineOverloaded):
        eng.add_request([7, 8, 9], max_new_tokens=4)
    eng.step()
    eng.abort(r1)
    flt.inject("serving.engine.decode_step",
               exc=pkg.TransientDeviceError("UNAVAILABLE"), times=1)
    flt.inject("serving.engine.nan_logits", payload=[0], after=1, times=1)
    try:
        eng.run()
    finally:
        flt.clear()
        flt.reset_counts()
    return trace_view(tracer)


@pytest.mark.parametrize("case", ["mixed16", "shed_abort_retry_quarantine"])
def test_traces_equal_the_reference(models, case):
    """Each engine with a tracer on the same counting clock: every
    request's trace (meta, stamps, finish reason, spans and marks in
    order by name, stamps and arguments) is the reference's, engine
    names excepted. The K-step and verify launches' traces are held
    against the reference in the multi-step and speculative files."""
    want = {"mixed16": (("queue_wait", "prefill_chunk", "decode_step"),
                        ("admitted", "first_token")),
            "shed_abort_retry_quarantine": (
                ("decode_step",), ("shed", "retry", "quarantined"))}[case]
    assert_traces_equal(_trace_case(port_serving, faults, models[1], case),
                        _trace_case(ref_serving, ref_faults, models[0],
                                    case), *want)


def test_trace_off_allocates_nothing(models, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("trace allocation with tracing off")
    monkeypatch.setattr(trace_mod.RequestTrace, "__init__", boom)
    monkeypatch.setattr(trace_mod.RequestTracer, "__init__", boom)
    eng = ServingEngine(models[1], device="cpu", decode_steps=2,
                        **ENGINE_KW)
    assert eng.tracer is None
    for p, m in _workload(6):
        eng.add_request(p, max_new_tokens=m)
    assert all(len(v) >= 1 for v in eng.run().values())


def test_shared_tracer_follows_an_adopted_request(models, tmp_path):
    """One tracer shared by two engines: a snapshot-adopted request
    keeps one trace with decode spans from both engines and an adopt
    mark; preemption marks show; the Chrome export loads with json."""
    tracer = RequestTracer()
    kw = dict(ENGINE_KW, num_pages=6, batch_buckets=[4],
              pages_buckets=[4])
    a = ServingEngine(models[1], device="cpu", trace=tracer, **kw)
    rids = [a.add_request(list(range(1 + i, 14 + i)), max_new_tokens=10)
            for i in range(3)]
    for _ in range(6):                  # the pool preempts at step 5
        a.step()
    decoded = [t.request_id for t in tracer.traces()
               if t.count_spans("decode_step")]
    assert decoded
    snap = a.snapshot()
    a.vacate()
    b = ServingEngine(models[1], device="cpu", trace=tracer,
                      **dict(kw, num_pages=64))
    b.adopt_requests(snap["requests"])
    b.run()
    assert not tracer.live
    for rid in rids:
        tr = next(t for t in tracer.traces() if t.request_id == rid)
        engines = {s["args"]["engine"] for s in tr.spans
                   if s["name"] == "decode_step"}
        assert b.metrics.name in engines and tr.finish_reason == "length"
        assert "adopt" in tr.mark_names()
        if rid in decoded:
            assert engines == {a.metrics.name, b.metrics.name}
    assert a.metrics.counters["requests_preempted"] > 0
    assert any("preempted" in t.mark_names() for t in tracer.traces())
    path = str(tmp_path / "trace.json")
    tracer.export(path, flight_recorder=b.recorder)
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in spans} >= {"queue_wait", "prefill_chunk",
                                          "decode_step"}
    assert doc["requestTraces"] and doc["flightRecorder"]


def test_tracer_and_recorder_rings_are_bounded(models):
    tracer = RequestTracer(max_completed=4, clock_ns=iter(range(100)).__next__)
    for rid in range(10):
        tracer.begin(rid)
        tracer.finish(rid, "stop")
    assert [t.request_id for t in tracer.completed] == [6, 7, 8, 9]
    assert tracer.num_completed == 10
    tracer.span(99, "x", 0, 1)          # unknown ids: no-ops
    tracer.mark(99, "x")
    tracer.finish(9, "again")
    assert len(tracer.completed) == 4
    fr = FlightRecorder(max_steps=3)
    for i in range(5):
        fr.record({"step": i})
    assert [r["step"] for r in fr.records()] == [2, 3, 4]
    eng = ServingEngine(models[1], device="cpu", flight_recorder_steps=5,
                        **ENGINE_KW)
    for p, m in _workload(6):
        eng.add_request(p, max_new_tokens=m)
    eng.run()
    steps = [r["step"] for r in eng.timeline()]
    assert len(steps) == 5 and steps[-1] == \
        eng.metrics.counters["engine_steps"]
    for _ in range(3):
        eng.step()                      # idle steps are not recorded
    assert [r["step"] for r in eng.timeline()] == steps
