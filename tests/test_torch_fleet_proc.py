"""The port's cross-process fleet against the reference on the CPU.

In process: the port's `WorkerLoop` over the port's engine and the
reference's `WorkerLoop` over the reference's engine (the same weights
through models/convert.py) take the same scripted inbound messages —
adopt (fresh, and a record with tokens already generated), abort, a
duplicated adopt, stats, `fleet.decode_reject`, ping, a forced
heartbeat, drain; and, on bf16 and int8 KV pools, kv_prefix + kv_page
(adopted), kv_pull (exported), a kv_prefix aborted mid-stream, a
stream with a duplicated part, kv_release. Their outbound messages are
equal (types, rids, indices, tokens, kv_page data bytes), less time
fields, the engine counters and the loop's step count (an adopted
record's tokens replay through decode steps in the port), the
snapshots' generator state, and the stats fields of the compiled
programs the port does not have.

Across processes: `ProcessFleet` over CPU worker processes whose spec
builds the port's model from the reference's weights (`factory` kind,
`_torch_fleet_factory.py`, an .npz this module writes): streams equal
the reference in-process engine's, as the reference's own tests hold
`ProcessFleet` (`tests/test_fleet_proc.py`), through a lifecycle with
duplicated frames in both directions and a rolling restart mid-stream;
a rejection that re-lands on another worker and a `worker.kill9`
mid-stream, nothing lost; and prefill-to-decode with KV pages shipped
and both pools clean. A worker without `"device": "cpu"` refuses to
start on a machine without a card.
"""
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.fleet.transport import Channel as RefChannel
from paddle_tpu.serving.fleet.transport import chunk_payloads as ref_chunks
from paddle_tpu.serving.fleet.worker import WorkerLoop as RefLoop
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import ProcessFleet, ServingEngine
from paddle_tpu_torch.serving.fleet.transport import Channel, chunk_payloads
from paddle_tpu_torch.serving.errors import UnsupportedFeature
from paddle_tpu_torch.serving.fleet.worker import WorkerLoop, run_worker
from paddle_tpu_torch.utils import faults

from _torch_parity import SMALL, model_pair

TESTS = Path(__file__).resolve().parent
ENG = dict(num_pages=40, page_size=8, token_budget=48, batch_buckets=[8],
           prefill_buckets=[32], pages_buckets=[8], temperature=0.0)
# the reference tests' prompts: long enough that a prefill worker
# donates >= 2 full pages (page 8)
PROMPTS = [(list(range(1, 21)), 6),
           ([5, 5, 5, 5] + list(range(40, 56)), 5),
           (list(range(100, 118)), 7)]
LONG = ([3, 1, 4, 1, 5, 9, 2, 6], 40)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, ref_faults):
        f.clear()
        f.reset_counts()
    yield
    for f in (faults, ref_faults):
        f.clear()
        f.reset_counts()


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=0)


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's streams of PROMPTS and LONG (one drain),
    and the engine, its prefix cache emptied (its programs compiled)."""
    eng = JaxEngine(models[0], **ENG)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in PROMPTS]
    long_rid = eng.add_request(LONG[0], max_new_tokens=LONG[1])
    out = eng.run()
    eng.reset_prefix_cache()
    return {"streams": [out[r] for r in rids], "long": out[long_rid],
            "engine": eng}


# ------------------------------------------------------------ in process
class FakeStore:
    """A dict with the store calls both Channels make."""

    def __init__(self):
        self.d = {}

    def set(self, key, value):
        self.d[key] = bytes(value)

    def get(self, key, wait=True):
        return self.d.get(key)

    def check(self, keys):
        return all(k in self.d for k in keys)

    def add(self, key, n):
        self.d[key] = str(int(self.d.get(key, b"0")) + int(n)).encode()
        return int(self.d[key])

    def delete_key(self, key):
        return self.d.pop(key, None) is not None


_SIDES = {"port": (WorkerLoop, Channel, faults),
          "ref": (RefLoop, RefChannel, ref_faults)}


def _loop(side, engine):
    loop_cls, chan_cls, _ = _SIDES[side]
    store = FakeStore()
    loop = loop_cls(engine, chan_cls(store, me="w0", peer="host"),
                    heartbeat_interval_s=1e9, clock=lambda: 0.0)
    return loop, chan_cls(store, me="host", peer="w0")


def _norm(frames):
    """Outbound frames less time fields, the engine counters, the loop's
    step count (the port replays an adopted record's generated tokens
    through decode steps where the reference re-prefills them), the
    generator state and the compiled-program / kernel-counter fields one
    side lacks."""
    out = []
    for fr in frames:
        p = dict(fr["payload"])
        for k in ("t", "counters", "steps"):
            p.pop(k, None)
        for k in ("num_compiled_programs", "kernel_launches",
                  "decode_launches"):
            p.pop(k, None)
        if isinstance(p.get("snapshot"), dict):
            snap = p["snapshot"]
            p["snapshot"] = {k: snap[k] for k in ("version", "reason",
                                                   "requests")}
        out.append((fr["type"], fr["seq"], p))
    return out


def _rec(rid, prompt, m, output=()):
    return {"request_id": rid, "prompt_ids": list(prompt),
            "output_ids": list(output), "max_new_tokens": m,
            "eos_token_id": None, "num_preemptions": 0, "aborted": False,
            "adapter": None, "colocate": False,
            "deadline_remaining_s": None}


def _request_script(side, engine, reference):
    loop, host = _loop(side, engine)
    fmod = _SIDES[side][2]
    out = []

    def drive():
        while engine.has_work():
            loop.step_once()
        out.append(_norm(host.recv_all()))

    loop.handle({"type": "adopt", "payload": {"recs": [
        _rec(1001, *PROMPTS[0]), _rec(1002, *PROMPTS[1])]}})
    drive()
    # a record that already generated 3 tokens (a migration)
    rec = _rec(1003, *PROMPTS[2], output=reference["streams"][2][:3])
    loop.handle({"type": "adopt", "payload": {"recs": [rec]}})
    drive()
    loop.handle({"type": "adopt", "payload": {"recs": [
        _rec(1004, *LONG)]}})
    loop.handle({"type": "abort", "payload": {"rid": 1004}})
    drive()
    for msg in ({"type": "stats",
                 "payload": {"reset_prefix_cache": True}},
                {"type": "ping", "payload": {}}):
        loop.handle(msg)
    with fmod.injected("fleet.decode_reject", payload=True, times=1):
        loop.handle({"type": "adopt", "payload": {"recs": [
            _rec(1005, *PROMPTS[0])]}})
    out.append(_norm(host.recv_all()))
    loop.heartbeat(force=True)
    loop.handle({"type": "drain", "payload": {}})
    loop.step_once()
    out.append(_norm(host.recv_all()))
    return out


def test_worker_loop_messages_equal_the_reference(models, reference):
    """Same inbound script, same outbound frames on both sides; the
    migrated record continues with the reference's tokens."""
    got = _request_script("port", ServingEngine(models[1], device="cpu",
                                                **ENG), reference)
    want = _request_script("ref", reference["engine"], reference)
    assert got == want
    events = [e for _, _, p in got[0] + got[1] for e in p.get("ev", [])]
    toks = {1003: reference["streams"][2][:3]}
    for rid, idx, tok in events:
        assert idx == len(toks.setdefault(rid, []))
        toks[rid].append(tok)
    assert [toks[r] for r in (1001, 1002, 1003)] == reference["streams"]
    assert [t for t, _, _ in got[3]] == ["stats", "pong", "reject"]
    assert [t for t, _, _ in got[4]] == ["heartbeat", "snapshot", "bye"]


def test_duplicated_adopt_frame_runs_the_request_once(models, reference):
    eng = ServingEngine(models[1], device="cpu", **ENG)
    loop, host = _loop("port", eng)
    msg = {"type": "adopt", "payload": {"recs": [_rec(2001, *PROMPTS[0])]}}
    loop.handle(msg)
    loop.handle(msg)
    while eng.has_work():
        loop.step_once()
    frames = host.recv_all()
    assert [f["payload"]["rids"] for f in frames
            if f["type"] == "adopted"] == [[2001], [2001]]
    ev = [e for f in frames if f["type"] == "events"
          for e in f["payload"]["ev"]]
    assert [i for _, i, _ in ev] == list(range(PROMPTS[0][1]))
    assert [t for _, _, t in ev] == reference["streams"][0]


def _kv_engines(models, kv):
    """(port engine, reference engine) with `kv` pages: bf16 models (their
    weights are never run here) or the fp32 pair with int8 KV."""
    if kv == "int8":
        return (ServingEngine(models[1], device="cpu", kv_dtype="int8",
                              **ENG),
                JaxEngine(models[0], kv_dtype="int8", **ENG))
    paddle.seed(0)
    ref = JaxLlama(JaxLlamaConfig(**SMALL))
    ref.bfloat16()
    port = LlamaForCausalLM(LlamaConfig(**SMALL), device="cpu",
                            dtype=torch.bfloat16)
    return (ServingEngine(port, device="cpu", **ENG),
            JaxEngine(ref, **ENG))


def _kv_script(side, engine, tokens, payloads):
    loop, host = _loop(side, engine)
    chunks = (chunk_payloads if side == "port" else ref_chunks)(
        payloads, cap=16384)
    n = len(payloads) * ENG["page_size"]
    out = []

    def stream(pull_id, parts, num_chunks=None):
        loop.handle({"type": "kv_prefix", "payload": {
            "pull_id": pull_id, "tokens": tokens[:n],
            "num_pages": len(payloads),
            "num_chunks": len(parts) if num_chunks is None
            else num_chunks}})
        for ch in parts:
            loop.handle({"type": "kv_page",
                         "payload": dict(ch, pull_id=pull_id)})
        out.append(_norm(host.recv_all()))

    stream(7, chunks)
    loop.handle({"type": "kv_pull",
                 "payload": {"pull_id": 8, "tokens": tokens}})
    out.append(_norm(host.recv_all()))
    stream(9, chunks[:1], num_chunks=len(chunks))       # then aborted
    loop.handle({"type": "kv_abort", "payload": {"pull_id": 9}})
    out.append(sorted(loop._kv_intake))
    stream(10, [chunks[0]] + chunks[:-1])               # a part twice
    loop.handle({"type": "kv_release",
                 "payload": {"tokens": tokens[:n], "drop": True}})
    loop.handle({"type": "stats", "payload": {"reset_prefix_cache": True}})
    out.append(_norm(host.recv_all()))
    return out


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_worker_kv_stream_equals_the_reference(models, kv):
    """Pages the port's own engine exported go in on both sides; both
    adopt them, export the same bytes on a pull, drop an aborted intake,
    refuse a stream with a duplicated part (adopting 0 pages, the
    reassembly error named), and end with empty pools."""
    port, ref = _kv_engines(models, kv)
    donor = ServingEngine(port.model, device="cpu",
                          **dict(ENG, kv_dtype="int8" if kv == "int8"
                                 else None))
    tokens = PROMPTS[0][0] + [1, 2, 3]
    donor.add_request(tokens, max_new_tokens=1)
    donor.run()
    n, payloads = donor.export_prefix(tokens)
    assert n == 16 and len(payloads) == 2
    got = _kv_script("port", port, tokens, payloads)
    want = _kv_script("ref", ref, tokens, payloads)
    assert got == want
    assert got[0] == [("kv_adopted", 1, {"pull_id": 7,
                                         "adopted_pages": 2})]
    pulled = [p["data"] for t, _, p in got[1] if t == "kv_page"]
    assert "".join(pulled) == "".join(
        c["data"] for c in chunk_payloads(payloads))
    assert got[2] == got[3] == []          # aborted: no reply, no intake
    refused = got[4][0][2]
    assert refused["adopted_pages"] == 0 and "duplicate part" in \
        refused["error"]
    stats = got[5][-1][2]
    assert stats["kv_used_pages"] == 0 and stats["allocator_ok"]


# ------------------------------------------------------- across processes
@pytest.fixture(scope="module")
def npz(models, tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet_proc") / "weights.npz"
    np.savez(path, **{k: np.asarray(v._data)
                      for k, v in models[0].state_dict().items()})
    return str(path)


@pytest.fixture
def worker_env(monkeypatch):
    """Worker processes find the factory module and keep to one thread."""
    path = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", str(TESTS) + (os.pathsep + path
                                                   if path else ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _spec(npz, **extra):
    return dict({"model": {"factory": "_torch_fleet_factory:llama_from_npz",
                           "kwargs": {"path": npz, "config": SMALL}},
                 "engine": ENG, "heartbeat_interval_s": 0.03,
                 "device": "cpu"}, **extra)


def _wait_ready(pf, timeout=60.0):
    t0 = time.monotonic()
    while not all(w.ready for w in pf.workers.values()):
        pf.pump()
        if time.monotonic() - t0 > timeout:
            raise AssertionError(
                f"workers not ready: "
                f"{ {n: w.state.value for n, w in pf.workers.items()} }")
        time.sleep(0.01)


def test_process_fleet_lifecycle(npz, reference, worker_env, tmp_path):
    """One worker: streams equal the reference engine's with
    `transport.duplicate` armed in the worker (its inbound adopts
    doubled) and in the supervisor (events doubled) — delivered exactly
    once; ping; a rolling restart mid-stream (drain -> respawn ->
    adopt) with the drained snapshot on disk; the Prometheus text."""
    spec = _spec(npz, faults=[{"point": "transport.duplicate",
                               "times": 3}],
                 snapshot_path=str(tmp_path / "w0_drain.json"))
    pf = ProcessFleet({"w0": spec}, dead_after_s=30.0,
                      stderr_dir=str(tmp_path / "logs"))
    try:
        _wait_ready(pf)
        handles = [pf.submit(p, max_new_tokens=m) for p, m in PROMPTS]
        with faults.injected("transport.duplicate", payload=True,
                             times=10):
            res = pf.run(timeout_s=60)
        assert [res[h.request_id] for h in handles] == \
            reference["streams"]
        assert pf.counters["funnel_duplicates"] >= 1
        assert pf.counters["funnel_conflicts"] == 0
        assert pf.counters["requests_lost"] == 0
        assert pf.fired_counts().get("transport.duplicate", 0) >= 1
        assert pf.workers["w0"].last_snapshot["version"] == 1
        assert pf.ping("w0") and pf.workers["w0"].pongs == 1

        h_live = pf.submit(LONG[0], max_new_tokens=LONG[1])
        t0 = time.monotonic()
        while not h_live.tokens and time.monotonic() - t0 < 30:
            pf.pump()
            time.sleep(0.005)
        assert h_live.tokens, "no first token before the drain"
        pf.rolling_restart("w0")
        assert pf.workers["w0"].generation == 1
        _wait_ready(pf)
        res = pf.run(timeout_s=60)
        assert res[h_live.request_id] == reference["long"]
        assert pf.counters["requests_migrated"] >= 1
        assert pf.counters["worker_drains"] == 1
        assert pf.counters["worker_restarts"] == 1
        assert pf.counters["requests_lost"] == 0
        with open(tmp_path / "w0_drain.json") as f:
            assert json.load(f)["version"] == 1
        text = pf.prometheus_text()
        assert "# TYPE paddle_serving_fleet_requests_migrated counter" \
            in text
        assert 'paddle_serving_worker_up{worker="w0"} 1' in text
        assert 'paddle_serving_worker_generation{worker="w0"} 1' in text
        assert 'decode_tokens{worker="w0"}' in text
    finally:
        pf.shutdown()
    assert pf.workers["w0"].poll() == 0


def test_process_fleet_reject_relands_and_kill9_loses_nothing(
        npz, reference, worker_env, tmp_path):
    """Worker "k" rejects its first adoption (`fleet.decode_reject`): the
    request re-lands on "r". Then "k" takes the rest and, `worker.kill9`
    armed before its 11th engine step, dies under them: the supervisor
    sees the SIGKILL and re-lands them on "r" from "k"'s last heartbeat
    snapshot; every stream equals the reference's, none lost."""
    specs = {"r": _spec(npz),
             "k": _spec(npz, faults=[{"point": "fleet.decode_reject",
                                      "times": 1},
                                     {"point": "worker.kill9",
                                      "after": 10}])}
    pf = ProcessFleet(specs, dead_after_s=30.0,
                      stderr_dir=str(tmp_path / "logs"))
    try:
        _wait_ready(pf)
        pf.workers["r"].reported_load = 100     # route onto "k"
        handles = [pf.submit(p, max_new_tokens=m)
                   for p, m in PROMPTS + [LONG]]
        assert {pf._assign[h.request_id] for h in handles} == {"k"}
        t0 = time.monotonic()
        while pf.workers["k"].state.value != "dead":
            pf.pump()
            assert time.monotonic() - t0 < 60, "k never died"
            time.sleep(0.002)
        # LONG was mid-stream: tokens delivered, not all of them
        assert 0 < len(handles[-1].tokens) < LONG[1]
        res = pf.run(timeout_s=60)
        assert [res[h.request_id] for h in handles] == \
            reference["streams"] + [reference["long"]]
        assert pf.counters["worker_rejects"] == 1
        assert pf.counters["worker_kill9_observed"] == 1
        assert pf.workers["k"].poll() == -9
        assert handles[-1].migrations == 1
        assert pf.counters["requests_migrated"] >= 2
        assert pf.counters["requests_lost"] == 0
        assert pf.counters["funnel_conflicts"] == 0
    finally:
        pf.shutdown()


def test_process_fleet_prefill_to_decode(npz, reference, worker_env,
                                         tmp_path):
    """A prefill worker and a decode worker: every request prefills on
    "p0", its KV pages travel through the supervisor's relay to "d0",
    which decodes it; streams equal the reference's, pages were shipped,
    both pools end empty with their invariants holding."""
    specs = {"p0": _spec(npz, role="prefill"),
             "d0": _spec(npz, role="decode")}
    pf = ProcessFleet(specs, dead_after_s=30.0,
                      stderr_dir=str(tmp_path / "logs"))
    try:
        _wait_ready(pf)
        handles = [pf.submit(p, max_new_tokens=m) for p, m in PROMPTS]
        assert all(pf._assign[h.request_id] == "p0" for h in handles)
        res = pf.run(timeout_s=60)
        assert [res[h.request_id] for h in handles] == \
            reference["streams"]
        c = pf.counters
        assert c["handoffs_started"] == c["handoffs_completed"] == 3
        assert c["kv_pages_shipped"] >= 2 and c["handoffs_colocated"] == 0
        assert c["requests_lost"] == c["funnel_conflicts"] == 0
        assert pf.summary()["worker_roles"] == {"p0": "prefill",
                                                "d0": "decode"}
        for name in pf.workers:
            st = pf.request_stats(name, reset_prefix_cache=True)
            assert st["radix_ok"] and st["allocator_ok"], st
            assert st["kv_used_pages"] == 0, (name, st)
        assert pf.workers["d0"].last_stats["decode_launches"] > 0
    finally:
        pf.shutdown()
    assert [w.poll() for w in pf.workers.values()] == [0, 0]


def test_worker_refuses_the_cpu_without_the_device_key():
    """Without a card and without `"device": "cpu"` the worker raises at
    start (before it connects): entry points default to the card and
    never fall back."""
    spec = {"model": {"kind": "llama", "config": SMALL, "seed": 0},
            "engine": ENG, "endpoint": "127.0.0.1:1", "name": "w"}
    with pytest.raises(RuntimeError, match="none is available"):
        run_worker(spec)
    with pytest.raises(UnsupportedFeature, match="qwen2_moe"):
        run_worker(dict(spec, model={"kind": "qwen2_moe", "config": {}}))
    with pytest.raises(UnsupportedFeature, match="compile_cache"):
        run_worker(dict(spec, device="cpu", compile_cache_dir="/nowhere"))
