"""Replica worker process: one ServingEngine behind the framed mailbox
channel (the port's own copy of `paddle_tpu/serving/fleet/worker.py`).

`python -m paddle_tpu_torch.serving.fleet.worker --spec <spec.json>`
hosts a single engine and speaks the transport protocol with the
supervising `ProcessFleet` (procfleet.py). The worker is the unit of
failure: a segfault, OOM-kill or wedged device loop takes down ONE
worker process, and the supervisor adopts its in-flight requests from
the last shipped incremental snapshot with exactly-once token delivery.

The engine runs on the card unless the spec says `"device": "cpu"`;
without a card and without that key the worker raises at start, as
`resolve_device` does, and never carries on on the CPU.

Protocol (all messages framed/versioned by transport.py; host->worker
then worker->host):

    adopt {recs}        -> adopted {rids} | reject {rids, error}
    abort {rid}         -> (honored at the next engine boundary)
    ping {}             -> pong {}
    stats {reset_prefix_cache?} -> stats {kv_used_pages, *_ok, ...,
                                          kernel_launches,
                                          decode_launches}
    drain {} / SIGTERM  -> snapshot {final=true}, bye {}; exit 0
    shutdown {}         -> bye {}; exit 0 (no snapshot: discard work)
    kv_pull {pull_id, tokens}      -> kv_prefix {pull_id, tokens,
                                       num_pages, num_chunks} then one
                                       kv_page {pull_id, idx, part,
                                       parts, data} per chunk (cached-
                                       prefix payloads chunked under
                                       FRAME_CAP)
    kv_prefix/kv_page (incoming)   -> kv_adopted {pull_id,
                                       adopted_pages[, error]} once the
                                       stream completes (the types the
                                       donor emits: the supervisor
                                       relays frames verbatim)
    kv_abort {pull_id}             -> (drop the intake buffer: the
                                       supervisor gave up on this pull;
                                       host-side buffers only)
    kv_release {tokens, drop?}     -> (post-handoff hygiene on the
                                       DONOR: make cold — or with drop,
                                       free — the shipped radix prefix;
                                       no reply)

    ready {pid, geometry}        once, after the engine is built
    events {ev: [[rid,idx,tok]]} after every engine step that emitted
    finish {rid, reason, output_ids}
    prefill_done {rid, output_ids, prefix_len}
                                 a prefill-role engine finished a
                                 request with reason "handoff": first
                                 token(s) + the donated radix prefix
                                 length ride up for the supervisor to
                                 drive the kv_pull
    heartbeat {t, steps, load, counters, fired, snapshot}
    failed {snapshot}            EngineFailure (exit 3) or any other
                                 error of the loop (exit 4)

Intake is `adopt_requests` (not `add_request`): the SUPERVISOR owns
request ids, so a fresh submit is the adoption of a record with no
output yet. Token events carry the request-stream INDEX, so the
supervisor's exactly-once funnel can discard duplicated deliveries and
re-order around dropped ones; after a crash-adoption the successor
re-emits the overlap deterministically (greedy + same bucket grid) and
the funnel drops it by index.

Heartbeats ride an incremental snapshot (every non-finished request's
prompt + tokens so far): that snapshot is what survives a kill -9.

Differences from the reference: the port has no persistent compile
cache, so a spec with `compile_cache_dir` reaches the engine's
`UnsupportedFeature` and the worker fails at start; `ready.geometry.
compile_cache` is false and the drain saves no cache; the `stats`
reply has no compiled programs to count and carries instead
`kernel_launches` (the launch counters of the port's kernel wrappers
in this process) and the engine's `decode_launches`. A pulled prefix
that cannot be adopted degrades to `adopted_pages=0` only for the
reference's typed causes (a reassembly `TransportError`, a corrupt
payload, a dry pool); any other error fails the worker. Model kind
`qwen2_moe` is refused: the reference builds the model here, but
neither package's engine can serve it (Qwen2-MoE has no paged forward),
and the port refuses it at build time rather than at the first step.

Fault point `worker.kill9` (fired before each engine step; the
reference fires it at every loop iteration, idle ones included, which
makes `after` count wall time): an armed payload SIGKILLs the worker's
own process.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from collections import deque
from typing import Dict, List, Optional

from ...utils import faults
from .transport import (Channel, TransportError, chunk_payloads,
                        connect_store, join_payloads)

# The B2 protocol rule cross-checks every message type sent here
# against the supervisor's dispatch (and vice versa):
# tpu-lint-hint: protocol-peer=procfleet.py

__all__ = ["run_worker", "WorkerLoop", "build_model", "build_engine",
           "build_lora_registry", "FAULT_KILL9",
           "FAULT_HANDOFF_PARTIAL", "FAULT_DECODE_REJECT"]

# Fires before every engine step of the worker loop (an engine
# boundary, so the last shipped heartbeat snapshot is consistent): any
# payload -> os.kill(getpid(), SIGKILL). The supervisor proves the
# firing by the -SIGKILL returncode. Idle iterations do not count, so
# `after=k` dies before the (k+1)-th step whenever the work arrives.
FAULT_KILL9 = faults.register_point("worker.kill9")

# Hand-off chaos. `fleet.handoff_partial` fires on the DONOR after each
# kv_page frame sent: any payload -> SIGKILL mid-stream, so armed with
# after=k the prefill worker dies with exactly k of n page frames
# shipped. `fleet.decode_reject` fires at the top of the adopt handler:
# any payload -> refuse the whole batch with a typed reject, which the
# supervisor answers by excluding this worker for those rids.
FAULT_HANDOFF_PARTIAL = faults.register_point("fleet.handoff_partial")
FAULT_DECODE_REJECT = faults.register_point("fleet.decode_reject")


def build_model(model_spec: dict, device=None):
    """Model from a JSON-safe spec: {"kind": "llama", "config": {...},
    "seed": 0} on `device` (the card unless told otherwise), its weights
    drawn from `torch.Generator(device).manual_seed(seed)`; or
    {"factory": "pkg.mod:fn", "kwargs": {...}} for anything else (the
    factory places its model itself). Every worker building from the
    SAME spec on the same kind of device gets bit-identical weights,
    which is what makes cross-process migration greedy-bit-identical."""
    if "factory" in model_spec:
        import importlib
        mod, _, fn = model_spec["factory"].partition(":")
        factory = getattr(importlib.import_module(mod), fn)
        return factory(**model_spec.get("kwargs", {}))
    kind = model_spec.get("kind", "llama")
    if kind == "llama":
        import torch
        from ...device import resolve_device
        from ...models.llama import LlamaConfig, LlamaForCausalLM
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(
            int(model_spec.get("seed", 0)))
        return LlamaForCausalLM(LlamaConfig(**model_spec["config"]),
                                device=dev, generator=gen)
    if kind == "qwen2_moe":
        from ..errors import UnsupportedFeature
        raise UnsupportedFeature(  # tpu-lint: refusal-ok
            "model kind 'qwen2_moe' cannot be served: Qwen2MoeForCausalLM "
            "has no paged forward (forward_paged_*) for the engine to run",
            features=["qwen2_moe"])
    raise ValueError(f"unknown model kind {kind!r}")


def _arm_faults(specs: List[dict]):
    """Arm fault points inside THIS worker process from JSON specs
    ({"point", "payload"/"exc_transient", "times", "after", "prob",
    "seed"}): the registry is per-process, so chaos that must land in a
    worker (kill9, a wedged transport) is armed here."""
    for fs in specs or []:
        kw = {k: fs[k] for k in ("times", "after", "prob", "seed")
              if k in fs}
        if fs.get("exc_transient"):
            from ..errors import TransientDeviceError
            kw["exc"] = TransientDeviceError(str(fs["exc_transient"]))
        else:
            kw["payload"] = fs.get("payload", True)
        faults.inject(fs["point"], **kw)


def _kernel_launches() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers in this process
    (a wrapper counts only its CUDA launches)."""
    from ...kernels.flash_attention import flash_fwd
    from ...kernels.lora_matmul import lora_apply
    from ...kernels.paged_attention import paged_attention_decode as pa
    from ...kernels.quant_matmul import quant_matmul as qm
    return {"paged_attention_decode": pa.launches,
            "paged_attention_decode_int8": pa.int8_launches,
            "flash_attention_fwd": flash_fwd.launches,
            "lora_apply": lora_apply.launches,
            "quant_matmul": qm.launches,
            "quant_matmul_prefill": qm.prefill_launches,
            "quant_matmul_decode": qm.decode_launches}


class WorkerLoop:
    """The worker's engine-driving loop, factored for in-process tests
    (`run_worker` wires a real store/process around it). One iteration:
    fire kill9, drain channel messages, step the engine when it has
    work, ship emissions/finishes, heartbeat on the (injectable)
    clock."""

    def __init__(self, engine, channel: Channel, *,
                 heartbeat_interval_s: float = 0.05, clock=None,
                 snapshot_path: Optional[str] = None):
        self.engine = engine
        self.chan = channel
        self.hb_interval = float(heartbeat_interval_s)
        self.clock = clock if clock is not None else time.monotonic
        self.snapshot_path = snapshot_path
        self.live: set = set()               # rids being generated
        self.sent_counts: Dict[int, int] = {}   # rid -> next event index
        # last finished requests, re-shipped with every heartbeat: a
        # finish frame lost on the wire would otherwise strand its
        # handle live forever on the supervisor (re-delivery is
        # idempotent there)
        self.recent_finished: deque = deque(maxlen=64)
        # hand-off completions ride a SEPARATE deque: a lost
        # prefill_done is healed by heartbeat re-delivery like a
        # finish, but the supervisor keeps a hand-off's handle live
        # until the decode side finishes it (it dedups by rid)
        self.recent_handoffs: deque = deque(maxlen=64)
        # in-flight prefix pulls, RECEIVER side: pull_id -> {tokens,
        # num_chunks, chunks} until the stream completes and adopts
        self._kv_intake: Dict = {}
        self.steps = 0
        self.heartbeats = 0
        self.draining = False
        self.shutdown = False
        self._last_beat = -1e9

    # ---- message handling ------------------------------------------------
    def handle(self, msg: dict):
        mtype = msg.get("type")
        payload = msg.get("payload", {})
        if mtype == "adopt":
            if faults.fire(FAULT_DECODE_REJECT) is not None:
                rids = [int(rec["request_id"])
                        for rec in payload.get("recs", [])]
                if rids:
                    self.chan.send("reject", rids=rids,
                                   error="decode_reject fault armed")
                return
            # one rec at a time: a batch adopt that failed mid-way would
            # leave the restored records running here while the
            # supervisor re-lands them elsewhere. Adoption is host
            # bookkeeping (no launch): a record this engine cannot hold
            # (geometry, adapter, a failed engine) is rejected, typed.
            adopted, failed, last_err = [], [], ""
            for rec in payload.get("recs", []):
                rid = int(rec["request_id"])
                if rid in self.live:
                    # a duplicated adopt frame: the request already runs
                    # here, and a second copy would emit every index
                    # twice
                    adopted.append(rid)
                    continue
                try:
                    self.engine.adopt_requests([rec])
                except Exception as e:                    # noqa: BLE001
                    failed.append(rid)
                    last_err = f"{type(e).__name__}: {e}"[:300]
                    continue
                self.live.add(rid)
                # the supervisor already holds rec's tokens: events
                # index from there, so re-emitted overlap after a
                # crash-adoption dedups by index at the funnel
                self.sent_counts[rid] = len(rec.get("output_ids", []))
                adopted.append(rid)
            if adopted:
                self.chan.send("adopted", rids=adopted)
            if failed:
                self.chan.send("reject", rids=failed, error=last_err)
        elif mtype == "abort":
            self.engine.abort(int(payload["rid"]))
        elif mtype == "ping":
            self.chan.send("pong")
        elif mtype == "stats":
            # reclamation probe: optionally drop the prefix cache, then
            # report pool state + invariant results
            eng = self.engine
            out = {}
            if eng.radix is not None:
                try:
                    eng.radix.check_invariants()
                    out["radix_ok"] = True
                except Exception as e:                    # noqa: BLE001
                    out["radix_ok"] = False
                    out["radix_err"] = str(e)[:200]
            if payload.get("reset_prefix_cache"):
                eng.reset_prefix_cache()
            try:
                eng.allocator.check_invariants()
                out["allocator_ok"] = True
            except Exception as e:                        # noqa: BLE001
                out["allocator_ok"] = False
                out["allocator_err"] = str(e)[:200]
            out["kv_used_pages"] = int(eng.allocator.num_used)
            out["queue_depth"] = int(eng.scheduler.queue_depth)
            out["kernel_launches"] = _kernel_launches()
            out["decode_launches"] = int(
                eng.metrics.counters["decode_launches"])
            self.chan.send("stats", **out)
        elif mtype == "kv_pull":
            # cross-worker prefix pull, DONOR side: the longest device-
            # resident cached prefix of `tokens` as the spill codec's
            # CRC'd page payloads, chunked under the frame cap, in the
            # SAME message types the receiver adopts from
            tokens = [int(t) for t in payload.get("tokens", [])]
            pull_id = payload.get("pull_id", 0)
            n, payloads = self.engine.export_prefix(tokens)
            chunks = chunk_payloads(payloads)
            self.chan.send("kv_prefix", pull_id=pull_id,
                           tokens=tokens[:n], num_pages=len(payloads),
                           num_chunks=len(chunks))
            for ch in chunks:
                self.chan.send("kv_page", pull_id=pull_id, **ch)
                if faults.fire(FAULT_HANDOFF_PARTIAL) is not None:
                    # die -9 with only part of the stream shipped
                    os.kill(os.getpid(), signal.SIGKILL)
        elif mtype == "kv_abort":
            # the supervisor gave up on this pull: drop the intake
            # buffer (host-side only — no page is claimed before the
            # stream completes, so nothing can leak)
            self._kv_intake.pop(payload.get("pull_id", 0), None)
        elif mtype == "kv_release":
            # DONOR-side release after the decode worker confirmed
            # adoption: make cold (default) or drop the shipped prefix
            self.engine.release_prefix(
                [int(t) for t in payload.get("tokens", [])],
                drop=bool(payload.get("drop", False)))
        elif mtype == "kv_prefix":
            # RECEIVER side: open the intake buffer (an empty pull — the
            # donor held nothing — completes at once)
            pull_id = payload.get("pull_id", 0)
            self._kv_intake[pull_id] = {
                "tokens": [int(t) for t in payload.get("tokens", [])],
                "num_chunks": int(payload.get("num_chunks", 0)),
                "chunks": []}
            self._maybe_adopt_pull(pull_id)
        elif mtype == "kv_page":
            buf = self._kv_intake.get(payload.get("pull_id", 0))
            if buf is not None:
                buf["chunks"].append(
                    {k: payload[k]
                     for k in ("idx", "part", "parts", "data")})
                self._maybe_adopt_pull(payload.get("pull_id", 0))
        elif mtype == "drain":
            self.draining = True
        elif mtype == "shutdown":
            self.shutdown = True

    def _maybe_adopt_pull(self, pull_id):
        """Adopt a completed pull stream into the local engine. A
        reassembly gap reports adopted_pages=0 with the error, as do a
        corrupt payload and a dry pool (which `adopt_prefix` itself
        turns into 0): the prefix then recomputes locally. Any other
        error (the card's) propagates and fails the worker."""
        from ..kv_cache import BlocksExhausted, HostPageCorrupt
        buf = self._kv_intake.get(pull_id)
        if buf is None or len(buf["chunks"]) < buf["num_chunks"]:
            return
        del self._kv_intake[pull_id]
        err = None
        adopted = 0
        try:
            payloads = join_payloads(buf["chunks"])
            adopted = self.engine.adopt_prefix(buf["tokens"], payloads)
        except (TransportError, HostPageCorrupt, BlocksExhausted) as e:
            err = f"{type(e).__name__}: {e}"[:200]
        out = {"pull_id": pull_id, "adopted_pages": int(adopted)}
        if err:
            out["error"] = err
        self.chan.send("kv_adopted", **out)

    # ---- emission shipping -----------------------------------------------
    def _ship(self, emitted):
        from ..scheduler import RequestState
        if emitted:
            ev = []
            for rid, tok in emitted:
                idx = self.sent_counts.get(rid, 0)
                self.sent_counts[rid] = idx + 1
                ev.append([int(rid), int(idx), int(tok)])
            self.chan.send("events", ev=ev)
        for rid in sorted(self.live):
            req = self.engine.requests.get(rid)
            if req is None or req.state is RequestState.FINISHED:
                self.live.discard(rid)
                self.sent_counts.pop(rid, None)
                if req is not None and req.finish_reason == "handoff":
                    # prefill-role completion: NOT finished fleet-wide;
                    # the supervisor drives the kv_pull and decode-side
                    # adoption
                    ho = {"rid": int(rid),
                          "output_ids": [int(t)
                                         for t in req.output_ids],
                          "prefix_len": int(req.handoff_prefix_len)}
                    self.recent_handoffs.append(ho)
                    self.chan.send("prefill_done", **ho)
                    continue
                fin = {"rid": int(rid),
                       "reason": (req.finish_reason if req is not None
                                  else "lost"),
                       "output_ids": ([int(t) for t in req.output_ids]
                                      if req is not None else [])}
                self.recent_finished.append(fin)
                self.chan.send("finish", **fin)

    def heartbeat(self, force: bool = False):
        now = self.clock()
        if not force and now - self._last_beat < self.hb_interval:
            return False
        self._last_beat = now
        self.heartbeats += 1
        s = self.engine.scheduler
        self.chan.send(
            "heartbeat", t=float(now), steps=self.steps,
            load=int(s.num_in_flight + s.queue_depth),
            counters=self.engine.metrics.snapshot(),
            fired=faults.fired_counts(),
            # no flight recorder on the heartbeat path: the supervisor
            # reads only the request records
            snapshot=self.engine.snapshot(reason="heartbeat",
                                          include_recorder=False),
            recent_finished=list(self.recent_finished),
            recent_handoffs=list(self.recent_handoffs))
        return True

    # ---- lifecycle -------------------------------------------------------
    def drain_to_snapshot(self) -> dict:
        """Graceful exit: snapshot everything non-finished, write it to
        disk (the SIGTERM contract), ship the final snapshot + bye (no
        compile cache to persist: `cache_saved` is 0)."""
        snap = self.engine.snapshot(reason="drain")
        if self.snapshot_path:
            try:
                os.makedirs(os.path.dirname(self.snapshot_path)
                            or ".", exist_ok=True)
                with open(self.snapshot_path, "w") as f:
                    json.dump(snap, f)
            except OSError:
                pass        # disk trouble must not block the hand-off
        self.chan.send("snapshot", final=True, snapshot=snap)
        self.chan.send("bye", fired=faults.fired_counts(), cache_saved=0)
        return snap

    def step_once(self) -> bool:
        """One loop iteration; returns True while the loop should
        continue."""
        for msg in self.chan.recv_all():
            self.handle(msg)
        if self.shutdown:
            self.chan.send("bye", fired=faults.fired_counts())
            return False
        if self.draining:
            self.drain_to_snapshot()
            return False
        if self.engine.has_work():
            if faults.fire(FAULT_KILL9) is not None:
                os.kill(os.getpid(), signal.SIGKILL)
            emitted = self.engine.step()
            self.steps += 1
            self._ship(emitted)
        else:
            time.sleep(2e-3)
        self.heartbeat()
        return True


def build_lora_registry(model, lora_spec: dict, device=None):
    """AdapterRegistry from a JSON-safe spec: {"rank_buckets": [8],
    "slots": 8, "adapters": [{"name", "rank", "seed", "quant"}]} loads
    seed-deterministic adapters (every worker building from the SAME
    spec holds bit-identical adapter weights), or {"factory":
    "pkg.mod:fn", "kwargs": {...}} for real checkpoints. The registry
    lives on `device`, the engine's."""
    if "factory" in lora_spec:
        import importlib
        mod, _, fn = lora_spec["factory"].partition(":")
        return getattr(importlib.import_module(mod), fn)(
            model, **lora_spec.get("kwargs", {}))
    from ..lora import AdapterRegistry, LoRAAdapter
    from ..lora.store import llama_lora_dims
    dims = llama_lora_dims(model.cfg)
    reg = AdapterRegistry(
        dims,
        rank_buckets=tuple(lora_spec.get("rank_buckets", (8,))),
        slots=int(lora_spec.get("slots", 8)), device=device)
    for ad in lora_spec.get("adapters", ()):
        reg.load(LoRAAdapter.random(ad["name"],
                                    int(ad.get("rank", 8)), dims,
                                    seed=int(ad.get("seed", 0))),
                 quant=ad.get("quant"))
    return reg


def build_engine(spec: dict):
    """(model, engine) from a worker spec — factored from `run_worker`
    so the spec plumbing (the `lora` block included) is testable
    in-process. The engine runs on `spec["device"]`, the card when the
    key is absent."""
    from ..engine import ServingEngine
    device = spec.get("device")
    model = build_model(spec["model"], device)
    engine_kw = dict(spec.get("engine", {}))
    if spec.get("compile_cache_dir"):
        # not ported: the engine refuses it (UnsupportedFeature)
        engine_kw["compile_cache"] = spec["compile_cache_dir"]
    if spec.get("lora"):
        engine_kw["lora"] = build_lora_registry(model, spec["lora"],
                                                device)
    return model, ServingEngine(model, device=device, **engine_kw)


def run_worker(spec: dict) -> int:
    """Worker process entry: build engine + channel from `spec`, then
    loop until drained/shut down. Returns the exit code."""
    from ..errors import EngineFailure

    model, engine = build_engine(spec)

    store = connect_store(spec["endpoint"],
                          timeout_ms=int(spec.get("connect_timeout_ms",
                                                  60000)))
    chan = Channel(store, me=spec["name"], peer="host",
                   session=spec.get("session", "s0"))
    _arm_faults(spec.get("faults"))
    loop = WorkerLoop(
        engine, chan,
        heartbeat_interval_s=float(spec.get("heartbeat_interval_s",
                                            0.05)),
        snapshot_path=spec.get("snapshot_path"))

    # SIGTERM = deliberate eviction (rolling restart / scale-down):
    # flip to draining so the NEXT boundary snapshots and exits — the
    # handler itself must not touch the engine mid-step
    signal.signal(signal.SIGTERM, lambda *_: setattr(loop, "draining",
                                                     True))

    chan.send("ready", pid=os.getpid(),
              geometry={"max_seq_len": engine.max_seq_len,
                        "num_pages": engine.num_pages,
                        "compile_cache": False,
                        "device": str(engine.device)})
    loop.heartbeat(force=True)
    try:
        while loop.step_once():
            pass
    except EngineFailure as exc:
        chan.send("failed",
                  snapshot=(exc.snapshot
                            if exc.snapshot is not None
                            else engine.last_snapshot))
        return 3
    except Exception as exc:                              # noqa: BLE001
        # anything else is a worker or device fault: ship what we know
        # and die loud (the traceback goes to stderr)
        import traceback
        traceback.print_exc()
        try:
            chan.send("failed",
                      snapshot=engine.snapshot(
                          reason=f"worker crash: {exc!r}"[:200]))
        except Exception:                                 # noqa: BLE001
            pass
        return 4
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch serving fleet worker process")
    ap.add_argument("--spec", required=True,
                    help="path to the worker spec JSON")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    return run_worker(spec)


if __name__ == "__main__":
    sys.exit(main())
