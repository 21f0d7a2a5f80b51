"""Host-side supervisor for process-isolated fleet workers (the port's
own copy of `paddle_tpu/serving/fleet/procfleet.py`).

`ProcessFleet` is the cross-process sibling of `Fleet`: N replica
WORKER PROCESSES (worker.py) each hosting one ServingEngine, driven
over the framed TCPStore mailbox (transport.py). The failure domain
shrinks from "the process" to "one worker": a kill -9, OOM-kill or
wedged device loop loses one engine, and the supervisor re-lands its
in-flight requests on survivors with the same zero-loss, exactly-once
contract the in-process fleet has.

How exactly-once survives a real wire:

* the supervisor OWNS request ids and full request records; a submit
  is the adoption of a fresh record on the routed worker;
* token events carry per-request stream indices; the **funnel** only
  delivers index == len(tokens): duplicated deliveries (the
  `transport.duplicate` fault) are discarded by index (value-checked —
  a mismatch would mean non-deterministic regeneration and is counted
  as a conflict), out-of-order arrivals buffer until their prefix
  lands;
* every heartbeat ships an incremental snapshot (prompt + tokens so
  far per live request). When a worker dies un-gracefully the
  supervisor merges (last shipped snapshot, tokens the funnel already
  delivered) — catch-up tokens flow through the same funnel — and
  adopts the request on a survivor from the LONGEST VERIFIED prefix.
  The successor re-emits any overlap deterministically (greedy + same
  bucket grid + same seeded weights) and the funnel drops it by
  index. Dropped event messages (`transport.drop`) heal the same way:
  the next snapshot carries the tokens the events lost.

Suspicion ladder (host wall clock, injectable): a missed heartbeat
past `suspect_after_s` marks the worker SUSPECT (visible as
`heartbeat_gap_seconds` in the Prometheus text); past `dead_after_s`
(or on process exit) the supervisor SIGKILLs what's left and adopts
from the last snapshot. A deliberate `drain()` asks the worker to
snapshot-and-exit gracefully, and `rolling_restart()` chains drain ->
respawn -> adopt. The port has no persistent compile cache, so a
successor builds its model and kernels' state anew (the kernels'
libraries are built once per checkout and only loaded).

Workers inherit the supervisor's environment (CUDA_VISIBLE_DEVICES
included): on the card every worker opens its own CUDA context on the
visible device, and a spec with `"device": "cpu"` keeps its engine on
the CPU.

**Disaggregated prefill/decode.** A worker spec may carry `role`:
"prefill" / "decode" / "both" (default). Role-aware routing
(`router.role_candidates`) sends fresh submits to prefill-capable
workers and re-lands already-prefilled records on decode-capable ones,
FALLING BACK to whoever is healthy when a role is starved. A
prefill-role engine finishes each request with reason "handoff" after
its last prefill chunk + first token; the worker ships `prefill_done
{rid, output_ids, prefix_len}` and the supervisor drives the KV
hand-off as a per-request state machine keyed by pull_id:

    PULLING    kv_pull sent to the donor (prefill worker)
    STREAMING  donor's kv_prefix seen; kv_page frames relayed verbatim
               to the chosen decode worker as they arrive
    ADOPT_WAIT every frame relayed; waiting on the target's kv_adopted
    BACKOFF    a phase deadline passed; capped exponential backoff,
               then re-issue under a fresh pull_id

Every phase has a deadline (`handoff_timeout_s`, reset on progress)
and every failure degrades instead of shedding: donor death parks the
request through the normal evacuation path (it stays ASSIGNED to the
donor until placement, so the existing machinery covers it); target
death re-routes to a survivor; attempts exhausted -> the target adopts
the record WITHOUT pages and re-prefills from its own radix/weights
(bit-identical — the same determinism contract migration relies on);
no decode-capable worker at all -> the record re-lands co-located on
the donor with `colocate=True` (its radix still holds the prefix, so
the re-prefill is a cache hit). After a confirmed adoption the donor
gets `kv_release` so the shipped prefix becomes its coldest eviction
victim. Fault point `fleet.handoff_stall` (registered here, fired at
the kv_page relay) discards a relayed frame so the stream wedges and
the phase timeout must recover.

The supervisor's TCPStore is this object's own: `shutdown()` purges
every channel and releases it.
"""
from __future__ import annotations

import enum
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ...utils import faults
from .router import role_candidates
from .transport import Channel, TransportError, bind_store

# The B2 protocol rule cross-checks every message type sent here
# against the worker's dispatch (and vice versa):
# tpu-lint-hint: protocol-peer=worker.py

__all__ = ["ProcessFleet", "WorkerProc", "WorkerState",
           "FAULT_HANDOFF_STALL"]

# Fired at the supervisor's kv_page relay site: any payload -> the
# frame is NOT relayed, so the decode worker's intake never completes
# and the handoff wedges mid-stream — the phase timeout must notice,
# abort the intake, and recover (backoff re-pull or pageless adopt).
FAULT_HANDOFF_STALL = faults.register_point("fleet.handoff_stall")


class WorkerState(enum.Enum):
    SPAWNING = "spawning"    # process launched, ready not yet seen
    HEALTHY = "healthy"      # in rotation
    SUSPECT = "suspect"      # heartbeat gap past suspect_after_s
    DRAINING = "draining"    # deliberate drain in flight
    STOPPED = "stopped"      # graceful exit observed (bye)
    DEAD = "dead"            # un-graceful death; evacuated


class WorkerProc:
    """One worker process + its channel + liveness bookkeeping."""

    def __init__(self, name: str, spec: dict, store, *,
                 python: Optional[str] = None, generation: int = 0):
        self.name = name
        self.spec = dict(spec)
        self.generation = int(generation)
        session = f"{spec.get('session_base', 's0')}/{name}/g{generation}"
        self.spec["session"] = session
        self.spec["name"] = name
        # fleet role: "prefill" / "decode" / "both". The
        # spec's top-level role is mirrored into the engine kwargs so
        # a prefill worker's ENGINE also runs in handoff mode.
        self.role = str(spec.get("role")
                        or spec.get("engine", {}).get("role", "both"))
        if self.role != "both":
            eng = dict(self.spec.get("engine", {}))
            eng.setdefault("role", self.role)
            self.spec["engine"] = eng
        self.chan = Channel(store, me="host", peer=name, session=session)
        self.state = WorkerState.SPAWNING
        self.pid: Optional[int] = None
        self.ready = False
        self.last_beat_host_t: Optional[float] = None
        self.last_beat: Optional[dict] = None
        self.last_snapshot: Optional[dict] = None
        self.last_stats: Optional[dict] = None
        self.pongs = 0
        self.fired: Dict[str, int] = {}
        self.reported_load = 0
        self.beats = 0
        self._spec_path = None
        self._proc: Optional[subprocess.Popen] = None
        self._python = python or sys.executable
        self._draining_mailbox = False

    def spawn(self, *, extra_env: Optional[dict] = None,
              stderr_path: Optional[str] = None):
        fd, self._spec_path = tempfile.mkstemp(suffix=".json",
                                               prefix=f"ptw_{self.name}_")
        with os.fdopen(fd, "w") as f:
            json.dump(self.spec, f)
        env = dict(os.environ)          # CUDA_VISIBLE_DEVICES included
        env.update(extra_env or {})
        if stderr_path:
            os.makedirs(os.path.dirname(stderr_path) or ".",
                        exist_ok=True)
        err = open(stderr_path, "ab") if stderr_path else subprocess.DEVNULL
        try:
            self._proc = subprocess.Popen(
                [self._python, "-m", "paddle_tpu_torch.serving.fleet.worker",
                 "--spec", self._spec_path],
                env=env, stdout=err, stderr=err,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))))))
        finally:
            if err is not subprocess.DEVNULL:
                err.close()
        self.pid = self._proc.pid
        return self

    # ---- liveness --------------------------------------------------------
    def poll(self) -> Optional[int]:
        return self._proc.poll() if self._proc is not None else None

    def kill(self, sig=None):
        if self._proc is not None and self._proc.poll() is None:
            import signal as _signal
            self._proc.send_signal(
                sig if sig is not None else _signal.SIGKILL)

    def terminate(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self._proc is None:
            return None
        try:
            return self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def cleanup(self):
        if self._spec_path:
            try:
                os.remove(self._spec_path)
            except OSError:
                pass
            self._spec_path = None


class ProcessFleet:
    """Submit/pump facade over N worker processes.

    `worker_specs` is {name: spec}; each spec carries the model/engine
    config worker.py builds from (plus optional device, role,
    heartbeat_interval_s, faults, snapshot_path, lora). The store
    endpoint is bound here (the supervisor is the mailbox store's
    master).

    The supervisor is SYNCHRONOUS like Fleet: `pump()` is one
    iteration (drain every worker's mailbox, run the suspicion
    ladder, re-land parked work); `run()` loops pump until every
    tracked handle finishes. `clock` injects the suspicion clock for
    tests; worker heartbeats ride their own process clocks and are
    judged only by host-side RECEIPT gaps, so clock skew between
    processes cannot false-positive the ladder.
    """

    def __init__(self, worker_specs: Dict[str, dict], *,
                 endpoint: Optional[str] = None,
                 suspect_after_s: float = 1.0,
                 dead_after_s: float = 8.0,
                 lost_after_s: float = 30.0,
                 max_inflight_per_worker: Optional[int] = None,
                 handoff_timeout_s: float = 5.0,
                 handoff_max_attempts: int = 2,
                 handoff_backoff_s: float = 0.25,
                 clock=None, python: Optional[str] = None,
                 stderr_dir: Optional[str] = None):
        # port 0 binds a free port, read back from the store
        self.store = bind_store(endpoint or "127.0.0.1:0")
        self.endpoint = (f"{self.store.host}:{self.store.port}"
                         if endpoint is None else endpoint)
        self.session_base = uuid.uuid4().hex[:8]
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self.lost_after_s = float(lost_after_s)
        self.max_inflight_per_worker = max_inflight_per_worker
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.handoff_max_attempts = int(handoff_max_attempts)
        self.handoff_backoff_s = float(handoff_backoff_s)
        self._clock = clock if clock is not None else time.monotonic
        self._python = python
        self.stderr_dir = stderr_dir
        self.workers: Dict[str, WorkerProc] = {}
        self._base_specs: Dict[str, dict] = {}
        for name, spec in worker_specs.items():
            spec = dict(spec)
            spec["endpoint"] = self.endpoint
            spec["session_base"] = self.session_base
            self._base_specs[name] = spec
            self.workers[name] = self._spawn(name, spec, generation=0)

        self._rid_counter = 0
        self.handles: Dict[int, object] = {}       # rid -> FleetHandle
        self._records: Dict[int, dict] = {}        # rid -> full record
        self._assign: Dict[int, str] = {}          # rid -> worker name
        self._deadline_at: Dict[int, float] = {}   # rid -> host deadline
        self._pending: Dict[int, Dict[int, int]] = {}   # out-of-order
        self._parked: List[Tuple[float, dict]] = []
        # workers that REJECTED a request (deterministic geometry
        # refusal): never re-land it there — with every healthy worker
        # excluded the request is finalized "lost", not looped forever
        self._excluded: Dict[int, set] = {}
        # ---- KV handoff state machine ----
        # pull_id -> {rid, donor, target, phase, deadline, attempts,
        #             tokens, num_chunks, relayed, rec}; the request
        # stays ASSIGNED to the donor until placement so the normal
        # evacuation machinery parks it if the donor dies mid-stream
        self._handoffs: Dict[str, dict] = {}
        self._handoff_by_rid: Dict[int, str] = {}
        # rid -> worker names whose prefill_done was already acted on:
        # the donor re-ships it with heartbeats (healing a dropped
        # frame) and keeps doing so after a colocate fallback placed
        # the request back on it — without this, every heartbeat would
        # restart the handoff of a request that is already decoding
        self._handoff_done_seen: Dict[int, set] = {}
        self._pull_counter = 0
        self.counters: Dict[str, int] = {
            "requests_submitted": 0,
            "requests_finished": 0,
            "requests_migrated": 0,
            "requests_lost": 0,
            "catchup_tokens": 0,
            "tokens_delivered": 0,
            "funnel_duplicates": 0,
            "funnel_conflicts": 0,
            "events_buffered": 0,
            "worker_deaths": 0,
            "worker_kill9_observed": 0,
            "worker_hard_stalls": 0,
            "worker_drains": 0,
            "worker_restarts": 0,
            "worker_rejects": 0,
            "heartbeats": 0,
            "transport_errors": 0,
            # disaggregated prefill/decode
            "handoffs_started": 0,      # prefill_done acted on
            "handoffs_completed": 0,    # target adopted shipped pages
            "handoffs_refetched": 0,    # placed WITHOUT pages: target
                                        # (or donor) re-prefilled
            "handoffs_colocated": 0,    # role-starved fallback to the
                                        # donor (colocate=True)
            "handoff_stalls": 0,        # phase deadlines that fired
            "kv_pages_shipped": 0,      # pages the targets adopted
        }

    # ---- plumbing --------------------------------------------------------
    def _spawn(self, name: str, spec: dict, *, generation: int):
        wp = WorkerProc(name, spec, self.store, python=self._python,
                        generation=generation)
        err = (os.path.join(self.stderr_dir, f"{name}_g{generation}.log")
               if self.stderr_dir else None)
        wp.spawn(stderr_path=err)
        return wp

    def _handle_cls(self):
        from .fleet import FleetHandle
        return FleetHandle

    def worker(self, name: str) -> WorkerProc:
        return self.workers[name]

    def _healthy(self) -> List[WorkerProc]:
        return [w for w in self.workers.values()
                if w.state in (WorkerState.SPAWNING, WorkerState.HEALTHY,
                               WorkerState.SUSPECT) and w.ready]

    def _assigned_to(self, name: str) -> List[int]:
        return [rid for rid, w in self._assign.items() if w == name]

    def has_work(self) -> bool:
        return bool(self._parked) or any(
            not h.finished for h in self.handles.values())

    # ---- admission -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               eos_token_id: Optional[int] = None,
               ttl_s: Optional[float] = None,
               adapter: Optional[str] = None):
        """Route one request to the least-loaded ready worker; returns
        its FleetHandle. The full record is retained host-side — it is
        the migration payload of last resort when a worker dies before
        ever shipping a snapshot.

        `adapter` rides the request record: the worker's
        engine adopts it only with the adapter loaded (typed reject ->
        the existing park/exclude/re-land machinery finds a holder).
        Placement prefers workers whose SPEC declares the adapter in
        its `lora` block (factory-built registries are invisible
        host-side, so spec-less candidates stay eligible and the
        reject path remains the arbiter)."""
        from .errors import NoHealthyReplica
        from ..errors import EngineOverloaded
        candidates = self._healthy()
        if not candidates:
            raise NoHealthyReplica("no ready worker to accept work")
        # fresh work starts in its prefill phase: prefer prefill-
        # capable workers, falling back to anyone healthy
        candidates = role_candidates(candidates, "prefill")
        if adapter is not None:
            declared = [w for w in candidates
                        if any(ad.get("name") == adapter
                               for ad in (self._base_specs.get(
                                   w.name, {}).get("lora", {})
                                   .get("adapters", ())))]
            if declared:
                candidates = declared

        def load_of(w):
            return w.reported_load + len(self._assigned_to(w.name))

        if self.max_inflight_per_worker is not None:
            candidates = [w for w in candidates
                          if load_of(w) < self.max_inflight_per_worker]
            if not candidates:
                raise EngineOverloaded(
                    "every worker is at max_inflight_per_worker",
                    max_queue_len=self.max_inflight_per_worker)
        target = min(candidates, key=load_of)
        self._rid_counter += 1
        rid = self._rid_counter
        rec = {"request_id": rid,
               "prompt_ids": [int(t) for t in prompt_ids],
               "output_ids": [],
               "max_new_tokens": int(max_new_tokens),
               "eos_token_id": (None if eos_token_id is None
                                else int(eos_token_id)),
               "num_preemptions": 0, "aborted": False,
               "adapter": adapter, "colocate": False,
               "deadline_remaining_s": (None if ttl_s is None
                                        else float(ttl_s))}
        handle = self._handle_cls()(rid, "_default")
        handle.submit_t = self._clock()
        self.handles[rid] = handle
        self._records[rid] = rec
        if ttl_s is not None:
            self._deadline_at[rid] = self._clock() + float(ttl_s)
        self._send_adopt(target, [rec])
        self.counters["requests_submitted"] += 1
        return handle

    def abort(self, request_id: int) -> bool:
        name = self._assign.get(request_id)
        rec = self._records.get(request_id)
        if rec is not None:
            rec["aborted"] = True
        for _, prec in self._parked:
            if prec["request_id"] == request_id:
                prec["aborted"] = True
                return True
        if name is not None and name in self.workers:
            try:
                self.workers[name].chan.send("abort", rid=int(request_id))
                return True
            except TransportError:
                self.counters["transport_errors"] += 1
        return False

    def _park(self, rid: int, base: Optional[dict] = None):
        """Park one request for re-landing, from the freshest truth:
        the record's resume point is the longest funnel-verified token
        prefix, and the remaining deadline is recomputed from the
        request's ORIGINAL host-side deadline — every park path (crash
        evacuation, worker reject, transport failure) must charge time
        already spent against the client's TTL, never re-grant it."""
        handle = self.handles.get(rid)
        if handle is None or handle.finished:
            return
        rec = dict(base if base is not None else self._records[rid])
        rec["output_ids"] = [int(t) for t in handle.tokens]
        rec["aborted"] = bool(self._records[rid].get("aborted"))
        now = self._clock()
        dl = self._deadline_at.get(rid)
        if dl is not None:
            rec["deadline_remaining_s"] = float(dl - now)
        self._parked.append((now, rec))

    def _send_adopt(self, worker: WorkerProc, recs: List[dict]) -> bool:
        """Adopt `recs` on `worker`; a transport failure parks them
        instead (the pump re-lands parked work — never an orphaned
        handle, never an exception through a caller's submit loop)."""
        try:
            worker.chan.send("adopt", recs=recs)
        except TransportError:
            self.counters["transport_errors"] += 1
            for rec in recs:
                self._park(rec["request_id"], rec)
            return False
        for rec in recs:
            self._assign[rec["request_id"]] = worker.name
        return True

    # ---- exactly-once funnel ---------------------------------------------
    def _deliver(self, handle, tok: int):
        handle._deliver(tok)
        now = self._clock()
        if handle.first_token_t is None:
            handle.first_token_t = now
        handle.token_ts.append(now)
        self.counters["tokens_delivered"] += 1

    def _funnel(self, rid: int, idx: int, tok: int):
        """Deliver exactly once, in order: duplicates discard by index
        (value-checked), gaps buffer until the prefix lands (a dropped
        event's tokens arrive via the next snapshot's catch-up)."""
        handle = self.handles.get(rid)
        if handle is None or handle.finished:
            return
        n = len(handle.tokens)
        if idx < n:
            if handle.tokens[idx] != tok:
                self.counters["funnel_conflicts"] += 1
            else:
                self.counters["funnel_duplicates"] += 1
            return
        if idx > n:
            self._pending.setdefault(rid, {})[idx] = tok
            self.counters["events_buffered"] += 1
            return
        self._deliver(handle, tok)
        pend = self._pending.get(rid)
        while pend:
            nxt = pend.pop(len(handle.tokens), None)
            if nxt is None:
                break
            self._deliver(handle, nxt)
        if not pend and rid in self._pending:
            self._pending.pop(rid, None)

    def _catch_up(self, handle, output_ids):
        """Deliver the verified suffix a snapshot knows and the funnel
        has not seen (also the heal for dropped event frames)."""
        for i in range(len(handle.tokens), len(output_ids)):
            self._deliver(handle, int(output_ids[i]))
            self.counters["catchup_tokens"] += 1
        pend = self._pending.pop(handle.request_id, None)
        if pend:
            for idx in sorted(pend):
                self._funnel(handle.request_id, idx, pend[idx])

    def _finalize(self, rid: int, reason: str):
        handle = self.handles.get(rid)
        self._assign.pop(rid, None)
        self._pending.pop(rid, None)
        self._deadline_at.pop(rid, None)
        self._excluded.pop(rid, None)
        self._handoff_done_seen.pop(rid, None)
        pid = self._handoff_by_rid.pop(rid, None)
        if pid is not None:
            self._drop_handoff(self._handoffs.get(pid))
        if handle is None or handle.finished:
            return
        handle.finish_t = self._clock()
        handle._finish(reason)
        self.counters["requests_lost" if reason == "lost"
                      else "requests_finished"] += 1

    # ---- KV handoff state machine -----------------------------
    def _live_worker(self, name: Optional[str]) -> Optional[WorkerProc]:
        w = self.workers.get(name)
        if w is None or w.state in (WorkerState.DEAD,
                                    WorkerState.STOPPED):
            return None
        return w

    def _decode_target(self, rid: int,
                       exclude=()) -> Optional[WorkerProc]:
        """Least-loaded healthy decode-CAPABLE worker for `rid`, or
        None. Strict (no role fallback): the caller owns the degraded
        path (colocate on the donor), which is cheaper than landing
        decode work on a foreign prefill worker with a cold cache."""
        cands = [w for w in self._healthy()
                 if w.role in ("decode", "both")
                 and w.name not in exclude
                 and w.name not in self._excluded.get(rid, ())]
        if not cands:
            return None
        return min(cands, key=lambda w: (w.reported_load
                                         + len(self._assigned_to(w.name)),
                                         w.name))

    def _handoff_rec(self, rid: int) -> dict:
        """A placement-ready record for `rid`: resume point = the
        funnel-verified tokens, deadline recharged for time already
        spent (the `_park` discipline)."""
        handle = self.handles[rid]
        rec = dict(self._records[rid])
        rec["output_ids"] = [int(t) for t in handle.tokens]
        dl = self._deadline_at.get(rid)
        if dl is not None:
            rec["deadline_remaining_s"] = float(dl - self._clock())
        return rec

    def _on_prefill_done(self, worker: WorkerProc, payload: dict):
        """A prefill-role worker finished a request with reason
        "handoff": start (or ignore a re-delivery of) its KV handoff."""
        rid = int(payload.get("rid", -1))
        handle = self.handles.get(rid)
        if handle is None or handle.finished:
            return
        if self._assign.get(rid) != worker.name:
            return      # stale frame from a previous landing
        seen = self._handoff_done_seen.setdefault(rid, set())
        if worker.name in seen:
            return      # heartbeat re-delivery: already acted on
        seen.add(worker.name)
        self._catch_up(handle, payload.get("output_ids", []))
        self.counters["handoffs_started"] += 1
        rec = self._handoff_rec(rid)
        prefix_len = int(payload.get("prefix_len", 0))
        tokens = (rec["prompt_ids"] + rec["output_ids"])[:prefix_len]
        target = self._decode_target(rid, exclude={worker.name})
        if target is None:
            # role-starved: degrade to co-located execution on the
            # donor — its radix still holds the prefix, so the
            # re-prefill is a cache hit, not shed work
            self.counters["handoffs_colocated"] += 1
            rec["colocate"] = True
            self._records[rid]["colocate"] = True
            self._send_adopt(worker, [rec])
            return
        if not tokens or rec.get("adapter"):
            # nothing pullable (zero donated pages, or an adapter'd
            # request whose radix key the raw-token pull cannot
            # match): place pageless, the target re-prefills
            self.counters["handoffs_refetched"] += 1
            self._send_adopt(target, [rec])
            handle.migrations += 1
            return
        self._start_pull(rid, worker.name, target.name, tokens, rec)

    def _start_pull(self, rid: int, donor: str, target: str,
                    tokens, rec: dict, attempts: int = 1) -> dict:
        self._pull_counter += 1
        pull_id = f"ho{self._pull_counter}"
        entry = {"pull_id": pull_id, "rid": rid, "donor": donor,
                 "target": target, "phase": "pulling",
                 "deadline": self._clock() + self.handoff_timeout_s,
                 "retry_at": 0.0, "attempts": int(attempts),
                 "tokens": [int(t) for t in tokens],
                 "num_chunks": None, "relayed": 0, "rec": rec}
        self._handoffs[pull_id] = entry
        self._handoff_by_rid[rid] = pull_id
        try:
            self.workers[donor].chan.send("kv_pull", pull_id=pull_id,
                                          tokens=entry["tokens"])
        except TransportError:
            self.counters["transport_errors"] += 1
            # keep the entry: the phase deadline drives the retry
        return entry

    def _drop_handoff(self, entry: Optional[dict], *,
                      abort_target: bool = True):
        """Forget a handoff; optionally tell the target to drop its
        intake buffer (host-side dicts only — no pages allocate before
        adoption, so nothing can leak either way)."""
        if entry is None:
            return
        self._handoffs.pop(entry["pull_id"], None)
        if self._handoff_by_rid.get(entry["rid"]) == entry["pull_id"]:
            self._handoff_by_rid.pop(entry["rid"], None)
        if abort_target:
            target = self._live_worker(entry["target"])
            if target is not None:
                try:
                    target.chan.send("kv_abort",
                                     pull_id=entry["pull_id"])
                except TransportError:
                    self.counters["transport_errors"] += 1

    def _relay_to_target(self, entry: dict, msg: dict) -> bool:
        target = self._live_worker(entry["target"])
        if target is None:
            return False
        try:
            target.chan.relay(msg)
            return True
        except TransportError:
            self.counters["transport_errors"] += 1
            return False

    def _on_handoff_frame(self, worker: WorkerProc, mtype: str,
                          msg: dict):
        payload = msg.get("payload", {})
        entry = self._handoffs.get(payload.get("pull_id"))
        if entry is None:
            return          # late frame of an aborted/finished pull
        if entry["phase"] == "backoff":
            return          # stream already written off; retry pending
        if mtype in ("kv_prefix", "kv_page"):
            if worker.name != entry["donor"]:
                return
            if mtype == "kv_prefix":
                entry["num_chunks"] = int(payload.get("num_chunks", 0))
                matched = [int(t) for t in payload.get("tokens", [])]
                if matched:
                    entry["tokens"] = matched
                self._relay_to_target(entry, msg)
            else:
                if faults.fire(FAULT_HANDOFF_STALL) is not None:
                    return      # frame eaten: the stream wedges and
                                # the phase deadline must recover
                self._relay_to_target(entry, msg)
                entry["relayed"] += 1
            # progress re-arms the phase deadline
            entry["deadline"] = self._clock() + self.handoff_timeout_s
            if entry["num_chunks"] is not None:
                entry["phase"] = ("adopt_wait"
                                  if entry["relayed"] >= entry["num_chunks"]
                                  else "streaming")
        elif mtype == "kv_adopted":
            if worker.name != entry["target"]:
                return
            adopted = int(payload.get("adopted_pages", 0))
            self.counters["kv_pages_shipped"] += adopted
            if adopted > 0:
                self.counters["handoffs_completed"] += 1
                # phase 4, prefill-side release (fire-and-forget): the
                # shipped prefix becomes the donor's coldest eviction
                # victim instead of squatting on its pool
                donor = self._live_worker(entry["donor"])
                if donor is not None:
                    try:
                        donor.chan.send("kv_release",
                                        tokens=entry["tokens"])
                    except TransportError:
                        self.counters["transport_errors"] += 1
            else:
                # the target adopted nothing (dry pool / reassembly
                # gap / CRC): it re-prefills from its own state
                self.counters["handoffs_refetched"] += 1
            self._place_handoff(entry)

    def _place_handoff(self, entry: dict):
        """Adopt the request on its decode target (pull resolved —
        with pages or without). Post-placement failures are the
        standard machinery's business: the rid is assigned to the
        target from here on."""
        self._drop_handoff(entry, abort_target=False)
        rid = entry["rid"]
        handle = self.handles.get(rid)
        if handle is None or handle.finished:
            return
        rec = self._handoff_rec(rid)
        rec["colocate"] = entry["rec"].get("colocate", False)
        target = self._live_worker(entry["target"])
        if target is None or not target.ready:
            self._assign.pop(rid, None)
            self._park(rid, rec)
            return
        self._send_adopt(target, [rec])
        handle.migrations += 1

    def _check_handoffs(self):
        """Drive every in-flight handoff's deadlines and failure
        transitions (one pump iteration's worth)."""
        now = self._clock()
        for entry in list(self._handoffs.values()):
            rid = entry["rid"]
            handle = self.handles.get(rid)
            if handle is None or handle.finished:
                self._drop_handoff(entry)
                continue
            if self._assign.get(rid) != entry["donor"]:
                # the donor died and evacuation parked the rid under
                # us: the park/re-land machinery owns it now (role-
                # aware; the decode side re-prefills — a refetch)
                self.counters["handoffs_refetched"] += 1
                self._drop_handoff(entry)
                continue
            if self._live_worker(entry["target"]) is None:
                # target died pre-placement: re-route to a survivor
                self._drop_handoff(entry, abort_target=False)
                self._reroute(entry, now)
                continue
            if entry["phase"] == "backoff":
                if now >= entry["retry_at"]:
                    self._drop_handoff(entry, abort_target=False)
                    self._reroute(entry, now)
                continue
            if now < entry["deadline"]:
                continue
            # a phase wedged (stalled stream, lost pull, mute target):
            # abort the target's intake, then capped backoff + re-pull
            # while attempts remain, else give the pages up
            self.counters["handoff_stalls"] += 1
            target = self._live_worker(entry["target"])
            if target is not None:
                try:
                    target.chan.send("kv_abort",
                                     pull_id=entry["pull_id"])
                except TransportError:
                    self.counters["transport_errors"] += 1
            if entry["attempts"] < self.handoff_max_attempts:
                # re-key NOW so straggler frames of the written-off
                # stream can't resurrect the entry; send after backoff
                self._handoffs.pop(entry["pull_id"], None)
                self._pull_counter += 1
                entry["pull_id"] = f"ho{self._pull_counter}"
                self._handoffs[entry["pull_id"]] = entry
                self._handoff_by_rid[rid] = entry["pull_id"]
                entry["phase"] = "backoff"
                entry["retry_at"] = now + self.handoff_backoff_s * (
                    2 ** (entry["attempts"] - 1))
                entry["num_chunks"] = None
                entry["relayed"] = 0
            else:
                self.counters["handoffs_refetched"] += 1
                self._place_handoff(entry)

    def _reroute(self, entry: dict, now: float):
        """Continue a handoff whose stream was written off (backoff
        expiry or target death): fresh pull to a fresh target, pageless
        placement when attempts are spent, colocate when role-starved."""
        rid = entry["rid"]
        handle = self.handles.get(rid)
        if handle is None or handle.finished:
            return
        donor = self._live_worker(entry["donor"])
        target = self._decode_target(rid, exclude={entry["donor"]})
        rec = self._handoff_rec(rid)
        rec["colocate"] = entry["rec"].get("colocate", False)
        if target is None:
            if donor is not None:
                self.counters["handoffs_colocated"] += 1
                rec["colocate"] = True
                self._records[rid]["colocate"] = True
                self._send_adopt(donor, [rec])
            # donor dead too: leave the rid assigned — the donor's
            # evacuation parks it and the normal machinery re-lands
            return
        if donor is None or entry["attempts"] >= self.handoff_max_attempts:
            # no donor to pull from (or attempts spent): pageless
            # placement, the target re-prefills bit-identically
            self.counters["handoffs_refetched"] += 1
            self._send_adopt(target, [rec])
            handle.migrations += 1
            return
        self._start_pull(rid, entry["donor"], target.name,
                         entry["tokens"], rec,
                         attempts=entry["attempts"] + 1)

    # ---- message processing ----------------------------------------------
    def _process(self, worker: WorkerProc, msg: dict):
        mtype = msg.get("type")
        payload = msg.get("payload", {})
        if mtype == "ready":
            worker.ready = True
            if worker.state is WorkerState.SPAWNING:
                worker.state = WorkerState.HEALTHY
            worker.last_beat_host_t = self._clock()
        elif mtype == "heartbeat":
            worker.last_beat_host_t = self._clock()
            worker.last_beat = payload
            worker.reported_load = int(payload.get("load", 0))
            worker.beats += 1
            worker.fired = dict(payload.get("fired", {}))
            # a heartbeat implies ready — heals a dropped ready frame
            worker.ready = True
            if worker.state in (WorkerState.SPAWNING,
                                WorkerState.SUSPECT):
                worker.state = WorkerState.HEALTHY
            snap = payload.get("snapshot")
            if snap is not None:
                worker.last_snapshot = snap
                # the heartbeat snapshot is the authoritative healer
                # for dropped/stalled EVENT frames: catch the funnel up
                # to every verified prefix this worker reports for
                # requests it still owns
                for rec in snap.get("requests", []):
                    rid = int(rec.get("request_id", -1))
                    if self._assign.get(rid) != worker.name:
                        continue
                    handle = self.handles.get(rid)
                    if handle is not None and not handle.finished:
                        self._catch_up(handle,
                                       rec.get("output_ids", []))
            # ... and re-shipped finish records heal dropped FINISH
            # frames (idempotent: finalize checks handle.finished)
            for fin in payload.get("recent_finished", []):
                rid = int(fin.get("rid", -1))
                handle = self.handles.get(rid)
                if handle is not None and not handle.finished:
                    self._catch_up(handle, fin.get("output_ids", []))
                    self._finalize(rid, fin.get("reason", "stop"))
            # ... and re-shipped handoff records heal dropped
            # prefill_done frames (idempotent per donor via
            # _handoff_done_seen)
            for ho in payload.get("recent_handoffs", []):
                self._on_prefill_done(worker, ho)
            self.counters["heartbeats"] += 1
        elif mtype == "events":
            worker.last_beat_host_t = self._clock()
            for rid, idx, tok in payload.get("ev", []):
                self._funnel(int(rid), int(idx), int(tok))
        elif mtype == "finish":
            rid = int(payload["rid"])
            handle = self.handles.get(rid)
            if handle is not None and not handle.finished:
                self._catch_up(handle, payload.get("output_ids", []))
            self._finalize(rid, payload.get("reason", "stop"))
        elif mtype == "prefill_done":
            worker.last_beat_host_t = self._clock()
            self._on_prefill_done(worker, payload)
        elif mtype in ("kv_prefix", "kv_page", "kv_adopted"):
            worker.last_beat_host_t = self._clock()
            self._on_handoff_frame(worker, mtype, msg)
        elif mtype == "adopted":
            worker.last_beat_host_t = self._clock()
        elif mtype == "pong":
            # the ping round-trip's answer: proof the worker LOOP is
            # alive (not just the process), so it counts as liveness
            worker.last_beat_host_t = self._clock()
            worker.pongs += 1
        elif mtype == "stats":
            worker.last_stats = payload
        elif mtype == "reject":
            self.counters["worker_rejects"] += 1
            for rid in payload.get("rids", []):
                rid = int(rid)
                if self._assign.get(rid) != worker.name:
                    # stale or DUPLICATED reject frame: the request was
                    # already re-parked/re-landed — parking it again
                    # would have two workers generating the same rid
                    continue
                self._assign.pop(rid, None)
                self._excluded.setdefault(rid, set()).add(worker.name)
                self._park(rid)
        elif mtype == "snapshot":
            # counts as liveness: the final snapshot is the drain's
            # last act before its bye
            worker.last_beat_host_t = self._clock()
            if payload.get("final"):
                self._evacuate(worker, payload.get("snapshot"))
        elif mtype == "bye":
            worker.fired.update(payload.get("fired", {}))
            if worker.state is not WorkerState.DEAD:
                worker.state = WorkerState.STOPPED
        elif mtype == "failed":
            self._mark_dead(worker, snapshot=payload.get("snapshot"))

    # ---- failure handling ------------------------------------------------
    def _mark_dead(self, worker: WorkerProc, snapshot: Optional[dict]
                   = None):
        if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
            return
        # drain whatever the worker managed to send before dying —
        # events/finishes/a final snapshot are sequenced AHEAD of the
        # death in its mailbox and must not be lost with it (a bye in
        # there resolves this as a graceful stop instead)
        if not worker._draining_mailbox:
            worker._draining_mailbox = True
            try:
                msgs = worker.chan.recv_all()
            except TransportError:
                self.counters["transport_errors"] += 1
                msgs = []
            for msg in msgs:
                self._process(worker, msg)
            worker._draining_mailbox = False
            if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
                return
        worker.state = WorkerState.DEAD
        self.counters["worker_deaths"] += 1
        rc = worker.poll()
        try:
            import signal as _signal
            if rc is not None and -rc == int(_signal.SIGKILL):
                self.counters["worker_kill9_observed"] += 1
        except Exception:                                 # noqa: BLE001
            pass
        worker.kill()
        self._evacuate(worker,
                       snapshot if snapshot is not None
                       else worker.last_snapshot)

    def _evacuate(self, worker: WorkerProc, snapshot: Optional[dict]):
        """Park every request assigned to `worker` for re-landing. The
        migration record merges the last shipped snapshot with what the
        funnel verified: snapshot tokens the stream never saw are
        delivered as catch-up, then the record's resume point is the
        longest delivered prefix (regenerated overlap dedups by
        index)."""
        recs = {}
        if snapshot:
            from ..engine import check_snapshot_version
            from ..errors import SnapshotVersionError
            try:
                check_snapshot_version(snapshot)
                recs = {r["request_id"]: r
                        for r in snapshot.get("requests", [])}
            except (SnapshotVersionError, KeyError, TypeError):
                recs = {}
        for rid in self._assigned_to(worker.name):
            handle = self.handles.get(rid)
            if handle is None or handle.finished:
                self._assign.pop(rid, None)
                continue
            rec = recs.get(rid)
            if rec is not None:
                self._catch_up(handle, rec.get("output_ids", []))
            self._assign.pop(rid, None)
            self._park(rid, rec)

    def _process_parked(self):
        if not self._parked:
            return 0
        healthy = self._healthy()
        if not healthy:
            # no landing spot RIGHT NOW is not loss: a rolling restart
            # leaves a window with every worker stopped before its
            # successor is ready. Only work parked past the grace
            # period with still nobody to adopt it is finalized lost.
            kept = []
            for t0, rec in self._parked:
                if self._clock() - t0 > self.lost_after_s:
                    self._finalize(rec["request_id"], "lost")
                else:
                    kept.append((t0, rec))
            self._parked = kept
            return 0
        parked, self._parked = self._parked, []
        landed = 0
        for t0, rec in parked:
            rid = rec["request_id"]
            handle = self.handles.get(rid)
            if handle is None or handle.finished:
                continue
            if len(rec["output_ids"]) >= rec["max_new_tokens"]:
                # everything was already generated+delivered before the
                # failure; nothing to resume
                self._finalize(rid, "length")
                continue
            candidates = [w for w in healthy
                          if w.name not in self._excluded.get(rid, ())]
            if not candidates:
                self._finalize(rid, "lost")
                continue
            # role-aware re-landing: a record with output
            # is past its prefill phase and belongs on a decode-
            # capable worker; a fresh one belongs on prefill-capable.
            # role_candidates falls back to everyone when starved —
            # landing decode work on a prefill-role worker then
            # requires colocate, or its engine would hand it off again
            phase = "decode" if rec["output_ids"] else "prefill"
            candidates = role_candidates(candidates, phase)
            target = min(candidates, key=lambda w: (w.reported_load
                         + len(self._assigned_to(w.name))))
            if phase == "decode" and target.role == "prefill":
                rec["colocate"] = True
                if rid in self._records:
                    self._records[rid]["colocate"] = True
            if not self._send_adopt(target, [rec]):
                continue     # parked again; retried next pump
            handle.migrations += 1
            self.counters["requests_migrated"] += 1
            landed += 1
        return landed

    # ---- the pump --------------------------------------------------------
    def pump(self) -> int:
        """One supervisor iteration: drain every worker's mailbox, run
        the liveness ladder, re-land parked work. Returns messages
        processed."""
        n = 0
        for worker in list(self.workers.values()):
            if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
                continue
            try:
                msgs = worker.chan.recv_all()
            except TransportError:
                self.counters["transport_errors"] += 1
                msgs = []
            for msg in msgs:
                self._process(worker, msg)
                n += 1
        self._check_liveness()
        self._check_handoffs()
        self._process_parked()
        return n

    def _check_liveness(self):
        now = self._clock()
        for worker in list(self.workers.values()):
            if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
                continue
            rc = worker.poll()
            if rc is not None:
                if worker.state is WorkerState.DRAINING and rc == 0:
                    # graceful exit raced the bye message; final
                    # snapshot/bye (already sent) will drain next pump
                    continue
                self._mark_dead(worker)
                continue
            if worker.last_beat_host_t is None:
                continue
            gap = now - worker.last_beat_host_t
            if gap > self.dead_after_s:
                # permanently stalled (wedged transport/device): kill
                # what's left and adopt from the last snapshot
                self.counters["worker_hard_stalls"] += 1
                self._mark_dead(worker)
            elif gap > self.suspect_after_s and \
                    worker.state is WorkerState.HEALTHY:
                worker.state = WorkerState.SUSPECT

    def heartbeat_gap_s(self, name: str) -> Optional[float]:
        w = self.workers[name]
        if w.last_beat_host_t is None:
            return None
        return max(0.0, self._clock() - w.last_beat_host_t)

    # ---- deliberate lifecycle --------------------------------------------
    def drain(self, name: str) -> bool:
        """Ask one worker to snapshot-and-exit gracefully; its final
        snapshot parks and re-lands through the normal pump."""
        worker = self.workers[name]
        if worker.state not in (WorkerState.HEALTHY, WorkerState.SUSPECT,
                                WorkerState.SPAWNING):
            return False
        worker.state = WorkerState.DRAINING
        self.counters["worker_drains"] += 1
        try:
            worker.chan.send("drain")
        except TransportError:
            self.counters["transport_errors"] += 1
            self._mark_dead(worker)
        return True

    def respawn(self, name: str) -> WorkerProc:
        """Replace a STOPPED/DEAD worker with a fresh process (next
        channel generation)."""
        old = self.workers[name]
        if old.state not in (WorkerState.DEAD, WorkerState.STOPPED):
            raise RuntimeError(f"worker {name} is {old.state.value}; "
                               f"drain it first")
        old.kill()
        old.cleanup()
        old.chan.purge()     # the dead generation's frames and heads
        wp = self._spawn(name, self._base_specs[name],
                         generation=old.generation + 1)
        self.workers[name] = wp
        self.counters["worker_restarts"] += 1
        return wp

    def rolling_restart(self, name: str, *, timeout_s: float = 60.0):
        """drain -> wait for the graceful exit -> respawn. Parked work
        re-lands on the next pump (on the successor once it is ready,
        or on any other healthy worker meanwhile)."""
        self.drain(name)
        deadline = time.monotonic() + timeout_s
        while self.workers[name].state not in (WorkerState.STOPPED,
                                               WorkerState.DEAD):
            self.pump()
            if time.monotonic() > deadline:
                self._mark_dead(self.workers[name])
                break
            time.sleep(5e-3)
        return self.respawn(name)

    # ---- drive to completion ---------------------------------------------
    def run(self, timeout_s: float = 300.0) -> Dict[int, List[int]]:
        """Pump until every tracked handle finishes (or timeout —
        raises). Returns {rid: tokens} for every handle tracked at the
        call."""
        tracked = dict(self.handles)
        deadline = time.monotonic() + float(timeout_s)
        while any(not h.finished for h in tracked.values()):
            n = self.pump()
            if time.monotonic() > deadline:
                livef = [rid for rid, h in tracked.items()
                         if not h.finished]
                raise RuntimeError(
                    f"ProcessFleet failed to drain: {len(livef)} "
                    f"requests live after {timeout_s}s "
                    f"(e.g. {livef[:8]}); states="
                    f"{ {w.name: w.state.value for w in self.workers.values()} }")
            if not n:
                time.sleep(2e-3)
        return {rid: list(h.tokens) for rid, h in tracked.items()}

    def shutdown(self, timeout_s: float = 10.0):
        """Graceful stop of every live worker; stragglers are killed.
        Mailbox keys the dead peers never consumed are purged and the
        supervisor's store is released — a long-lived process running
        fleets sequentially must not accumulate listening stores and
        orphaned frames."""
        for w in self.workers.values():
            if w.state in (WorkerState.HEALTHY, WorkerState.SUSPECT,
                           WorkerState.SPAWNING, WorkerState.DRAINING):
                try:
                    w.chan.send("shutdown")
                except TransportError:
                    pass
        deadline = time.monotonic() + timeout_s
        for w in self.workers.values():
            w.wait(timeout=max(0.1, deadline - time.monotonic()))
            w.kill()
            w.cleanup()
            w.chan.purge()
            w.chan.store = None
        self.store = None       # the last reference: the store closes

    def request_stats(self, name: str, *, reset_prefix_cache: bool =
                      False, timeout_s: float = 10.0) -> Optional[dict]:
        """Round-trip the reclamation probe on one live worker (None on
        timeout / non-live worker)."""
        worker = self.workers[name]
        if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
            return None
        worker.last_stats = None
        try:
            worker.chan.send("stats",
                             reset_prefix_cache=bool(reset_prefix_cache))
        except TransportError:
            self.counters["transport_errors"] += 1
            return None
        deadline = time.monotonic() + timeout_s
        while worker.last_stats is None and \
                time.monotonic() < deadline:
            self.pump()
            time.sleep(5e-3)
        return worker.last_stats

    def ping(self, name: str, *, timeout_s: float = 10.0) -> bool:
        """Explicit liveness round-trip on one worker: send `ping`,
        pump until its `pong` lands (which also refreshes the
        heartbeat clock). Heartbeats prove liveness passively every
        interval; ping answers "is the LOOP responsive right now"
        on demand — e.g. before routing a large adopt batch at a
        worker whose last beat is aging."""
        worker = self.workers[name]
        if worker.state in (WorkerState.DEAD, WorkerState.STOPPED):
            return False
        before = worker.pongs
        try:
            worker.chan.send("ping")
        except TransportError:
            self.counters["transport_errors"] += 1
            return False
        deadline = time.monotonic() + timeout_s
        while worker.pongs == before and time.monotonic() < deadline:
            self.pump()
            time.sleep(5e-3)
        return worker.pongs > before

    # ---- observability ----------------------------------------------------
    def fired_counts(self) -> Dict[str, int]:
        """Union of worker-reported fault firings (latest per worker) —
        the soak's proof that armed worker-side points landed."""
        out: Dict[str, int] = {}
        for w in self.workers.values():
            for k, v in w.fired.items():
                out[k] = out.get(k, 0) + int(v)
        return out

    def summary(self) -> dict:
        snap = {f"fleet_{k}": v for k, v in self.counters.items()}
        snap["worker_states"] = {w.name: w.state.value
                                 for w in self.workers.values()}
        snap["worker_roles"] = {w.name: w.role
                                for w in self.workers.values()}
        return snap

    def prometheus_text(self, *, prefix: str = "paddle_serving") -> str:
        """The cross-process fleet as one Prometheus scrape: supervisor
        counters, then per-WORKER labeled series — liveness, heartbeat
        gap/age (the rolling-restart visibility criterion), reported
        load, and the worker's own engine counters from its last
        heartbeat under a `worker="<name>"` label (mirroring the
        in-process fleet's `replica` labels; OBSERVABILITY.md)."""
        from ...profiler.exposition import (metric_name, prometheus_lines,
                                            sanitize_label_value)
        lines = prometheus_lines(
            {f"fleet_{k}": v for k, v in self.counters.items()},
            counter_keys={f"fleet_{k}" for k in self.counters},
            prefix=prefix)
        for w in self.workers.values():
            lab = f'{{worker="{sanitize_label_value(w.name)}"}}'
            up = int(w.state in (WorkerState.HEALTHY, WorkerState.SUSPECT,
                                 WorkerState.DRAINING))
            lines.append(
                f'{metric_name(prefix, "worker_up")}{lab} {up}')
            gap = self.heartbeat_gap_s(w.name)
            if gap is not None:
                lines.append(
                    f'{metric_name(prefix, "worker_heartbeat_gap_seconds")}'
                    f'{lab} {round(gap, 6)}')
            lines.append(
                f'{metric_name(prefix, "worker_reported_load")}{lab} '
                f'{w.reported_load}')
            lines.append(
                f'{metric_name(prefix, "worker_generation")}{lab} '
                f'{w.generation}')
            # role as an info-style series (value 1, role in the
            # label): adding a label to the existing series would
            # break every scrape joining on {worker=...} alone
            lines.append(
                f'{metric_name(prefix, "worker_role")}'
                f'{{worker="{sanitize_label_value(w.name)}",'
                f'role="{sanitize_label_value(w.role)}"}} 1')
            if w.last_beat:
                counters = w.last_beat.get("counters", {})
                lines.extend(prometheus_lines(
                    counters, counter_keys=set(counters), prefix=prefix,
                    labels={"worker": w.name}, emit_type=False))
        return "\n".join(lines) + "\n"
