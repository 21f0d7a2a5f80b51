"""Fleet core: multiplex requests over N in-process ServingEngine
replicas with prefix-affinity routing, SLO/tenant admission, replica
supervision, and ZERO-LOSS failover (port of
`paddle_tpu/serving/fleet/fleet.py`).

This is the synchronous heart of the fleet front-end (the asyncio
streaming API in server.py is a thin shell over it) — deliberately so:
the failover tests drive `step_all()` directly, with every engine, heartbeat, and deadline on one injectable
clock, so a replica kill is a deterministic, replayable event.

Request lifecycle:

    submit() --route--> replica engine --step emissions--> FleetHandle
       |                     |
       |  (crash/stall/drain)|  snapshot -> PARKED (catch-up tokens
       |                     v   delivered; deadline keeps ticking)
       |                _process_parked --adopt--> surviving replica
       +-- shed (TenantThrottled / SloUnattainable / EngineOverloaded)

Zero-loss contract: when a
replica dies or drains mid-stream, every non-finished request re-lands
on a survivor with its tokens-so-far preserved — the stream sees each
token EXACTLY once (snapshot tokens the stream never saw are delivered
as catch-up at migration; the resumed engine re-prefills prompt+output
and only ever emits NEW tokens), and greedy output is bit-identical to
an uninterrupted run because every replica runs the same model under
the same bucket grid (the engine's determinism contract). The dead
replica's pool reclaims fully (`ServingEngine.vacate`). Requests that
FINISHED inside the very step that killed the replica lost their
emissions with the raise — their tokens are recovered from
`request.output_ids` at evacuation, same exactly-once rule.

SLO-aware admission: `ttft_slo_s` / `tpot_slo_s` targets convert into
the engine's existing deadline machinery (deadline = TTFT budget +
TPOT * max_new_tokens) and, when the fleet has a TTFT estimator, into
an admission-time shed (`SloUnattainable`) — refusing work that would
only expire in the queue. Per-tenant fairness is an admission cap on
each tenant's live share of fleet capacity (`TenantThrottled`).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from ...utils import faults
from ..engine import check_snapshot_version
from ..errors import EngineFailure, EngineOverloaded
from ..lora.adapter import AdapterNotLoaded
from ..metrics import ServingMetrics
from ..scheduler import RequestState
from .errors import (NoHealthyReplica, ReplicaCrashed, SloUnattainable,
                     TenantThrottled)
from .replica import Replica, ReplicaState
from .router import PrefixAffinityRouter, Router

__all__ = ["Fleet", "FleetHandle", "FAULT_ROUTE_RACE"]

# Routing race fault point: fires after
# the router scored and chose — a payload means "the chosen replica
# went unhealthy between scoring and submission", so the fleet must
# re-route among the remaining candidates instead of submitting into a
# void. With one candidate left the firing is consumed but ignored
# (there is nobody else to race to).
FAULT_ROUTE_RACE = faults.register_point("fleet.route_race")

_DEFAULT_TENANT = "_default"


# single source of the streamed event shapes: live emission, a late
# stream's replay, and the synthetic close event must never drift apart
def token_event(handle: "FleetHandle", tok: int, index: int) -> dict:
    return {"type": "token", "token": int(tok), "index": int(index),
            "request_id": handle.request_id}


def finish_event(handle: "FleetHandle", reason) -> dict:
    return {"type": "finish", "finish_reason": reason,
            "num_tokens": len(handle.tokens),
            "request_id": handle.request_id}


class FleetHandle:
    """Client-side view of one fleet request: the stable request id
    (engine request ids are process-global, so the id survives
    migration), tokens delivered so far, and the terminal state. The
    async streaming layer `subscribe`s listeners to receive token /
    finish events as they happen (several streams may watch one
    handle); synchronous callers read `.tokens` after `Fleet.run()`."""

    __slots__ = ("request_id", "tenant", "tokens", "finished",
                 "finish_reason", "migrations", "_listeners",
                 "submit_t", "first_token_t", "finish_t",
                 "ttft_slo_s", "tpot_slo_s", "token_ts")

    def __init__(self, request_id: int, tenant: str):
        self.request_id = int(request_id)
        self.tenant = tenant
        self.tokens: List[int] = []
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.migrations = 0
        self._listeners: List = []     # callables(event dict)
        # SLO-burn accounting: stamps on the FLEET clock +
        # the targets the request was admitted under; _finalize turns
        # observed-vs-target into the slo_*_violations counters
        self.submit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.ttft_slo_s: Optional[float] = None
        self.tpot_slo_s: Optional[float] = None
        # per-token delivery stamps on the fleet clock: inter-token
        # gaps after the first token are decode TPOT samples.
        # Catch-up bursts land many tokens on one stamp — TPOT readers
        # must use clean (migration-free) passes.
        self.token_ts: List[float] = []

    def subscribe(self, listener):
        """Attach an event callback; every attached listener sees every
        subsequent event (a second stream must not detach the first).
        Listeners are released at finish (no further events can ever
        fire), and subscribing to an already-finished handle is a no-op
        for the same reason — streams replay a finished handle from its
        state, so pinning a listener would only leak the caller's
        queue. Detach a live one early with `unsubscribe`."""
        if not self.finished:
            self._listeners.append(listener)

    def unsubscribe(self, listener):
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def _emit_event(self, event: dict):
        for cb in self._listeners:
            cb(event)

    # exactly-once delivery funnel: every token a client ever sees —
    # live emission or migration catch-up — passes through here once
    def _deliver(self, tok: int):
        self.tokens.append(int(tok))
        self._emit_event(token_event(self, tok, len(self.tokens) - 1))

    def _finish(self, reason: str):
        if self.finished:
            return
        self.finished = True
        self.finish_reason = reason
        self._emit_event(finish_event(self, reason))
        # terminal: nothing will ever be emitted again, so drop the
        # listeners (each holds a stream queue) — late-attached streams
        # replay from the handle's state, not from events
        self._listeners = []

    def __repr__(self):
        state = self.finish_reason if self.finished else "live"
        return (f"FleetHandle({self.request_id}, {state}, "
                f"tokens={len(self.tokens)})")


class Fleet:
    """N supervised replicas behind one submit/step façade.

    engines: the in-process ServingEngine replicas (normally sharing
    one model object — engines snapshot the weights read-only — and,
    for deadline-correct migration, the SAME `clock` passed here: a
    parked request's deadline keeps ticking on the fleet clock and is
    re-anchored on the target engine's clock at adoption, which only
    lines up when they agree).

    Supervision knobs: `stall_timeout_s` (heartbeat age that marks a
    working replica unhealthy), `max_consecutive_failures` (step
    exceptions in a row before eviction from rotation). Admission
    knobs: `max_inflight_per_tenant` (per-tenant fairness cap on live
    requests), `est_ttft_per_queued_s` (optional per-queued-request
    TTFT estimate powering the SLO admission shed).
    """

    def __init__(self, engines, *, router: Optional[Router] = None,
                 clock=None, stall_timeout_s: float = 5.0,
                 max_consecutive_failures: int = 3,
                 max_inflight_per_tenant: Optional[int] = None,
                 est_ttft_per_queued_s: Optional[float] = None,
                 max_retained_handles: int = 4096,
                 names: Optional[List[str]] = None):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self._clock = clock if clock is not None else time.monotonic
        if names is None:
            names = [f"replica-{i}" for i in range(len(engines))]
        if len(names) != len(engines) or len(set(names)) != len(names):
            raise ValueError("names must be unique, one per engine")
        self.replicas = [Replica(n, e, clock=self._clock)
                         for n, e in zip(names, engines)]
        self.router = router if router is not None \
            else PrefixAffinityRouter()
        self.stall_timeout_s = float(stall_timeout_s)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.max_inflight_per_tenant = max_inflight_per_tenant
        self.est_ttft_per_queued_s = est_ttft_per_queued_s

        self._handles: Dict[int, FleetHandle] = {}
        # bounded finished-handle retention (same unbounded-growth class
        # the engine bounds with max_retained_finished): a long-lived
        # server must not keep every handle it ever served — only the
        # most recent `max_retained_handles` finished ones stay readable
        # via fleet.handle(); callers' own references live on untouched
        self.max_retained_handles = int(max_retained_handles)
        self._finished_order: deque = deque()
        self.num_evicted_handles = 0
        self._assign: Dict[int, Replica] = {}
        self._by_replica: Dict[str, Set[int]] = {r.name: set()
                                                 for r in self.replicas}
        # (snapshot_time, request record) parked between a replica's
        # death/drain and re-landing on a survivor
        self._parked: List[Tuple[float, dict]] = []
        self._tenant_live: Dict[str, int] = {}
        self.counters: Dict[str, int] = {
            "requests_submitted": 0,
            "requests_finished": 0,
            "requests_migrated": 0,
            "requests_lost": 0,
            "requests_shed": 0,
            "catchup_tokens": 0,
            "replica_deaths": 0,
            "replica_stalls": 0,
            "replica_drains": 0,
            "route_races": 0,
            "tenant_throttled": 0,
            "slo_sheds": 0,
            # SLO burn: requests whose OBSERVED TTFT/TPOT
            # missed the target they were admitted under — the
            # admission shed above refuses hopeless work, these count
            # accepted work that still burned its budget
            "slo_ttft_violations": 0,
            "slo_tpot_violations": 0,
            # parked adapter'd requests that could not re-land
            # because NO survivor held their adapter — kept parked
            # (typed), re-tried each parked sweep, never served with
            # the wrong weights and never silently lost
            "adapter_parks": 0,
        }

    # ---- lookups ---------------------------------------------------------
    def replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"unknown replica {name!r}")

    def _healthy(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state is ReplicaState.HEALTHY]

    def handle(self, request_id: int) -> FleetHandle:
        """Look up a tracked handle. Finished handles older than the
        retention window are forgotten (KeyError) — callers that need a
        result past that should keep the handle submit() returned."""
        return self._handles[request_id]

    def has_work(self) -> bool:
        return bool(self._parked or self._assign)

    # ---- admission -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               eos_token_id: Optional[int] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None,
               ttl_s: Optional[float] = None,
               deadline: Optional[float] = None,
               ttft_slo_s: Optional[float] = None,
               tpot_slo_s: Optional[float] = None) -> FleetHandle:
        """Route and queue one request; returns its FleetHandle.

        SLO targets convert into the deadline machinery: the request
        must produce its first token within `ttft_slo_s` and then
        sustain `tpot_slo_s` per token, so its whole lifetime is
        bounded by ttft + tpot * max_new_tokens — passed down as the
        engine TTL when `tpot_slo_s` is given (mutually exclusive with
        an explicit ttl_s / deadline; a ttft-only target drives the
        admission-time shed but sets no TTL — the deadline bounds the
        whole lifetime, which only the per-token rate can size). Sheds are typed: `TenantThrottled` (fairness cap),
        `SloUnattainable` (TTFT target hopeless at current load),
        `EngineOverloaded` (every candidate's queue full),
        `NoHealthyReplica` (nobody in rotation), `AdapterNotLoaded`
        (no candidate replica holds the named adapter —
        routing prefers adapter-holding replicas, and an adapter'd
        request sheds typed rather than ever serving other weights;
        per-adapter fairness rides the existing `tenant` cap — pass
        the adapter (or its owner) as the tenant to cap its live
        share)."""
        self._process_parked()
        tkey = tenant if tenant is not None else _DEFAULT_TENANT
        if self.max_inflight_per_tenant is not None and \
                self._tenant_live.get(tkey, 0) >= \
                self.max_inflight_per_tenant:
            self.counters["tenant_throttled"] += 1
            raise TenantThrottled(
                f"tenant {tkey!r} already holds "
                f"{self._tenant_live.get(tkey, 0)} live requests "
                f"(cap {self.max_inflight_per_tenant})",
                tenant=tkey, live=self._tenant_live.get(tkey, 0),
                limit=self.max_inflight_per_tenant)
        if ttft_slo_s is not None or tpot_slo_s is not None:
            if ttl_s is not None or deadline is not None:
                raise ValueError("pass SLO targets or ttl_s/deadline, "
                                 "not both")
            if tpot_slo_s is not None:
                ttl_s = ((ttft_slo_s or 0.0)
                         + tpot_slo_s * int(max_new_tokens))
            # ttft-only: the deadline machinery bounds a request's
            # WHOLE lifetime, so using the TTFT budget as the TTL would
            # expire a request mid-generation even after its first
            # token met the target — without a per-token rate there is
            # no honest lifetime bound, so a ttft-only target drives
            # the admission shed below and nothing else
        candidates = self._healthy()
        if not candidates:
            raise NoHealthyReplica("no healthy replica to accept work")
        prompt_ids = [int(t) for t in prompt_ids]
        est_floor = None
        overloaded_holder = None
        while True:
            chosen = self.router.route(prompt_ids, candidates,
                                       adapter=adapter)
            if ttft_slo_s is not None and self.est_ttft_per_queued_s:
                # the SLO check scores the replica the request would
                # ACTUALLY land on — scoring the fleet minimum would
                # admit a request the router then routes into a deep
                # queue, accepted only to expire. A too-deep choice is
                # excluded and the rest retried; only when every
                # candidate fails does the shed surface.
                est = (chosen.engine.scheduler.queue_depth
                       * self.est_ttft_per_queued_s)
                if est > ttft_slo_s:
                    est_floor = est if est_floor is None \
                        else min(est_floor, est)
                    candidates = [c for c in candidates
                                  if c is not chosen]
                    if candidates:
                        continue
                    self.counters["slo_sheds"] += 1
                    raise SloUnattainable(
                        f"estimated TTFT {est_floor:.3f}s exceeds the "
                        f"{ttft_slo_s:.3f}s target on every replica",
                        ttft_slo_s=ttft_slo_s, est_ttft_s=est_floor)
            if faults.fire(FAULT_ROUTE_RACE) is not None and \
                    len(candidates) > 1:
                # chosen went unhealthy between scoring and submission:
                # retry among the others
                self.counters["route_races"] += 1
                candidates = [c for c in candidates if c is not chosen]
                continue
            try:
                rid = chosen.engine.add_request(
                    prompt_ids, max_new_tokens=max_new_tokens,
                    eos_token_id=eos_token_id, ttl_s=ttl_s,
                    deadline=deadline, adapter=adapter)
            except (EngineOverloaded, AdapterNotLoaded) as exc:
                # typed per-candidate refusal (queue full, or the
                # chosen replica does not hold the adapter): try the
                # rest. When everyone refuses, surface the MOST
                # ACTIONABLE shed: an overload from a replica that DOES
                # hold the adapter outranks "adapter not loaded"
                # elsewhere — a retryable 429, not a spurious 404
                # claiming the adapter is missing from the fleet.
                if isinstance(exc, EngineOverloaded):
                    overloaded_holder = exc
                candidates = [c for c in candidates if c is not chosen]
                if not candidates:
                    self.counters["requests_shed"] += 1
                    if isinstance(exc, AdapterNotLoaded) and \
                            overloaded_holder is not None:
                        raise overloaded_holder from exc
                    raise
                continue
            break
        handle = FleetHandle(rid, tkey)
        handle.submit_t = self._clock()
        handle.ttft_slo_s = ttft_slo_s
        handle.tpot_slo_s = tpot_slo_s
        tracer = getattr(chosen.engine, "tracer", None)
        if tracer is not None:
            # the routing decision, with the scores it was made on —
            # the read-only match_len probe re-runs only when tracing
            tracer.mark(rid, "route", chosen=chosen.name,
                        scores={c.name: {"match_len":
                                         c.match_len(prompt_ids,
                                                     adapter=adapter),
                                         "load": c.load}
                                for c in candidates})
        self._handles[rid] = handle
        self._assign_to(rid, chosen)
        self._tenant_live[tkey] = self._tenant_live.get(tkey, 0) + 1
        self.counters["requests_submitted"] += 1
        return handle

    def abort(self, request_id: int) -> bool:
        """Client abort, wherever the request currently lives: on its
        replica (engine abort, honored at the next boundary), or PARKED
        mid-migration (the flag rides the snapshot record and the
        target engine honors it at its first boundary — the pages the
        dead replica held were already freed exactly once at
        evacuation, and the target frees its own exactly once at
        cancel). Returns False for unknown/finished requests."""
        replica = self._assign.get(request_id)
        if replica is not None:
            return replica.engine.abort(request_id)
        for _, rec in self._parked:
            if rec["request_id"] == request_id:
                rec["aborted"] = True
                return True
        return False

    # ---- assignment bookkeeping -----------------------------------------
    def _assign_to(self, rid: int, replica: Replica):
        self._assign[rid] = replica
        self._by_replica[replica.name].add(rid)

    def _unassign(self, rid: int):
        replica = self._assign.pop(rid, None)
        if replica is not None:
            self._by_replica[replica.name].discard(rid)

    def _finalize(self, rid: int, reason: str):
        self._unassign(rid)
        handle = self._handles.get(rid)
        if handle is None or handle.finished:
            return
        handle.finish_t = self._clock()
        self._account_slo(handle)
        handle._finish(reason)
        self._tenant_live[handle.tenant] = max(
            0, self._tenant_live.get(handle.tenant, 1) - 1)
        if reason == "lost":
            self.counters["requests_lost"] += 1
            tracer = self._tracer()
            if tracer is not None:
                # every other terminal reason finishes its trace on the
                # owning engine; "lost" has no engine left to do it
                tracer.finish(rid, "lost")
        else:
            self.counters["requests_finished"] += 1
        self._finished_order.append(rid)
        while len(self._finished_order) > self.max_retained_handles:
            self._handles.pop(self._finished_order.popleft(), None)
            self.num_evicted_handles += 1

    def _tracer(self):
        """The (shared) request tracer, when any replica's engine has
        one. A fleet that traces passes ONE RequestTracer to every
        engine — the first found is the fleet's."""
        for r in self.replicas:
            t = getattr(r.engine, "tracer", None)
            if t is not None:
                return t
        return None

    def _deliver(self, handle: FleetHandle, tok: int):
        """Exactly-once delivery + the first-token SLO stamp (catch-up
        and live emission both land here, so TTFT is observed whichever
        path a migrated request's first token took)."""
        handle._deliver(tok)
        if handle.first_token_t is None:
            handle.first_token_t = self._clock()

    def _account_slo(self, handle: FleetHandle):
        """Observed-vs-target SLO burn at finalize: a TTFT
        target is violated when the first token came late (or never); a
        TPOT target when the per-token rate after the first token ran
        slower than admitted. Counted once per request, on the same
        fleet clock the deadline machinery runs on."""
        if handle.ttft_slo_s is not None and handle.submit_t is not None:
            if handle.first_token_t is None or \
                    handle.first_token_t - handle.submit_t \
                    > handle.ttft_slo_s:
                self.counters["slo_ttft_violations"] += 1
        if handle.tpot_slo_s is not None and \
                handle.first_token_t is not None and \
                len(handle.tokens) > 1 and handle.finish_t is not None:
            tpot = (handle.finish_t - handle.first_token_t) \
                / (len(handle.tokens) - 1)
            if tpot > handle.tpot_slo_s:
                self.counters["slo_tpot_violations"] += 1

    def _catch_up(self, handle: FleetHandle, output_ids):
        """Deliver the suffix of `output_ids` the stream has not seen.
        Tokens delivered live are a prefix of the engine's output_ids
        by construction (emission appends in the same order), so the
        suffix rule is exactly-once delivery."""
        for tok in output_ids[len(handle.tokens):]:
            self._deliver(handle, tok)
            self.counters["catchup_tokens"] += 1

    # ---- stepping + supervision -----------------------------------------
    def step_replica(self, replica: Replica) -> List[Tuple[int, int]]:
        """One supervised step of one replica: re-land any parked work
        first (any replica's loop may pick it up), step the engine,
        deliver emissions to handles, sweep finished requests, and
        apply the supervision policy to anything `step()` raised."""
        self._process_parked()
        if replica.state is not ReplicaState.HEALTHY:
            return []
        try:
            emitted = replica.step()
        except ReplicaCrashed:
            self._fail_replica(replica, ReplicaState.DEAD,
                               replica.engine.snapshot(
                                   reason=f"crash of {replica.name}"))
            return []
        except Exception as exc:                      # noqa: BLE001
            if isinstance(exc, EngineFailure):
                snap = exc.snapshot if exc.snapshot is not None \
                    else replica.engine.last_snapshot
                self._fail_replica(replica, ReplicaState.DEAD, snap)
                return []
            replica.consecutive_failures += 1
            if replica.consecutive_failures >= \
                    self.max_consecutive_failures:
                self._fail_replica(
                    replica, ReplicaState.UNHEALTHY,
                    replica.engine.snapshot(
                        reason=f"{replica.consecutive_failures} "
                               f"consecutive step failures on "
                               f"{replica.name}"))
            return []
        for rid, tok in emitted:
            handle = self._handles.get(rid)
            if handle is not None:
                self._deliver(handle, tok)
        self._sweep_finished(replica)
        return emitted

    def step_all(self) -> int:
        """One fleet iteration: step every healthy replica once, then
        run health checks (stall detection). Returns tokens emitted."""
        iter_start = self._clock()
        n = 0
        for replica in self.replicas:
            n += len(self.step_replica(replica))
        self.check_health(iter_start=iter_start)
        return n

    def check_health(self, iter_start: Optional[float] = None):
        """Stall detection: a HEALTHY replica with work whose heartbeat
        is older than `stall_timeout_s` is marked UNHEALTHY and
        evacuated — from the outside a wedged stepping loop and a dead
        one are the same thing: no progress.

        Saturation guard: with more than one replica, eviction also
        requires some OTHER healthy replica to have progressed
        meaningfully past the suspect's heartbeat — when EVERY
        heartbeat is equally old the stepping loop itself is merely
        slow/saturated (synchronous engine steps sharing one event
        loop), and evicting healthy replicas one by one would cascade
        to finalizing all in-flight work "lost" with no real fault.
        Single-replica fleets fall back to the raw timeout (there is
        nobody to compare against).

        `iter_start` (step_all passes its loop-entry time): a replica
        whose heartbeat is AT or PAST it completed a successful step
        THIS iteration and is exempt — the replicas step sequentially,
        so one slow sibling step (a cold first step can take seconds)
        would otherwise age an earlier, perfectly
        live replica straight past the timeout. Genuinely wedged
        replicas never stamp `last_progress` (the fault-stall path
        skips the engine step without touching the heartbeat), so
        detection is unchanged."""
        now = self._clock()
        for r in list(self.replicas):
            if r.state is not ReplicaState.HEALTHY or \
                    not r.engine.has_work():
                continue
            if iter_start is not None and r.last_progress >= iter_start:
                continue
            if now - r.last_progress <= self.stall_timeout_s:
                continue
            others = [o for o in self.replicas
                      if o is not r and o.state is ReplicaState.HEALTHY]
            if others and not any(
                    o.last_progress - r.last_progress
                    > self.stall_timeout_s for o in others):
                continue
            self.counters["replica_stalls"] += 1
            self._fail_replica(
                r, ReplicaState.UNHEALTHY,
                r.engine.snapshot(reason=f"stall on {r.name}"))

    def _sweep_finished(self, replica: Replica):
        """Finalize handles whose requests reached a terminal state on
        this replica (finish reasons surface verbatim: "stop",
        "length", "abort", "expired", "quarantined")."""
        for rid in list(self._by_replica.get(replica.name, ())):
            req = replica.engine.requests.get(rid)
            if req is None:
                # evicted from the bounded retention window before the
                # fleet observed a terminal state (cannot happen at the
                # default window; belt-and-braces)
                self._finalize(rid, "lost")
            elif req.state is RequestState.FINISHED:
                self._finalize(rid, req.finish_reason)

    # ---- failover --------------------------------------------------------
    def _fail_replica(self, replica: Replica, state: ReplicaState,
                      snapshot: dict):
        """Take `replica` out of rotation and turn its snapshot into
        parked migration work; then reclaim its entire pool."""
        replica.state = state
        if state is ReplicaState.DEAD:
            self.counters["replica_deaths"] += 1
        self._evacuate(replica, snapshot)

    def _evacuate(self, replica: Replica, snapshot: dict):
        """The zero-loss handoff: park every snapshot-captured request
        for re-landing; recover the tokens of requests that FINISHED
        inside the fatal step (their emissions died with the raise);
        then free every page the replica held (`vacate` — the
        reclamation the failover tests assert)."""
        check_snapshot_version(snapshot)
        recs = {rec["request_id"]: rec for rec in snapshot["requests"]}
        now = self._clock()
        tracer = getattr(replica.engine, "tracer", None)
        for rid in list(self._by_replica.get(replica.name, ())):
            rec = recs.get(rid)
            if rec is not None:
                self._unassign(rid)
                self._parked.append((now, rec))
                if tracer is not None:
                    # migration PARK: the trace stays live (the work
                    # re-lands; `adopt` marks the landing)
                    tracer.mark(rid, "park", replica=replica.name,
                                reason=str(snapshot.get("reason")))
                continue
            req = replica.engine.requests.get(rid)
            if req is not None and req.state is RequestState.FINISHED \
                    and req.finish_reason != "migrated":
                handle = self._handles.get(rid)
                if handle is not None:
                    self._catch_up(handle, req.output_ids)
                self._finalize(rid, req.finish_reason)
            else:
                self._finalize(rid, "lost")
        replica.engine.vacate()

    def _process_parked(self) -> int:
        """Re-land parked requests on survivors: catch-up tokens to the
        stream, deadline re-anchored with the PARKED time charged
        against it (a request whose deadline lapsed while parked is
        adopted and expires at the target's first boundary — before it
        allocates any pages there), prefix-affinity routed on its full
        resume prompt. With zero survivors the requests are finalized
        "lost" — zero-loss needs somewhere to land."""
        if not self._parked:
            return 0
        healthy = self._healthy()
        parked, self._parked = self._parked, []
        landed = 0
        for t0, rec in parked:
            rid = rec["request_id"]
            handle = self._handles.get(rid)
            if handle is None or handle.finished:
                continue
            if not healthy:
                self._finalize(rid, "lost")
                continue
            self._catch_up(handle, rec["output_ids"])
            rec = dict(rec)
            rem = rec.get("deadline_remaining_s")
            if rem is not None:
                rec["deadline_remaining_s"] = \
                    float(rem) - (self._clock() - t0)
            # adoption must not drop the REST of the parked list on one
            # bad record: a survivor can legitimately refuse a request
            # its geometry cannot hold (heterogeneous pools /
            # max_seq_len). Try every healthy candidate; only when all
            # refuse is the request finalized "lost" — never silently
            # vanished, never an exception up through an unrelated
            # caller's submit()/step loop. Exception: an
            # adapter'd record every survivor refused FOR THE ADAPTER
            # stays PARKED (typed, counted) — it re-lands the moment
            # some replica loads the adapter, and is never served with
            # the wrong weights nor finalized lost while survivors
            # exist.
            candidates = list(healthy)
            target = None
            adapter_refusals = other_refusals = 0
            while candidates:
                pick = self.router.route(
                    rec["prompt_ids"] + rec["output_ids"], candidates,
                    adapter=rec.get("adapter"))
                try:
                    pick.engine.adopt_requests([rec])
                except AdapterNotLoaded:
                    adapter_refusals += 1
                    candidates = [c for c in candidates if c is not pick]
                    continue
                except Exception:                     # noqa: BLE001
                    other_refusals += 1
                    candidates = [c for c in candidates if c is not pick]
                    continue
                target = pick
                break
            if target is None:
                if adapter_refusals and not other_refusals:
                    rem = rec.get("deadline_remaining_s")
                    if rem is not None and rem <= 0:
                        # its TTL lapsed while waiting for the adapter:
                        # expire (the terminal an adopter would apply)
                        # instead of parking a dead request forever
                        self._finalize(rid, "expired")
                    else:
                        self.counters["adapter_parks"] += 1
                        self._parked.append((self._clock(), rec))
                else:
                    self._finalize(rid, "lost")
                continue
            self._assign_to(rid, target)
            handle.migrations += 1
            self.counters["requests_migrated"] += 1
            landed += 1
        return landed

    # ---- drain (deliberate) ---------------------------------------------
    def drain(self, name: str) -> int:
        """Deliberately empty one replica: out of rotation, snapshot
        becomes live migration exactly like a crash (same parked path,
        same exactly-once token rule), pool fully reclaimed. Returns
        the number of requests handed off."""
        replica = self.replica(name)
        if replica.state is not ReplicaState.HEALTHY:
            return 0
        replica.state = ReplicaState.DRAINED
        self.counters["replica_drains"] += 1
        before = len(self._by_replica.get(replica.name, ()))
        self._evacuate(replica, replica.engine.snapshot(
            reason=f"drain of {replica.name}"))
        self._process_parked()
        return before

    # ---- convenience / lifecycle ----------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Drain everything synchronously; {request_id: tokens} for
        every handle the fleet tracked at the call (references are
        pinned first, so the bounded retention window evicting a
        finished handle mid-drain cannot drop its results)."""
        tracked = dict(self._handles)
        if max_steps is None:
            max_steps = 1000 * max(1, len(tracked))
        steps = 0
        while self.has_work():
            self.step_all()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet failed to drain after {steps} steps")
        return {rid: list(h.tokens) for rid, h in tracked.items()}

    def merged_metrics(self) -> ServingMetrics:
        """One cross-replica ServingMetrics (unregistered view)."""
        return ServingMetrics.merge(
            *[r.engine.metrics for r in self.replicas], name="fleet")

    def summary(self) -> dict:
        """Merged engine metrics + fleet counters + replica health."""
        snap = self.merged_metrics().snapshot()
        snap.update({f"fleet_{k}": v for k, v in self.counters.items()})
        snap["replica_states"] = {r.name: r.state.value
                                  for r in self.replicas}
        return snap

    def prometheus_text(self, *, prefix: str = "paddle_serving") -> str:
        """The fleet as one Prometheus scrape: the merged
        engine metrics and fleet counters (from `summary()` — the
        exposition derives from the same snapshot path, so they can
        never disagree), then every replica's OWN engine metrics under
        a `replica="<name>"` label (per-replica visibility is the point
        of the labels; Prometheus aggregates in queries). TYPE lines
        are emitted once, on the merged block."""
        from ...profiler.exposition import (metric_name, prometheus_lines,
                                            sanitize_label_value)
        merged = self.merged_metrics()
        counter_keys = set(merged.counters) | {
            f"fleet_{k}" for k in self.counters}
        lines = prometheus_lines(self.summary(),
                                 counter_keys=counter_keys,
                                 prefix=prefix)
        for r in self.replicas:
            lines.append(f'{metric_name(prefix, "replica_up")}'
                         f'{{replica="{sanitize_label_value(r.name)}"}} '
                         f'{int(r.state is ReplicaState.HEALTHY)}')
            lines.extend(prometheus_lines(
                r.engine.metrics.snapshot(),
                counter_keys=set(r.engine.metrics.counters),
                prefix=prefix, labels={"replica": r.name},
                emit_type=False))
        return "\n".join(lines) + "\n"

    def shutdown(self):
        for r in self.replicas:
            r.engine.shutdown()
