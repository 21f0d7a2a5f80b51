"""One supervised serving replica: an in-process ServingEngine plus the
health state the fleet's supervision loop reads (port of
`paddle_tpu/serving/fleet/replica.py`).

A replica is the unit of failure: the fleet steps each replica on its
own loop, and every step updates a HEARTBEAT (`last_progress`, on the
fleet's injectable clock). Supervision derives three unhealth signals
from it (fleet.py acts on them):

* **crash** — `ReplicaCrashed` (the `fleet.replica_crash` fault point)
  or `EngineFailure` escaping `step()`: the replica is dead on the
  spot, its snapshot is the live-migration payload;
* **stall** — the replica has work but its heartbeat has not advanced
  within `stall_timeout_s` (the `fleet.stream_stall` fault point models
  this: an armed stall makes `step()` return without stepping the
  engine OR touching the heartbeat);
* **consecutive failures** — `max_consecutive_failures` step exceptions
  of any other kind in a row (one success resets the count).

Everything here is host-side bookkeeping around the engine — replicas
stay in-process (several engines may share one model and one card),
so the whole fleet is deterministically testable.
"""
from __future__ import annotations

import enum
import time

from ...utils import faults
from .errors import ReplicaCrashed

__all__ = ["Replica", "ReplicaState", "FAULT_CRASH", "FAULT_STALL"]

# Fleet fault-injection points (utils/faults.py). replica_crash fires at the TOP of Replica.step — an
# iteration boundary, so the engine's host state is consistent and the
# snapshot the fleet takes is exact. A payload of True crashes whichever
# replica hits the spec; a payload naming a replica crashes exactly that
# one (other replicas consume the firing and ignore it — arm with
# times=-1 for a targeted kill). An exc spec raises as-is and lands in
# the consecutive-failure supervision path instead. stream_stall makes
# the matching replica skip the engine step WITHOUT advancing its
# heartbeat — the stall detector's trigger; arm times=-1 + a name for a
# permanent targeted wedge. NOTE: a NAMED payload with finite `times`
# does NOT give a k-step targeted hiccup — non-target replicas consume
# firings they then ignore, so the target sees only ~k/R of them; use
# payload=True (whoever steps stalls) or a single-replica fleet for
# bounded hiccups.
FAULT_CRASH = faults.register_point("fleet.replica_crash")
FAULT_STALL = faults.register_point("fleet.stream_stall")


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"        # in rotation: routed to and stepped
    DRAINED = "drained"        # deliberately emptied; out of rotation
    UNHEALTHY = "unhealthy"    # stall/failure threshold; evacuated
    DEAD = "dead"              # crashed; evacuated


class Replica:
    """One engine + its supervision-visible health state."""

    def __init__(self, name: str, engine, clock=None):
        self.name = str(name)
        self.engine = engine
        self.state = ReplicaState.HEALTHY
        self._clock = clock if clock is not None else time.monotonic
        self.steps_done = 0
        self.stalled_steps = 0
        self.consecutive_failures = 0
        self.last_progress = self._clock()

    # ---- router inputs ---------------------------------------------------
    @property
    def load(self) -> int:
        """In-flight + queued requests — the router's tiebreak."""
        s = self.engine.scheduler
        return s.num_in_flight + s.queue_depth

    def match_len(self, tokens, adapter=None) -> int:
        """Read-only longest-cached-prefix probe of THIS replica's radix
        tree (0 with the prefix cache off) — the router's primary
        score. Must never perturb the cache: `RadixCache.match_len`
        skips the LRU bump by contract. `adapter` namespaces the probe
        key exactly like the scheduler's match, so the score
        reflects what admission would actually reuse."""
        radix = self.engine.radix
        if radix is None:
            return 0
        key = adapter
        if adapter is not None:
            lora = getattr(self.engine, "lora", None)
            if lora is None or not lora.has(adapter):
                return 0           # nothing cached under an unheld adapter
            # the engine namespaces by (name, load-generation) — probe
            # with the same key admission would match with
            key = lora.namespace_of(adapter)
        from ..scheduler import adapter_prefix_key
        return radix.match_len(adapter_prefix_key(list(tokens), key))

    def has_adapter(self, adapter) -> bool:
        """True when this replica's registry currently holds `adapter`
        (trivially True for base-model traffic) — the adapter-affinity
        router's primary score."""
        if adapter is None:
            return True
        lora = getattr(self.engine, "lora", None)
        return lora is not None and lora.has(adapter)

    # ---- the stepping loop body -----------------------------------------
    def _targets_me(self, payload) -> bool:
        return payload is True or payload == self.name

    def step(self):
        """One supervised engine iteration. Returns the engine's
        emitted [(request_id, token)]; raises whatever the engine (or
        an injected crash) raises — supervision policy lives in the
        fleet, not here."""
        crash = faults.fire(FAULT_CRASH)
        if crash is not None and self._targets_me(crash):
            raise ReplicaCrashed(f"injected crash of {self.name}")
        stall = faults.fire(FAULT_STALL)
        if stall is not None and self._targets_me(stall):
            # no engine step, no heartbeat: indistinguishable from a
            # wedged device loop to the stall detector — by design
            self.stalled_steps += 1
            return []
        emitted = self.engine.step()
        self.steps_done += 1
        self.consecutive_failures = 0
        self.last_progress = self._clock()
        return emitted

    def __repr__(self):
        return (f"Replica({self.name}, {self.state.value}, "
                f"load={self.load}, steps={self.steps_done})")
