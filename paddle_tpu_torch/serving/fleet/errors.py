"""Typed failure surface of the fleet layer (port of
`paddle_tpu/serving/fleet/errors.py`).

Engine-level errors live in `serving.errors`; these are failures of the
layer ABOVE it — routing, replica supervision, and fleet admission:

* `NoHealthyReplica` — the router has no candidate: every replica is
  dead, drained, or unhealthy. Submission-time only; requests already
  accepted are migrated (or, with zero survivors, finalized "lost").
* `TenantThrottled` — per-tenant fairness cap hit: this tenant already
  holds its share of fleet capacity. Subclasses `EngineOverloaded` so
  callers that treat sheds uniformly (retry-after, backpressure) keep
  working without a new except arm.
* `SloUnattainable` — SLO-aware admission refused the request: even the
  least-loaded replica cannot plausibly meet the requested TTFT target.
  Shedding at the door beats accepting work that will expire mid-queue
  (the deadline machinery would cancel it anyway, after it wasted pages
  and budget). Also an `EngineOverloaded` subclass.
* `ReplicaCrashed` — the hard-crash signal the `fleet.replica_crash`
  fault point raises inside a replica's stepping loop; the fleet treats
  it as the replica process dying at an iteration boundary.
"""
from __future__ import annotations

from ..errors import EngineOverloaded

__all__ = ["NoHealthyReplica", "TenantThrottled", "SloUnattainable",
           "ReplicaCrashed"]


class NoHealthyReplica(RuntimeError):
    """Every replica is out of rotation; nothing can accept work."""


class TenantThrottled(EngineOverloaded):
    """Per-tenant fairness cap: the tenant's live-request share of the
    fleet is already at its limit."""

    def __init__(self, msg: str, tenant=None, live: int = 0,
                 limit: int = 0):
        super().__init__(msg, queue_depth=live, max_queue_len=limit)
        self.tenant = tenant
        self.live = live
        self.limit = limit


class SloUnattainable(EngineOverloaded):
    """Admission-time SLO check failed: the TTFT target cannot be met
    at current load, so the request is shed instead of accepted-to-
    expire."""

    def __init__(self, msg: str, ttft_slo_s=None, est_ttft_s=None):
        super().__init__(msg)
        self.ttft_slo_s = ttft_slo_s
        self.est_ttft_s = est_ttft_s


class ReplicaCrashed(RuntimeError):
    """Injected hard crash of one replica (fault point
    `fleet.replica_crash` with a payload naming the victim)."""
