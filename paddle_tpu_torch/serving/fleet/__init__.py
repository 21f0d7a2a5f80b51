"""paddle_tpu_torch.serving.fleet — multi-replica serving front-end, in
process (port of `paddle_tpu/serving/fleet/`).

The layer above the engine: N in-process ServingEngine replicas behind
one streaming API, with prefix-affinity routing (the radix hit rate as
a fleet property), SLO/tenant-aware admission riding the engine's
deadline and shed machinery, replica supervision (heartbeats, stall and
consecutive-failure detection), and ZERO-LOSS failover — the engine's
snapshot turned into live migration, with tokens-so-far preserved and
greedy output equal to an uninterrupted run.

Sync core: `Fleet` (submit/step_all/run). Async shell: `FleetServer`
(per-replica stepping tasks + `TokenStream` async iterators), fronted
over the wire by `HttpFrontend` (HTTP/SSE, `/metrics`, `/healthz`).

Cross-process tier: `ProcessFleet` supervises replica WORKER PROCESSES
(worker.py) over a framed mailbox in a `torch.distributed.TCPStore`
(transport.py) — process-isolated failure domains, restart from
heartbeat-shipped snapshots, rolling restarts, and the prefill-to-decode
KV hand-off between a prefill-role and a decode-role worker. The port
has no persistent compile cache: a successor rebuilds nothing but its
model.
"""
from .errors import (NoHealthyReplica, ReplicaCrashed, SloUnattainable,
                     TenantThrottled)
from .fleet import Fleet, FleetHandle
from .http import HttpFrontend
from .procfleet import ProcessFleet, WorkerProc, WorkerState
from .replica import Replica, ReplicaState
from .router import (PrefixAffinityRouter, RandomRouter, RoundRobinRouter,
                     Router, role_candidates)
from .server import FleetServer, TokenStream
from .transport import Channel, TransportError

__all__ = ["Fleet", "FleetHandle", "FleetServer", "TokenStream",
           "Replica", "ReplicaState", "Router", "PrefixAffinityRouter",
           "RandomRouter", "RoundRobinRouter", "role_candidates",
           "NoHealthyReplica", "TenantThrottled", "SloUnattainable",
           "ReplicaCrashed", "HttpFrontend", "ProcessFleet", "WorkerProc",
           "WorkerState", "Channel", "TransportError"]
