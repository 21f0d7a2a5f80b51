"""Serving stack of the port: engine, scheduler, paged KV bookkeeping
and its host spill tier, multi-LoRA adapters, speculative decoding,
request tracing, the in-process fleet (routers, failover, the asyncio
server and its HTTP front door) and the cross-process fleet (worker
processes over a TCPStore mailbox, the prefill-to-decode KV
hand-off) and tensor-parallel serving over rank processes
(`tp_serving_mesh`)."""
from .engine import ServingEngine, tp_serving_mesh
from .errors import (EngineFailure, EngineOverloaded, PoisonedComputation,
                     SnapshotVersionError, TransientDeviceError,
                     UnsupportedFeature)
from .fleet import (Channel, Fleet, FleetHandle, FleetServer, HttpFrontend,
                    PrefixAffinityRouter, ProcessFleet, RandomRouter,
                    Replica, ReplicaState, RoundRobinRouter, TokenStream,
                    TransportError, WorkerProc, WorkerState)
from .kv_cache import (PAD_PAGE, BlockAllocator, BlocksExhausted,
                       HostPageStore, KVSequence)
from .metrics import ServingMetrics
from .lora import (AdapterBusy, AdapterError, AdapterLoadError,
                   AdapterNotLoaded, AdapterRegistry, LoRAAdapter,
                   LoRALayout)
from .radix_cache import RadixCache, RadixNode
from .scheduler import (PrefillChunk, Request, RequestState, ScheduleStep,
                        Scheduler)
from .spec import DraftModelProposer, NgramProposer, Proposer
from .supervisor import RetryPolicy, StepSupervisor, classify_failure
from .trace import FlightRecorder, RequestTrace, RequestTracer
from ..profiler.exposition import render_prometheus

__all__ = ["ServingEngine", "EngineFailure", "EngineOverloaded",
           "PoisonedComputation", "TransientDeviceError",
           "SnapshotVersionError", "UnsupportedFeature", "PAD_PAGE",
           "BlockAllocator", "BlocksExhausted", "KVSequence", "RadixCache",
           "Request", "RequestState", "Scheduler", "RetryPolicy",
           "StepSupervisor", "classify_failure", "LoRAAdapter",
           "AdapterRegistry", "LoRALayout", "AdapterError",
           "AdapterNotLoaded", "AdapterLoadError", "AdapterBusy",
           "Proposer", "NgramProposer", "DraftModelProposer",
           "RequestTrace", "RequestTracer", "FlightRecorder",
           "HostPageStore", "RadixNode", "ServingMetrics", "Fleet",
           "FleetHandle", "FleetServer", "TokenStream", "Replica",
           "ReplicaState", "PrefixAffinityRouter", "RandomRouter",
           "RoundRobinRouter", "HttpFrontend", "PrefillChunk",
           "ScheduleStep", "render_prometheus", "ProcessFleet", "WorkerProc",
           "WorkerState", "Channel", "TransportError", "tp_serving_mesh"]
