"""Serving stack of the port: engine, scheduler, paged KV bookkeeping,
multi-LoRA adapters."""
from .engine import ServingEngine
from .errors import (EngineFailure, EngineOverloaded, PoisonedComputation,
                     TransientDeviceError, UnsupportedFeature)
from .kv_cache import PAD_PAGE, BlockAllocator, BlocksExhausted, KVSequence
from .lora import (AdapterBusy, AdapterError, AdapterLoadError,
                   AdapterNotLoaded, AdapterRegistry, LoRAAdapter,
                   LoRALayout)
from .radix_cache import RadixCache
from .scheduler import Request, RequestState, Scheduler
from .supervisor import RetryPolicy, StepSupervisor, classify_failure

__all__ = ["ServingEngine", "EngineFailure", "EngineOverloaded",
           "PoisonedComputation", "TransientDeviceError",
           "UnsupportedFeature", "PAD_PAGE", "BlockAllocator",
           "BlocksExhausted", "KVSequence", "RadixCache", "Request",
           "RequestState", "Scheduler", "RetryPolicy", "StepSupervisor",
           "classify_failure", "LoRAAdapter", "AdapterRegistry",
           "LoRALayout", "AdapterError", "AdapterNotLoaded",
           "AdapterLoadError", "AdapterBusy"]
