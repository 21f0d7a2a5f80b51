"""paddle_tpu_torch.serving.lora — multi-LoRA adapter serving (port of
`paddle_tpu/serving/lora/`).

N fine-tuned variants of one base model in a single ServingEngine:
adapter weights live PAGED in device pools managed with the
BlockAllocator's refcount/free-list discipline (`store.AdapterRegistry`),
every launch gathers the loaded adapters' pages into fixed-shape
per-rank-bucket slot stacks, and the LoRA kernels
(`kernels/lora_matmul.py`) apply each row's OWN adapter delta: rows of
one launch may carry different adapters.

The runtime half (`runtime.py`) threads the launch's adapter context
through the model's projection hooks via a scope; with no scope active
the hooks return the projection output untouched.
"""
from .adapter import (AdapterBusy, AdapterError, AdapterLoadError,
                      AdapterNotLoaded, LoRAAdapter)
from .runtime import apply_lora, current_lora, lora_scope
from .store import AdapterRegistry, LoRALayout, llama_lora_dims

__all__ = ["LoRAAdapter", "AdapterRegistry", "LoRALayout",
           "llama_lora_dims", "AdapterError", "AdapterNotLoaded",
           "AdapterLoadError", "AdapterBusy", "lora_scope", "current_lora",
           "apply_lora"]
