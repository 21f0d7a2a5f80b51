from .generation import jit_generate
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_3_8b,
                    llama_tiny)
from .qwen2_moe import (Qwen2MoeConfig, Qwen2MoeForCausalLM, qwen2_moe_a14b,
                        qwen2_moe_tiny)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_3_8b", "jit_generate", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "qwen2_moe_tiny", "qwen2_moe_a14b"]
