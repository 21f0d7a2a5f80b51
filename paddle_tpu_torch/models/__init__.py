from .generation import jit_generate
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_3_8b,
                    llama_tiny)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_3_8b", "jit_generate"]
