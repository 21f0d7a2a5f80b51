from .activation import swiglu
from .flash_attention import sdpa_ref
from .norm import rms_norm

__all__ = ["rms_norm", "swiglu", "sdpa_ref"]
