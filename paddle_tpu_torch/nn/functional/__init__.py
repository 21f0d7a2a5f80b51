from .activation import swiglu
from .flash_attention import scaled_dot_product_attention, sdpa_ref
from .loss import parallel_cross_entropy
from .norm import rms_norm

__all__ = ["rms_norm", "swiglu", "sdpa_ref", "scaled_dot_product_attention",
           "parallel_cross_entropy"]
