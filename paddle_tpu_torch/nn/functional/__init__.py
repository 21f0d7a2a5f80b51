# `flash_attention` (the function) stays in its module: bound here, its
# name would hide the submodule `nn.functional.flash_attention`.
from .activation import swiglu
from .extra import flash_attn_qkvpacked, flash_attn_varlen_qkvpacked
from .flash_attention import (flash_attn_unpadded, flashmask_attention,
                              scaled_dot_product_attention, sdp_kernel,
                              sdpa_ref)
from .loss import parallel_cross_entropy
from .norm import rms_norm

__all__ = ["rms_norm", "swiglu", "sdpa_ref", "scaled_dot_product_attention",
           "flash_attn_unpadded", "flashmask_attention", "sdp_kernel",
           "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
           "parallel_cross_entropy"]
