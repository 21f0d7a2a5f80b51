from . import functional, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "quant", "Linear", "Embedding", "RMSNorm",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]
