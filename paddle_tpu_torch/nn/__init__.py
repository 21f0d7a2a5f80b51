from . import functional, quant
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "quant", "Linear", "Embedding", "RMSNorm"]
