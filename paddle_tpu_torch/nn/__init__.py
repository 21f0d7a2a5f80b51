from . import functional
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "Linear", "Embedding", "RMSNorm"]
