from .optimizer import AdamW, Optimizer

__all__ = ["Optimizer", "AdamW"]
