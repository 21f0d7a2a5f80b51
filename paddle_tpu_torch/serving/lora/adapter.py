"""LoRA adapter objects and the typed error family (port of
`paddle_tpu/serving/lora/adapter.py`; pure numpy, copied).

An adapter is host-side data: per-target-module (A, B) low-rank factors
plus the alpha/rank scaling. Device placement, paging and slot
assignment belong to `store.AdapterRegistry`: an adapter object can be
loaded into any registry whose layout its shapes fit. `random` seeds
numpy's `RandomState` as the reference does, so both build the same
adapter from the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["LoRAAdapter", "AdapterError", "AdapterNotLoaded",
           "AdapterLoadError", "AdapterBusy"]


class AdapterError(RuntimeError):
    """Base of the typed adapter failures (all carry .adapter)."""

    def __init__(self, msg, adapter: Optional[str] = None, **kw):
        super().__init__(msg)
        self.adapter = adapter
        for k, v in kw.items():
            setattr(self, k, v)


class AdapterNotLoaded(AdapterError):
    """A request named an adapter this engine's registry does not
    currently hold: shed typed at the door, never served with the wrong
    (or no) adapter."""


class AdapterLoadError(AdapterError):
    """Loading failed: pool exhausted with nothing evictable, shape
    mismatch against the registry layout, or the injected
    `serving.lora.load_fail` fault."""


class AdapterBusy(AdapterError):
    """Unload refused: the adapter still has live request refs. Eviction
    only ever takes idle adapters, so a request in flight never loses
    its weights."""


class LoRAAdapter:
    """One named adapter: {module: (A (in, r), B (r, out))} fp32 arrays
    and the LoRA scaling alpha / r (applied once per delta)."""

    def __init__(self, name: str, rank: int,
                 weights: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 alpha: Optional[float] = None):
        self.name = str(name)
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError("rank must be >= 1")
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.weights = {}
        for mod, (a, b) in weights.items():
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != self.rank \
                    or b.shape[0] != self.rank:
                raise ValueError(
                    f"adapter {name!r} module {mod!r}: A {a.shape} / "
                    f"B {b.shape} do not factor through rank {rank}")
            self.weights[mod] = (a, b)
        if not self.weights:
            raise ValueError("adapter has no target modules")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def random(cls, name: str, rank: int, dims: Dict[str, Tuple[int, int]],
               seed: int = 0, scale: float = 0.02,
               alpha: Optional[float] = None) -> "LoRAAdapter":
        """Test/benchmark helper: gaussian A and gaussian, NON-zero B (a
        freshly trained adapter has B = 0 and would serve the base
        model's tokens)."""
        rng = np.random.RandomState(seed)
        w = {m: (rng.randn(di, rank).astype(np.float32) * scale,
                 rng.randn(rank, do).astype(np.float32) * scale)
             for m, (di, do) in dims.items()}
        return cls(name, rank, w, alpha=alpha)

    def __repr__(self):
        return (f"LoRAAdapter({self.name!r}, r={self.rank}, "
                f"modules={sorted(self.weights)})")
