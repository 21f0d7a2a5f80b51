"""Engine step flight recorder (port of `FlightRecorder` from
`paddle_tpu/serving/trace.py`; per-request tracing is not ported)."""
from __future__ import annotations

from collections import deque
from typing import List

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of per-iteration engine step records.

    A record is one JSON-safe dict per NON-IDLE engine step (recording
    idle polling steps would let a quiet loop evict the history that
    matters). `records()` returns oldest-first.
    """

    __slots__ = ("_ring", "num_recorded")

    def __init__(self, max_steps: int = 128):
        self._ring: deque = deque(maxlen=int(max_steps))
        self.num_recorded = 0

    @property
    def maxlen(self) -> int:
        return self._ring.maxlen

    def record(self, rec: dict):
        self._ring.append(rec)
        self.num_recorded += 1

    def records(self) -> List[dict]:
        return [dict(r) for r in self._ring]

    def __len__(self):
        return len(self._ring)
