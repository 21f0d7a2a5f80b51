"""Named fault-injection points for resilience testing (the port's own
copy of `paddle_tpu/utils/faults.py`).

Code declares *injection points* — `faults.register_point(name)` at
import, `faults.fire(name)` at the site. A test *arms* a point with
`faults.inject(name, ...)`; an armed point either raises a chosen
exception or hands a payload back to the site. Disarmed, `fire` is a
single module-flag check, so production code pays nothing.

Design rules (they keep fault runs deterministic):

* Triggers are counted/seeded, never wall-clock: `after` skips the
  first k hits, `times` bounds how often the spec fires, `prob` draws
  from the spec's own `random.Random(seed)` stream.
* `fire` consumes specs in arm order; every actual firing is counted in
  `fired_counts()` so a run can assert its faults really landed.
* `injected(...)` is the context-manager form tests use; it disarms on
  exit even when the body raises.

Points registered by the port: `serving.kv.alloc_page`,
`serving.radix.insert`, `serving.engine.prefill_chunk`,
`serving.engine.decode_step`, `serving.engine.multi_decode_step`,
`serving.engine.verify_step`, `serving.engine.nan_logits`,
`serving.engine.deadline_storm`, `serving.spec.draft_storm`,
`serving.lora.load_fail`, `serving.lora.evict_race`, the fleet's
(`fleet.replica_crash`, `fleet.route_race`, `fleet.stream_stall`,
`fleet.handoff_stall`, `fleet.handoff_partial`, `fleet.decode_reject`,
`worker.kill9`), the transport's (`transport.drop`,
`transport.duplicate`, `transport.stall`) and the host spill tier's
(`host_spill.corrupt`, `host_spill.slow`, `host_spill.lost`).
"""
from __future__ import annotations

import random
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["register_point", "points", "inject", "injected", "clear",
           "fire", "fired_counts", "reset_counts", "active", "FaultSpec"]

_POINTS: set = set()
_SPECS: Dict[str, List["FaultSpec"]] = {}
_FIRED: Dict[str, int] = {}
_ARMED = False          # fast-path flag: fire() is one check when clear


class FaultSpec:
    """One armed fault: what happens (`exc` to raise, or `payload` to
    hand the site) and when (`after` skipped hits, then up to `times`
    firings, each gated by `prob` on the spec's seeded stream)."""

    __slots__ = ("exc", "payload", "times", "after", "prob", "_rng",
                 "hits", "fired")

    def __init__(self, exc: Optional[BaseException] = None,
                 payload: Any = None, times: int = 1, after: int = 0,
                 prob: Optional[float] = None, seed: int = 0):
        if exc is not None and payload is not None:
            raise ValueError("a FaultSpec raises OR yields a payload")
        self.exc = exc
        self.payload = payload
        self.times = int(times)
        self.after = int(after)
        self.prob = prob
        self._rng = random.Random(seed)
        self.hits = 0
        self.fired = 0

    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times

    def should_fire(self) -> bool:
        """Advance this spec's trigger state by one site hit."""
        if self.exhausted():
            return False
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


def register_point(name: str) -> str:
    """Declare an injection point (idempotent; import-time)."""
    _POINTS.add(name)
    return name


def points() -> List[str]:
    """Every declared injection point, sorted."""
    return sorted(_POINTS)


def inject(name: str, *, exc: Optional[BaseException] = None,
           payload: Any = None, times: int = 1, after: int = 0,
           prob: Optional[float] = None, seed: int = 0) -> FaultSpec:
    """Arm `name`. Unknown points are an error — a typo'd name would
    otherwise silently never fire. `times=-1` means unbounded."""
    global _ARMED
    if name not in _POINTS:
        raise KeyError(f"unknown fault point {name!r}; registered: "
                       f"{points()}")
    spec = FaultSpec(exc=exc, payload=payload, times=times, after=after,
                     prob=prob, seed=seed)
    _SPECS.setdefault(name, []).append(spec)
    _ARMED = True
    return spec


@contextmanager
def injected(name: str, **kw):
    """Scoped arming for tests: disarms this spec on exit."""
    spec = inject(name, **kw)
    try:
        yield spec
    finally:
        _remove(name, spec)


def _remove(name: str, spec: FaultSpec):
    global _ARMED
    lst = _SPECS.get(name, [])
    if spec in lst:
        lst.remove(spec)
    if not lst:
        _SPECS.pop(name, None)
    _ARMED = bool(_SPECS)


def clear(name: Optional[str] = None):
    """Disarm one point (or all); firing counts survive for assertions
    until cleared with `reset_counts`."""
    global _ARMED
    if name is None:
        _SPECS.clear()
    else:
        _SPECS.pop(name, None)
    _ARMED = bool(_SPECS)


def reset_counts():
    _FIRED.clear()


def fired_counts() -> Dict[str, int]:
    """{point: times it actually fired} since the last reset_counts."""
    return dict(_FIRED)


def active() -> Dict[str, int]:
    """{point: number of live (non-exhausted) specs}."""
    return {k: sum(1 for s in v if not s.exhausted())
            for k, v in _SPECS.items() if v}


def fire(name: str, default: Any = None) -> Any:
    """Injection site. Raises the armed exception, or returns the armed
    payload, or `default` when nothing fires."""
    if not _ARMED:
        return default
    specs = _SPECS.get(name)
    if not specs:
        return default
    for spec in specs:
        if spec.should_fire():
            _FIRED[name] = _FIRED.get(name, 0) + 1
            if spec.exc is not None:
                raise spec.exc
            return spec.payload
    return default
