"""Typed failure surface of the serving engine (port of
`paddle_tpu/serving/errors.py`).

* `EngineOverloaded` — admission control shed the request (bounded
  queue); retry-after semantics belong to the caller.
* `TransientDeviceError` — a device error the supervisor believes is
  retryable. Raised by fault injection; callers normally never see it
  because the supervisor retries it away.
* `PoisonedComputation` — a deterministic numeric failure (NaN/Inf)
  attributed to specific request(s); subclasses FloatingPointError so
  the supervisor's classifier sorts it as poison.
* `UnsupportedFeature` — a constructor argument for a feature this
  build refuses. Subclasses ValueError.
* `EngineFailure` — the engine hit an unrecoverable error and refuses
  further work. The port has no snapshot/resume yet, so `snapshot` is
  always None.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["EngineOverloaded", "TransientDeviceError",
           "PoisonedComputation", "EngineFailure", "UnsupportedFeature"]


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded waiting queue is full."""

    def __init__(self, msg: str, queue_depth: int = 0,
                 max_queue_len: int = 0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_queue_len = max_queue_len


class TransientDeviceError(RuntimeError):
    """A retryable device failure."""


class PoisonedComputation(FloatingPointError):
    """NaN/Inf attributed to a specific computation; `request_ids`
    carries the quarantine targets when the engine can attribute it."""

    def __init__(self, msg: str, request_ids=()):
        super().__init__(msg)
        self.request_ids = tuple(request_ids)


class UnsupportedFeature(ValueError):
    """A feature this build refuses. `features` names what was asked
    for, so callers can branch on WHAT was refused."""

    def __init__(self, msg: str, features=()):
        super().__init__(msg)
        self.features = tuple(sorted(features))


class EngineFailure(RuntimeError):
    """Unrecoverable engine error. `snapshot` is reserved for the
    drain state a later port of snapshot/resume fills; it is None."""

    def __init__(self, msg: str, snapshot: Optional[dict] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.snapshot = snapshot
        self.cause = cause
