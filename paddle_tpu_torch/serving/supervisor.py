"""Step supervisor: failure classification + retry policy for engine
launches (port of `paddle_tpu/serving/supervisor.py`).

Every launch is treated as fallible and failures sort into three bins:

* **transient** — the typed `TransientDeviceError` (what the fault
  harness raises) and CUDA errors that say the device is momentarily
  busy or unavailable. Retried in place with capped exponential
  backoff; launches are idempotent (a chunk or decode step rewrites the
  same K/V at the same positions, and the engine draws each launch's
  random numbers BEFORE the supervised call), so a retry replays
  bit-identically.
* **poison** — deterministic numeric failure (FloatingPointError, incl.
  the typed `PoisonedComputation`). Retrying cannot help; the engine
  quarantines the offending request(s) and keeps the rest alive.
* **fatal** — everything else: device out-of-memory (re-launching the
  same work re-OOMs), an illegal address or any other sticky CUDA error
  (the context is unusable afterwards), exhausted retries.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from .errors import PoisonedComputation, TransientDeviceError

__all__ = ["classify_failure", "RetryPolicy", "StepSupervisor",
           "TRANSIENT", "POISON", "FATAL"]

TRANSIENT = "transient"
POISON = "poison"
FATAL = "fatal"

# Message markers of retryable CUDA failures: the runtime's text for
# cudaErrorDevicesUnavailable / cudaErrorNotReady. Out-of-memory is
# deliberately NOT here — the identical launch re-OOMs deterministically.
_TRANSIENT_MARKERS = ("busy or unavailable", "cudaErrorDevicesUnavailable",
                      "cudaErrorNotReady", "device not ready")


def classify_failure(exc: BaseException) -> str:
    """Sort an exception from an engine launch into transient / poison /
    fatal. An exception carrying its own `failure_class` attribute that
    names one of the three bins is believed verbatim."""
    own = getattr(exc, "failure_class", None)
    if own in (TRANSIENT, POISON, FATAL):
        return own
    if isinstance(exc, (PoisonedComputation, FloatingPointError)):
        return POISON
    if isinstance(exc, TransientDeviceError):
        return TRANSIENT
    msg = str(exc)
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return FATAL


class RetryPolicy:
    """Capped exponential backoff: delays base, base*factor, ... capped
    at `cap_s`, at most `max_retries` re-launches. `sleep` is injectable
    so tests never wall-clock-wait."""

    def __init__(self, max_retries: int = 3, base_s: float = 0.05,
                 factor: float = 2.0, cap_s: float = 2.0,
                 sleep: Optional[Callable[[float], None]] = None):
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.cap_s = float(cap_s)
        self.sleep = sleep if sleep is not None else time.sleep

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        return min(self.cap_s, self.base_s * (self.factor ** (attempt - 1)))


class StepSupervisor:
    """Wraps engine launches; owns the retry loop and counters.

    `run(launch)` returns the launch's result, retrying transients per
    the policy. Poison and fatal failures propagate to the engine (which
    quarantines or fails — those decisions need request context the
    supervisor does not have). `on_retry` is the metrics hook."""

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 on_retry: Optional[Callable[[str, int], None]] = None):
        self.policy = policy or RetryPolicy()
        self.on_retry = on_retry
        self.num_retries = 0
        self.last_error: Optional[BaseException] = None

    def run(self, launch: Callable, *, label: str = "step"):
        attempt = 0
        while True:
            try:
                return launch()
            except Exception as exc:                # noqa: BLE001
                self.last_error = exc
                if classify_failure(exc) != TRANSIENT \
                        or attempt >= self.policy.max_retries:
                    raise
                attempt += 1
                self.num_retries += 1
                if self.on_retry is not None:
                    self.on_retry(label, attempt)
                self.policy.sleep(self.policy.delay_s(attempt))
