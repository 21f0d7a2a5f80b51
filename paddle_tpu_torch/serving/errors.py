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
* `EngineFailure` — the engine hit an unrecoverable error and drained
  to `snapshot` (JSON-safe); a fresh engine resumes from it via
  `ServingEngine.from_snapshot`.
* `SnapshotVersionError` — a snapshot's schema `version` stamp does not
  match what this build writes: resuming it must fail loud.
* `UnsupportedFeature` — a constructor argument for a feature this
  build refuses: a feature not ported yet, or a feature COMBINATION the
  capability table `FEATURE_CONFLICTS` refuses (the reference's table,
  row for row, reasons included). Subclasses ValueError.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["EngineOverloaded", "TransientDeviceError",
           "PoisonedComputation", "EngineFailure",
           "SnapshotVersionError", "UnsupportedFeature",
           "FEATURE_CONFLICTS", "check_feature_conflicts"]


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


class SnapshotVersionError(ValueError):
    """Snapshot schema mismatch: refuse to resume it. `found` /
    `expected` carry the version stamps."""

    def __init__(self, msg: str, found=None, expected=None):
        super().__init__(msg)
        self.found = found
        self.expected = expected


class UnsupportedFeature(ValueError):
    """A feature this build refuses. `features` names what was asked
    for, so callers can branch on WHAT was refused."""

    def __init__(self, msg: str, features=()):
        super().__init__(msg)
        self.features = tuple(sorted(features))


# The capability table: every pairwise feature conflict the engine
# refuses, as {frozenset({feature_a, feature_b}): reason}. Feature names
# are the vocabulary `ServingEngine.__init__` derives from its kwargs:
#
#   proposer          speculative decoding (serving.spec)
#   multi_step_decode decode_steps > 1
#   lora              multi-LoRA adapter serving
#   tensor_parallel   mesh with model-axis degree > 1
#   host_spill        host_spill_pages > 0
#   no_prefix_cache   enable_prefix_cache=False
#   prefill_role      role="prefill"
#
# Every feature named here is live in the port, and every reason is the
# reference's string, so callers match on the same text.
FEATURE_CONFLICTS = {
    frozenset({"multi_step_decode", "proposer"}):
        "decode_steps > 1 and a proposer are mutually exclusive: "
        "speculative verify and plain multi-step decode both multiply "
        "tokens per launch — pick one per engine",
    frozenset({"lora", "proposer"}):
        "lora and a proposer are mutually exclusive: the verify "
        "program has no adapter path (pick one per engine)",
    frozenset({"lora", "tensor_parallel"}):
        "lora under tensor parallelism is not supported yet: the "
        "adapter pools/stacks carry no sharding specs (run lora "
        "engines at tp=1)",
    frozenset({"host_spill", "tensor_parallel"}):
        "host spill under tensor parallelism is not supported yet: "
        "page gathers would fetch every shard through the host (run "
        "spill engines at tp=1)",
    frozenset({"host_spill", "no_prefix_cache"}):
        "host_spill_pages needs the radix cache: the spill tier lives "
        "UNDER it (enable_prefix_cache=True)",
    frozenset({"prefill_role", "proposer"}):
        "a prefill-role engine and a proposer are mutually exclusive: "
        "speculative decoding only pays on the decode side, which a "
        "prefill-role engine hands off before reaching",
    frozenset({"prefill_role", "multi_step_decode"}):
        "a prefill-role engine and decode_steps > 1 are mutually "
        "exclusive: multi-step decode only pays on the decode side, "
        "which a prefill-role engine hands off before reaching",
    frozenset({"prefill_role", "no_prefix_cache"}):
        "a prefill-role engine needs the radix cache: handoff ships "
        "the prefilled KV out of the donated radix prefix "
        "(enable_prefix_cache=True)",
}


def check_feature_conflicts(active) -> None:
    """Raise `UnsupportedFeature` for the first capability-table row
    fully contained in `active` (a set of feature names). Rows are
    checked in a fixed order, so the same kwargs always give the same
    refusal."""
    active = frozenset(active)
    for pair in sorted(FEATURE_CONFLICTS, key=sorted):
        if pair <= active:
            raise UnsupportedFeature(FEATURE_CONFLICTS[pair],
                                     features=pair)


class EngineFailure(RuntimeError):
    """Unrecoverable engine error. `snapshot` is the serializable
    drain state (queued + preempted + in-flight requests)."""

    def __init__(self, msg: str, snapshot: Optional[dict] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.snapshot = snapshot
        self.cause = cause
