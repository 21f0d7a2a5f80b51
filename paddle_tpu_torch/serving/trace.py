"""Per-request tracing and the engine flight recorder (port of
`paddle_tpu/serving/trace.py`).

* `RequestTracer` / `RequestTrace` — one trace per request, from
  admission through queue wait, prefill chunks, decode / multi-step
  decode / verify launches, supervisor retries, quarantine, preemption
  and snapshot adoption. Spans and marks are stamped in nanoseconds on
  `time.perf_counter_ns` (or the `clock_ns` given). `export()` writes
  one chrome-trace JSON document (`{"traceEvents": ...}`) that Perfetto
  opens: one row per request id under `REQUEST_PID`. Completed traces
  live in a bounded ring, so a long-lived server does not keep one
  entry per request ever served.

  Free when off: the engine holds `tracer=None` by default and every
  call site is guarded by that one check, so the default hot path
  allocates nothing trace-related. Several engines may share one tracer
  (pass the same instance), so a request adopted from a snapshot keeps
  one trace.

  The reference also merges its own profiler's host spans into the
  export; the port has no host-span recorder of its own, so its export
  holds the request rows (and, when given, the flight recorder) only.

* `FlightRecorder` — a bounded ring of per-iteration step records
  (launches with bucket keys, batch composition, tokens in/out, pool
  occupancy, spec and retry counts, step wall time). Always on, read
  through `ServingEngine.timeline()`, and carried by every engine
  snapshot.

Every payload is JSON-safe by construction (plain ints / floats / strs,
lists and dicts of them).
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["RequestTrace", "RequestTracer", "FlightRecorder",
           "REQUEST_PID"]

# chrome-trace pid of the per-request rows
REQUEST_PID = 1


def _json_safe(v):
    """Coerce span/mark args to JSON-safe plain types (numpy and torch
    scalars from token ids are the common offenders)."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    # numpy / torch scalars (and 0-d arrays): .item() keeps the value's
    # kind — int(np.float32(0.37)) would truncate to 0
    item = getattr(v, "item", None)
    if item is not None:
        try:
            unwrapped = item()
        except (TypeError, ValueError, RuntimeError):
            unwrapped = None
        if isinstance(unwrapped, (bool, int, float, str)):
            return unwrapped
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)


class RequestTrace:
    """One request's lifecycle: spans (named intervals) and marks (named
    instants), in clock nanoseconds."""

    __slots__ = ("request_id", "meta", "spans", "marks", "t_begin",
                 "t_end", "t_queue", "finish_reason")

    def __init__(self, request_id: int, t_begin: int, **meta):
        self.request_id = int(request_id)
        self.meta = {k: _json_safe(v) for k, v in meta.items()}
        self.spans: List[dict] = []
        self.marks: List[dict] = []
        self.t_begin = int(t_begin)
        self.t_end: Optional[int] = None
        # queue-wait anchor: reset at preemption and adoption, so the
        # next admission's queue_wait span measures that wait only
        self.t_queue = int(t_begin)
        self.finish_reason: Optional[str] = None

    def span(self, name: str, t0: int, t1: int, **args):
        self.spans.append({"name": name, "t0": int(t0), "t1": int(t1),
                           "args": {k: _json_safe(v)
                                    for k, v in args.items()}})

    def mark(self, name: str, t: int, **args):
        self.marks.append({"name": name, "t": int(t),
                           "args": {k: _json_safe(v)
                                    for k, v in args.items()}})

    # ---- views -----------------------------------------------------------
    def span_names(self) -> List[str]:
        return [s["name"] for s in self.spans]

    def count_spans(self, name: str) -> int:
        return sum(1 for s in self.spans if s["name"] == name)

    def mark_names(self) -> List[str]:
        return [m["name"] for m in self.marks]

    def duration_ns(self) -> Optional[int]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_begin

    def to_dict(self) -> dict:
        return {"request_id": self.request_id, "meta": dict(self.meta),
                "t_begin": self.t_begin, "t_end": self.t_end,
                "finish_reason": self.finish_reason,
                "spans": [dict(s) for s in self.spans],
                "marks": [dict(m) for m in self.marks]}

    def __repr__(self):
        state = self.finish_reason if self.finish_reason else "live"
        return (f"RequestTrace({self.request_id}, {state}, "
                f"spans={len(self.spans)}, marks={len(self.marks)})")


class RequestTracer:
    """Registry of live and completed request traces. `clock_ns`
    (default `time.perf_counter_ns`) is injectable for deterministic
    tests. Every method is a no-op for unknown request ids, so call
    sites need no existence checks."""

    def __init__(self, max_completed: int = 512, clock_ns=None):
        self._clock_ns = (clock_ns if clock_ns is not None
                          else time.perf_counter_ns)
        self.live: Dict[int, RequestTrace] = {}
        self.completed: deque = deque(maxlen=int(max_completed))
        self.num_started = 0
        self.num_completed = 0

    def now_ns(self) -> int:
        return int(self._clock_ns())

    # ---- lifecycle -------------------------------------------------------
    def begin(self, request_id: int, **meta) -> RequestTrace:
        """Start (or return the live) trace of `request_id`; idempotent,
        so a request adopted by a second engine sharing this tracer
        keeps accumulating into one trace."""
        tr = self.live.get(request_id)
        if tr is None:
            tr = RequestTrace(request_id, self.now_ns(), **meta)
            self.live[request_id] = tr
            self.num_started += 1
        return tr

    def get(self, request_id: int) -> Optional[RequestTrace]:
        return self.live.get(request_id)

    def span(self, request_id: int, name: str, t0: int, t1: int, **args):
        tr = self.live.get(request_id)
        if tr is not None:
            tr.span(name, t0, t1, **args)

    def span_many(self, request_ids, name: str, t0: int, t1: int,
                  **args):
        """One span on every given request — the batched-launch path.
        The args are the same across the batch, so they are sanitized
        once and the record is shared (nothing mutates stored spans;
        the export copies before annotating)."""
        rec = {"name": name, "t0": int(t0), "t1": int(t1),
               "args": {k: _json_safe(v) for k, v in args.items()}}
        live = self.live
        for rid in request_ids:
            tr = live.get(rid)
            if tr is not None:
                tr.spans.append(rec)

    def mark(self, request_id: int, name: str, **args):
        tr = self.live.get(request_id)
        if tr is not None:
            tr.mark(name, self.now_ns(), **args)

    def finish(self, request_id: int, reason: str):
        """Move a live trace to the bounded completed ring (idempotent)."""
        tr = self.live.pop(request_id, None)
        if tr is None:
            return
        tr.t_end = self.now_ns()
        tr.finish_reason = str(reason)
        self.completed.append(tr)
        self.num_completed += 1

    # ---- views -----------------------------------------------------------
    def traces(self, include_live: bool = True) -> List[RequestTrace]:
        out = list(self.completed)
        if include_live:
            out.extend(self.live.values())
        return out

    # ---- export ----------------------------------------------------------
    def chrome_events(self) -> List[dict]:
        """Request lifecycle rows as chrome-trace events (ts/dur in
        microseconds, one tid per request id under REQUEST_PID)."""
        events = [{"name": "process_name", "ph": "M", "pid": REQUEST_PID,
                   "args": {"name": "serving requests"}}]
        for tr in self.traces():
            events.append({"name": "thread_name", "ph": "M",
                           "pid": REQUEST_PID, "tid": tr.request_id,
                           "args": {"name": f"req {tr.request_id}"}})
            for s in tr.spans:
                events.append({"name": s["name"], "ph": "X",
                               "cat": "request", "ts": s["t0"] / 1e3,
                               "dur": max(0.0, (s["t1"] - s["t0"]) / 1e3),
                               "pid": REQUEST_PID, "tid": tr.request_id,
                               "args": dict(s["args"],
                                            request_id=tr.request_id)})
            for m in tr.marks:
                events.append({"name": m["name"], "ph": "i", "s": "t",
                               "cat": "request", "ts": m["t"] / 1e3,
                               "pid": REQUEST_PID, "tid": tr.request_id,
                               "args": dict(m["args"],
                                            request_id=tr.request_id)})
        return events

    def export(self, path: Optional[str] = None,
               flight_recorder=None) -> dict:
        """One chrome-trace document of the request rows.
        `flight_recorder` (a FlightRecorder or a plain record list) rides
        along under its own key. Writes JSON to `path` when given;
        returns the document either way."""
        doc = {"displayTimeUnit": "ms", "traceEvents": self.chrome_events(),
               "requestTraces": [tr.to_dict() for tr in self.traces()]}
        if flight_recorder is not None:
            recs = (flight_recorder.records()
                    if hasattr(flight_recorder, "records")
                    else list(flight_recorder))
            doc["flightRecorder"] = recs
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


class FlightRecorder:
    """Bounded ring of per-iteration engine step records.

    A record is one JSON-safe dict per NON-IDLE engine step (recording
    idle polling steps would let a quiet loop evict the history that
    matters). `records()` returns oldest-first; every engine snapshot
    carries exactly this list.
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
