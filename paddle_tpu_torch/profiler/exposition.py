"""Prometheus-style text exposition of snapshot dicts (port of
`paddle_tpu/profiler/exposition.py`, which imports no JAX; the port keeps
its own copy).

The renderer walks a LIVE `snapshot()` dict, so the exposition cannot
disagree with the snapshot: every key surfaces, nothing is filtered by
name, and a new counter, gauge or reservoir appears in the scrape as
soon as it appears in the snapshot.

Rendering rules (one rule per VALUE type, never per key):

* numeric (int/float/bool) — `<prefix>_<key>{labels} <value>`, typed
  `counter` when the key lives in the metrics object's counters dict,
  `gauge` otherwise;
* string (e.g. `kv_dtype`) — an info-style gauge
  `<prefix>_<key>_info{<key>="<value>",labels} 1` (the textual value
  becomes a label, Prometheus has no string samples);
* dict (e.g. a fleet summary's `replica_states`) — one line per entry
  with the entry key as a label;
* None — omitted (a percentile with no samples has no honest value).

`Fleet.prometheus_text()` layers per-replica labels on top, and
`FleetServer.metrics_text()` is the body the HTTP front door serves at
`/metrics`.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

__all__ = ["render_prometheus", "prometheus_lines", "metric_name",
           "sanitize_metric_name", "sanitize_label_value",
           "parse_exposition_names", "percentile"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
# a sample line: name{optional labels} value
_SAMPLE_RE = re.compile(r"^([a-zA-Z_][a-zA-Z0-9_]*)(\{[^}]*\})? \S+$")


def percentile(samples, q):
    """Nearest-rank percentile over a small window (no numpy needed).
    Returns None on an empty window."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def sanitize_metric_name(key: str) -> str:
    name = _NAME_BAD.sub("_", str(key))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label_value(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def metric_name(prefix: str, key: str) -> str:
    return f"{sanitize_metric_name(prefix)}_{sanitize_metric_name(key)}"


def _label_str(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize_metric_name(k)}="'
                     f'{sanitize_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_lines(snapshot: dict, *, counter_keys: Iterable[str] = (),
                     prefix: str = "paddle_serving",
                     labels: Optional[Dict[str, str]] = None,
                     emit_type: bool = True) -> List[str]:
    """Render one snapshot dict to exposition lines (no trailing
    newline). `counter_keys` marks which keys get `# TYPE ... counter`;
    everything else is a gauge. Set `emit_type=False` for a secondary
    rendering of the same metrics (e.g. per-replica lines after the
    merged block) — Prometheus allows one TYPE line per metric name."""
    counter_keys = set(counter_keys)
    lines: List[str] = []
    for key, value in snapshot.items():
        if value is None:
            continue
        name = metric_name(prefix, key)
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            typ = "counter" if key in counter_keys else "gauge"
            if emit_type:
                lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name}{_label_str(labels)} {value}")
        elif isinstance(value, str):
            name += "_info"
            if emit_type:
                lines.append(f"# TYPE {name} gauge")
            info = dict(labels or {})
            info[sanitize_metric_name(key)] = value
            lines.append(f"{name}{_label_str(info)} 1")
        elif isinstance(value, dict):
            if emit_type:
                lines.append(f"# TYPE {name} gauge")
            for sub, sv in value.items():
                ls = dict(labels or {})
                ls[sanitize_metric_name(key).rstrip("s") or key] = sub
                if isinstance(sv, (int, float)) and \
                        not isinstance(sv, bool):
                    lines.append(f"{name}{_label_str(ls)} {sv}")
                else:
                    ls["value"] = str(sv)
                    lines.append(f"{name}{_label_str(ls)} 1")
        else:
            # unknown value type: surface it as an info label rather
            # than silently dropping a snapshot key
            name += "_info"
            if emit_type:
                lines.append(f"# TYPE {name} gauge")
            info = dict(labels or {})
            info[sanitize_metric_name(key)] = sanitize_label_value(value)
            lines.append(f"{name}{_label_str(info)} 1")
    return lines


def render_prometheus(snapshot: dict, *, counter_keys: Iterable[str] = (),
                      prefix: str = "paddle_serving",
                      labels: Optional[Dict[str, str]] = None) -> str:
    """One snapshot as Prometheus exposition text (trailing newline)."""
    return "\n".join(prometheus_lines(
        snapshot, counter_keys=counter_keys, prefix=prefix,
        labels=labels)) + "\n"


def parse_exposition_names(text: str) -> set:
    """Metric names present in an exposition text (and a format check:
    every non-comment line must parse as `name{labels} value`)."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        names.add(m.group(1))
    return names
