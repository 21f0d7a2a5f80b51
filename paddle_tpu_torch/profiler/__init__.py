"""Observability helpers of the port: the Prometheus exposition."""
from .exposition import (metric_name, parse_exposition_names, percentile,
                         prometheus_lines, render_prometheus,
                         sanitize_label_value, sanitize_metric_name)

__all__ = ["render_prometheus", "prometheus_lines", "metric_name",
           "sanitize_metric_name", "sanitize_label_value",
           "parse_exposition_names", "percentile"]
