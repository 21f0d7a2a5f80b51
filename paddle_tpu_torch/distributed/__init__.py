"""Distributed training utilities (port of `paddle_tpu/distributed/`, as
far as `fleet.utils.recompute`)."""
from . import fleet

__all__ = ["fleet"]
