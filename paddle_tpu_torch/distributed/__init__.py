"""Distributed training of the ported slices (paddle_tpu/distributed)."""
from . import fleet, resilience

__all__ = ["fleet", "resilience"]
