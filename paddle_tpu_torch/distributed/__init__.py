"""Distributed training of the ported slices (paddle_tpu/distributed)."""
from . import fleet

__all__ = ["fleet"]
