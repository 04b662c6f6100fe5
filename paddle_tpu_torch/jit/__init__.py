"""The jit surface of the ported slices (paddle_tpu/jit)."""
from .api import InputSpec

__all__ = ["InputSpec"]
