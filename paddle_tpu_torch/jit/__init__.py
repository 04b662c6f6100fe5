"""The jit surface of the ported slices (paddle_tpu/jit)."""
from .api import InputSpec, TrainStep

__all__ = ["InputSpec", "TrainStep"]
