"""Models of the ported slices (paddle_tpu/models)."""
from . import llama

__all__ = ["llama"]
