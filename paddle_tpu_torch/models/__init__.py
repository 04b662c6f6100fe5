"""Models of the ported slices (paddle_tpu/models)."""
from . import bert, gpt, llama

__all__ = ["bert", "gpt", "llama"]
