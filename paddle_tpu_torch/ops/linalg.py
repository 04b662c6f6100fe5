"""matmul (paddle_tpu/ops/linalg.py:27-43)."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from .math import promote

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each optionally transposed in its last two axes; operands of
    two dtypes take their promoted dtype, as jnp.matmul does."""
    def fn(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(*promote(a, b))
    return apply(fn, x, y, op_name="matmul")
