"""The jit surface of the ported slices (paddle_tpu/jit/api.py).

Only ``InputSpec`` so far: the deploy artifact (inference/__init__.py)
takes one a program input. ``jit.save`` and ``to_static`` belong to the
compile tier (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    """A program input's shape, dtype and name (paddle_tpu/jit/api.py:
    194-201; reference: paddle.static.InputSpec). A ``None`` dim is
    dynamic."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient
