"""Activation layers (paddle_tpu/nn/layer/activation.py:15-31): each a
Layer calling its functional op with the arguments it was made with. Only
the activations whose functional op the port has are here (ROADMAP.md,
queue 1, item 10 lists the others)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "GELU", "Tanh"]


def _act_layer(name, fname, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return getattr(F, fname)(x, *self._args, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", "relu")
GELU = _act_layer("GELU", "gelu")
Tanh = _act_layer("Tanh", "tanh")
