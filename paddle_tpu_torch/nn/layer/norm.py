"""RMSNorm layer (paddle_tpu/nn/layer/norm.py:45-60)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """Routed to the CUDA RMSNorm kernel for CUDA tensors
    (ops/kernels/rms_norm.py); the weight starts at ones and is trained
    (the gradient is ops/kernels/rms_norm.py::_rms_norm_bwd)."""

    def __init__(self, normalized_shape, epsilon=1e-6, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(list(normalized_shape), device=device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
