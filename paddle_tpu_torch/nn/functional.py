"""Functional ops of the ported slice (paddle_tpu/nn/functional)."""
from __future__ import annotations

from ..ops.kernels import rms_norm as _rms

__all__ = ["rms_norm", "linear", "embedding"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis, routed to the CUDA kernel for a CUDA
    tensor (nn/functional/__init__.py:683-693)."""
    return _rms.rms_norm(x, weight, epsilon)


def linear(x, weight):
    """y = x W with the reference's [in, out] weight layout (bias-free)."""
    return x @ weight


def embedding(ids, weight):
    """Rows of ``weight`` at integer ``ids``."""
    return weight[ids]
