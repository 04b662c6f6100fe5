"""argmax (paddle_tpu/ops/search.py:23)."""
from __future__ import annotations

from ..core.dispatch import apply
from ..core.dtype import convert_dtype

__all__ = ["argmax"]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = convert_dtype(dtype)

    def fn(a):
        if axis is None:
            out = a.reshape(-1).argmax()
            return (out.reshape([1] * a.dim()) if keepdim else out).to(d)
        return a.argmax(dim=int(axis), keepdim=keepdim).to(d)
    return apply(fn, x, op_name="argmax", differentiable=False)
