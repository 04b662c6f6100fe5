"""Creation ops (paddle_tpu/ops/creation.py): on the default place unless
told otherwise (``core/place.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from ..core.place import to_torch_device
from ..core.tensor import Tensor, to_torch

__all__ = ["to_tensor", "zeros", "ones", "full", "arange", "zeros_like"]


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new Tensor holding ``data`` on ``place`` (the default place when
    None: a copy of a Tensor or torch tensor lands there too)."""
    t = to_torch(data, dtype, place if place is not None
                 else to_torch_device())
    if isinstance(data, (Tensor, torch.Tensor)):
        t = t.detach().clone()
    return Tensor(t, stop_gradient=stop_gradient)


def zeros(shape, dtype="float32", name=None):
    return Tensor._wrap(torch.zeros(_shape(shape),
                                    dtype=convert_dtype(dtype or "float32"),
                                    device=to_torch_device()))


def ones(shape, dtype="float32", name=None):
    return Tensor._wrap(torch.ones(_shape(shape),
                                   dtype=convert_dtype(dtype or "float32"),
                                   device=to_torch_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor._wrap(torch.full(_shape(shape), fill_value,
                                   dtype=convert_dtype(dtype or "float32"),
                                   device=to_torch_device()))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 when start, end and step are ints, else float32."""
    def conv(v):
        return v.item() if isinstance(v, Tensor) else v
    start, end, step = conv(start), conv(end), conv(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        d = torch.int64 if all(isinstance(v, int) for v in
                               (start, end, step)) else torch.float32
    return Tensor._wrap(torch.arange(start, end, step, dtype=d,
                                     device=to_torch_device()))


def zeros_like(x, dtype=None, name=None):
    """Zeros of x's shape on x's device, of x's dtype unless given."""
    d = convert_dtype(dtype)
    return apply(lambda a: torch.zeros_like(a, dtype=d), x,
                 op_name="zeros_like", differentiable=False)

