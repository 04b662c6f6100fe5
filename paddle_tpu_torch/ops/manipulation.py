"""Shape and indexing ops (paddle_tpu/ops/manipulation.py): the ones the
eager Llama, GPT and BERT paths and their tests reach; the rest of the op
library is ROADMAP.md's queue 1, item 10."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor, to_torch

__all__ = ["reshape", "concat", "stack", "transpose", "unsqueeze", "repeat_interleave",
           "take_along_axis", "put_along_axis"]


def _ints(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return [int(s.item() if isinstance(s, Tensor) else s) for s in shape]


def reshape(x, shape, name=None):
    """``shape`` may hold one -1 (inferred)."""
    s = _ints(shape)
    return apply(lambda a: a.reshape(s), x, op_name="reshape")


def transpose(x, perm, name=None):
    p = _ints(perm)
    return apply(lambda a: a.permute(*p), x, op_name="transpose")


def unsqueeze(x, axis, name=None):
    """New axes of size 1 at ``axis`` (an int or a list), inserted in
    ascending order (ops/manipulation.py:102-110)."""
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [int(a.item()) if isinstance(a, Tensor) else int(a) for a in axes]

    def fn(a):
        out = a
        for ax in sorted(ax if ax >= 0 else ax + out.dim() + 1
                         for ax in axes):
            out = out.unsqueeze(ax)
        return out
    return apply(fn, x, op_name="unsqueeze")


def concat(x, axis=0, name=None):
    """Inputs of several dtypes take their promoted dtype (JAX's rule)."""
    ax = int(axis.item() if isinstance(axis, Tensor) else axis)

    def fn(*xs):
        d = xs[0].dtype
        for t in xs[1:]:
            d = torch.promote_types(d, t.dtype)
        return torch.cat([t.to(d) for t in xs], dim=ax)
    return apply(fn, *list(x), op_name="concat")


def stack(x, axis=0, name=None):
    """The inputs stacked along a new ``axis`` (promoted dtype, as
    ``concat``)."""
    def fn(*xs):
        d = xs[0].dtype
        for t in xs[1:]:
            d = torch.promote_types(d, t.dtype)
        return torch.stack([t.to(d) for t in xs], dim=int(axis))
    return apply(fn, *list(x), op_name="stack")


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        repeats = repeats._value

    def fn(a):
        if axis is None:
            return torch.repeat_interleave(a.reshape(-1), repeats)
        return torch.repeat_interleave(a, repeats, dim=int(axis))
    return apply(fn, x, op_name="repeat_interleave")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply(lambda a, i: torch.take_along_dim(a, i.long(),
                                                   dim=int(axis)),
                 arr, indices, op_name="take_along_axis")


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    """A copy of ``arr`` with ``values`` (broadcast to the indices' shape)
    written, or reduced, at ``indices`` along ``axis``."""
    if not isinstance(values, Tensor):
        values = Tensor(to_torch(values, place=arr._value.device))

    def fn(a, i, v):
        v = torch.broadcast_to(v.to(a.dtype), i.shape)
        ax = int(axis) % a.dim()
        if reduce == "assign":
            return a.scatter(ax, i.long(), v)
        if reduce not in _REDUCE:
            raise ValueError(f"unknown reduce {reduce}")
        return a.scatter_reduce(ax, i.long(), v, _REDUCE[reduce],
                                include_self=include_self)
    return apply(fn, arr, indices, values, op_name="put_along_axis")

