"""Arithmetic, comparisons and reductions (paddle_tpu/ops/math.py and the
comparisons of ops/logic.py).

Type promotion of two tensors follows JAX's (the TPU package's), which
takes both operands' dtypes whatever their rank: ``promote_types`` of the
two, where torch would let a 0-d float32 tensor take a bfloat16 tensor's
dtype. A Python scalar is weak in both: a bfloat16 tensor times 0.5 stays
bfloat16, an int tensor plus 0.5 is float32. Ints beside floats take the
float's dtype (the reference's ``_promoting``).
"""
from __future__ import annotations

import operator

import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, to_torch

__all__ = ["add", "subtract", "multiply", "divide", "pow", "neg", "abs",
           "exp", "log", "sum", "mean", "all", "equal", "not_equal",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "promote"]


def promote(a, b):
    """Two operands cast to one dtype where both are tensors of different
    dtypes (JAX's rule); a Python scalar is left for torch (weak)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.dtype != b.dtype:
        d = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(d), b.to(d)
    return a, b


_SCALARS = (int, float, bool, complex)


def _operand(y, like):
    """A right operand as apply takes it: a Tensor or a Python scalar stay,
    other array-likes become a Tensor on ``like``'s device."""
    if isinstance(y, (Tensor,) + _SCALARS):
        return y
    return Tensor(to_torch(y, place=like._value.device))


def _binary(op_name, fn, differentiable=True):
    def op(x, y, name=None):
        if not isinstance(x, Tensor):
            if not isinstance(y, Tensor):
                x = Tensor(x)
            else:
                return reflected(op_name, fn, differentiable)(y, x)
        return apply(lambda a, b: fn(*promote(a, b)), x, _operand(y, x),
                     op_name=op_name, differentiable=differentiable)
    op.__name__ = op_name
    return op


def reflected(op_name, fn, differentiable=True):
    """``op(self, other)`` computing ``fn(other, self)``: the reflected
    dunders (``2 - t``), the Python scalar kept weak."""
    def op(x, y, name=None):
        return apply(lambda a, b: fn(*promote(b, a)), x, _operand(y, x),
                     op_name=op_name, differentiable=differentiable)
    op.__name__ = op_name
    return op


def _unary(op_name, fn, differentiable=True):
    def op(x, name=None):
        return apply(fn, x, op_name=op_name, differentiable=differentiable)
    op.__name__ = op_name
    return op


# Python's operators on torch tensors: int / int is float32, as
# jnp.true_divide gives it, and a scalar on either side stays weak
add = _binary("add", operator.add)
subtract = _binary("subtract", operator.sub)
multiply = _binary("multiply", operator.mul)
divide = _binary("divide", operator.truediv)
pow = _binary("pow", operator.pow)

neg = _unary("neg", torch.neg)
abs = _unary("abs", torch.abs)
exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)

equal = _binary("equal", operator.eq, differentiable=False)
not_equal = _binary("not_equal", operator.ne, differentiable=False)
less_than = _binary("less_than", operator.lt, differentiable=False)
less_equal = _binary("less_equal", operator.le, differentiable=False)
greater_than = _binary("greater_than", operator.gt, differentiable=False)
greater_equal = _binary("greater_equal", operator.ge, differentiable=False)


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _reduce(op_name, fn, differentiable=True):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        ax = _axes(axis)
        d = convert_dtype(dtype)

        def run(a):
            if d is not None:
                a = a.to(d)
            if ax is None or ax == ():
                out = fn(a)
                return out.reshape([1] * a.dim()) if keepdim else out
            return fn(a, dim=ax, keepdim=keepdim)
        return apply(run, x, op_name=op_name, differentiable=differentiable)
    op.__name__ = op_name
    return op


sum = _reduce("sum", torch.sum)
mean = _reduce("mean", torch.mean)
all = _reduce("all", torch.all, differentiable=False)
