"""Grad mode and the backward entry points (paddle_tpu/core/autograd.py:
52-99, 580-688), over torch.autograd.

The TPU package records its own tape (GradNode, its engine and sweep),
because JAX has no eager autograd; torch records the graph on every op
already, so grad mode here is torch's own, and ``backward`` / ``grad``
are torch.autograd's on the wrapped tensors (under DTensor's
implicit_replication when the roots are DTensors, as their forward ops
ran: core/dispatch.py).
"""
from __future__ import annotations

import torch

from .tensor import Tensor, replication_scope, to_torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad"]

# context managers and decorators, as paddle.no_grad & co.
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _values(ts):
    if ts is None:
        return None
    if isinstance(ts, Tensor):
        ts = [ts]
    return [None if t is None else to_torch(t) for t in ts]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' ``.grad``."""
    roots = _values(tensors)
    seeds = _values(grad_tensors)
    for i, r in enumerate(roots):
        if (seeds is None or seeds[i] is None) and r.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for scalar outputs; "
                f"got shape {tuple(r.shape)}")
    with replication_scope(roots):
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad: gradients of ``outputs`` w.r.t. ``inputs``, without
    touching ``.grad``; a list of Tensors (None for an unused input when
    ``allow_unused``)."""
    single = isinstance(inputs, Tensor)
    ins = _values(inputs)
    outs = _values(outputs)
    with replication_scope(outs):
        gs = torch.autograd.grad(outs, ins,
                                 grad_outputs=_values(grad_outputs),
                                 retain_graph=retain_graph,
                                 create_graph=create_graph,
                                 allow_unused=allow_unused)
    out = [None if g is None else Tensor._wrap(g) for g in gs]
    return out[:1] if single else out
