"""The op funnel (paddle_tpu/core/dispatch.py:297-371, 373-386, 619-664).

``apply(fn, *args, op_name=)`` is the one entry point every eager op goes
through. In order, it

1. unwraps every Tensor in the arguments (top level, lists, tuples and
   keyword values) to its torch tensor;
2. applies the AMP cast policy (core/amp_state.py::cast_policy) to the
   float ones;
3. runs ``fn`` on torch tensors (under ``torch.no_grad()`` for an op that
   is not differentiable; otherwise under torch's own grad mode, which is
   the framework's: torch records the graph);
4. wraps the torch tensors it returns (alone, or in a tuple or list).

Under auto-parallel the torch tensors may be DTensors. An op with a
DTensor argument runs under DTensor's ``implicit_replication``: a plain
tensor beside it (an argument, or one the op makes, such as a dropout
mask) is taken as replicated on the mesh (each rank holds all of it), as
the TPU package mixes sharded and unsharded arrays. Nothing is gathered
for it.

None of the TPU package's per-signature jit cache, GradNode recording or
pullback trampolines is needed: torch runs each op eagerly and records its
backward. The registry's call tally comes along (ops/registry.py), and
every call counts ``dispatch/calls`` in the metrics registry and, while a
Profiler collects host spans, opens an ``op::<name>`` RecordEvent.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..profiler import RecordEvent, host_tracing_active
from ..profiler import metrics as _metrics
from . import amp_state
from .tensor import Tensor, dtensor_class

__all__ = ["apply", "defop", "add_op_observer", "remove_op_observer",
           "check_nan_inf", "set_flags"]

# debug flags (paddle_tpu/utils/flags.py: FLAGS_check_nan_inf and its level)
_flags = {"check_nan_inf": False, "check_nan_inf_level": 0}

# observers of every completed op's (name, output tensors), for debugging
# tools; each is called after the op (dispatch.py:373-386)
op_observers: list = []

_registry_mod = None

_m_calls = _metrics.counter("dispatch/calls")


def _reg():
    global _registry_mod
    if _registry_mod is None:
        from ..ops import registry

        _registry_mod = registry
    return _registry_mod


def set_flags(flags: dict):
    """paddle.set_flags({"FLAGS_check_nan_inf": True, ...})."""
    for k, v in flags.items():
        name = k[6:] if k.startswith("FLAGS_") else k
        if name not in _flags:
            raise ValueError(f"unknown flag {k!r}")
        _flags[name] = v


def add_op_observer(fn):
    if fn not in op_observers:
        op_observers.append(fn)


def remove_op_observer(fn):
    if fn in op_observers:
        op_observers.remove(fn)


def _unwrap(x, cast):
    if isinstance(x, Tensor):
        t = x._value
        if cast is not None and t.dtype is not cast \
                and t.dtype in amp_state.CASTABLE:
            t = t.to(cast)
        return t
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v, cast) for v in x)
    return x


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


def _holds_dtensor(targs, tkw) -> bool:
    """True when an argument is a DTensor."""
    dt = dtensor_class()
    if dt is None:
        return False

    def visit(x):
        if isinstance(x, (list, tuple)):
            return any(visit(v) for v in x)
        return isinstance(x, dt)

    return visit(targs) or visit(list(tkw.values()))


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def apply(fn: Callable, *args, op_name: str = None,
          differentiable: bool = True, **kwargs):
    """Run ``fn`` (a function of torch tensors) on Tensor arguments and
    return its outputs as Tensors. Every call counts into the always-on
    metrics registry and, while a Profiler collects, opens a host span
    (reference dispatch.py:297-309)."""
    name = op_name or getattr(fn, "__name__", "op")
    _m_calls.inc()
    _reg().record_call(name)
    if host_tracing_active():
        with RecordEvent("op::" + name):
            return _apply(fn, args, kwargs, name, differentiable)
    return _apply(fn, args, kwargs, name, differentiable)


def _apply(fn, args, kwargs, name, differentiable):
    cast = amp_state.cast_policy(name) if amp_state._state.enabled else None
    targs = [_unwrap(a, cast) for a in args]
    tkw = {k: _unwrap(v, cast) for k, v in kwargs.items()} if kwargs \
        else kwargs
    if _holds_dtensor(targs, tkw):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with implicit_replication():
            out = _run(fn, targs, tkw, differentiable)
    else:
        out = _run(fn, targs, tkw, differentiable)
    if _flags["check_nan_inf"] or op_observers:
        leaves = _leaves(out)
        if _flags["check_nan_inf"]:
            check_nan_inf(name, leaves)
        for obs in op_observers:
            obs(name, leaves)
    return _wrap(out)


def _run(fn, targs, tkw, differentiable):
    if differentiable or not torch.is_grad_enabled():
        return fn(*targs, **tkw)
    with torch.no_grad():
        return fn(*targs, **tkw)


def check_nan_inf(name, tensors):
    """FLAGS_check_nan_inf: every float output of every op is checked (a
    host sync an op); at level >= 3 a finding is printed, else raised."""
    for t in tensors:
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            msg = (f"op [{name}] output contains {bad} NaN/Inf values "
                   f"(shape {tuple(t.shape)}, dtype {t.dtype})")
            if int(_flags["check_nan_inf_level"] or 0) >= 3:
                print("WARNING:", msg)
            else:
                raise FloatingPointError(msg)


def defop(name: str = None, differentiable: bool = True):
    """Decorator turning a function of torch tensors into an eager op
    through ``apply``, recorded in the op registry (dispatch.py:639)."""

    def deco(fn):
        op_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return apply(fn, *args, op_name=op_name,
                         differentiable=differentiable, **kwargs)

        wrapper.__wrapped_torch_fn__ = fn
        wrapper.__op_name__ = op_name
        _reg().register(op_name, fn, differentiable=differentiable)
        return wrapper

    return deco
