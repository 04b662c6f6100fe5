"""Recompute, activation checkpointing (paddle_tpu/distributed/fleet/
recompute.py:23).

``torch.utils.checkpoint`` (non-reentrant) over the segment: its forward
keeps only the segment's inputs, and the backward runs the segment again
to rebuild what it needs, the RMSNorm and flash-attention autograd
Functions included (their forward kernels launch twice a step). Torch's
saved-tensor hooks find every tensor the segment reads, so the TPU
package's parameter-discovery pass is not needed. The second run sees what
the first saw: the AMP state (an auto_cast the backward runs outside of),
and, with ``preserve_rng_state``, torch's device RNG states and the port's
generators (framework/random.py), put back after it.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...core import amp_state
from ...core.dispatch import _unwrap, _wrap
from ...core.tensor import Tensor
from ...framework import random as _random

__all__ = ["recompute"]


class _Replay:
    """The recomputation's context: the forward's AMP state and generator
    states, the current ones put back after. It may be entered once for
    each backward that runs the segment again: a backward that keeps the
    graph (``retain_graph``, as the zero-bubble pipeline's input-gradient
    pullback before its weight-gradient one) recomputes it once more."""

    def __init__(self, amp, rng):
        self._amp, self._rng = amp, rng
        self._prev = []

    def __enter__(self):
        prev_amp = amp_state.set_amp(False)
        amp_state.restore_amp(self._amp)
        prev_rng = {k: _random._generators[k].get_state() for k in self._rng
                    if k in _random._generators}
        for k, st in self._rng.items():
            _random.generator(torch.device(k)).set_state(st)
        self._prev.append((prev_amp, prev_rng))
        return self

    def __exit__(self, *exc):
        prev_amp, prev_rng = self._prev.pop()
        amp_state.restore_amp(prev_amp)
        for k in self._rng:
            if k in prev_rng:
                _random._generators[k].set_state(prev_rng[k])
        return False


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward instead of kept. Tensors in ``args`` go through as Tensors;
    ``preserve_rng_state`` (default True) replays the segment's random
    draws."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    is_tensor = [isinstance(a, Tensor) for a in args]

    def run(*raw):
        new = [Tensor._wrap(r) if t else r for r, t in zip(raw, is_tensor)]
        return _unwrap(function(*new, **kwargs), None)

    amp = amp_state.snapshot()
    rng = {k: g.get_state() for k, g in _random._generators.items()} \
        if preserve else {}

    def context_fn():
        return contextlib.nullcontext(), _Replay(amp, rng)

    raw = [a._value if t else a for a, t in zip(args, is_tensor)]
    return _wrap(checkpoint(run, *raw, use_reentrant=False,
                            preserve_rng_state=preserve,
                            context_fn=context_fn))
