"""The jit surface of the ported slices (paddle_tpu/jit/api.py).

``InputSpec``: the deploy artifact (inference/__init__.py) takes one a
program input. ``TrainStep``: one training step, run eagerly. ``jit.save``,
``to_static`` and TrainStep's compilation belong to the compile tier
(ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

from ..core.tensor import Tensor

__all__ = ["InputSpec", "TrainStep"]


class InputSpec:
    """A program input's shape, dtype and name (paddle_tpu/jit/api.py:
    194-201; reference: paddle.static.InputSpec). A ``None`` dim is
    dynamic."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient


class TrainStep:
    """One training step: forward, loss, backward, optimizer update.

    Usage:
        step = TrainStep(model, loss_fn, optimizer)
        loss = step(x, y)          # parameters updated in place

    With ``loss_fn`` the model takes every batch argument but the last and
    the loss is ``loss_fn(out, batch[-1])``; without it the model is
    called on the whole batch and returns the loss itself. Then
    ``loss.backward()``, ``optimizer.step()``, ``optimizer.clear_grad()``;
    the model runs in train mode (eval with ``train=False``) and is left in
    the mode it had. Returns the loss, detached.

    This is the semantics of the reference's eager step
    (paddle_tpu/jit/api.py:696-712), which its fused step computes too.
    Nothing is compiled: each step runs the eager ops, whose kernels are
    the port's (the flash kernels for attention on a card). A compiled
    step is the compile tier's (ROADMAP.md, queue 1, item 9). Dropout
    draws from the port's generators, fresh each step and repeated under
    ``paddle.seed``.
    """

    def __init__(self, model, loss_fn, optimizer, train=True):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.train = train

    def __call__(self, *batch):
        ins = [b if isinstance(b, Tensor) else Tensor(b) for b in batch]
        was_training = self.model.training
        if was_training != self.train:
            self.model.train() if self.train else self.model.eval()
        try:
            if self.loss_fn is not None:
                out = self.model(*ins[:-1])
                loss = self.loss_fn(out, ins[-1])
            else:
                loss = self.model(*ins)
            loss.backward()
            self.optimizer.step()
            self.optimizer.clear_grad()
        finally:
            if was_training != self.train:
                self.model.train() if was_training else self.model.eval()
        return loss.detach()
