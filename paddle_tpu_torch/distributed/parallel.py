"""DataParallel (paddle_tpu/distributed/parallel.py; reference
python/paddle/distributed/parallel.py:202 with its EagerReducer).

The TPU package's data parallelism is a mesh axis that XLA reduces over.
Here each rank is a process: the wrapper broadcasts the parameters from
the group's first rank, and a hook on each trainable parameter averages
its gradient over the group as the backward produces it (an all-reduce a
parameter; the reference's bucketing is not ported). Inside ``no_sync()``
the hooks leave the gradients local, for accumulation.
"""
from __future__ import annotations

import contextlib

import torch

from ..nn.layer.layers import Layer
from . import collective
from .fleet.layers.mpu.mp_ops import _live

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group or collective._get_default_group()
        self.find_unused_parameters = find_unused_parameters
        self._world = self.group.nranks
        self._sync = True
        if self._world > 1 and _live(self.group):
            self._sync_params()
            self._register_hooks()

    def _sync_params(self):
        for p in self._layers.parameters():
            collective.broadcast(p, src=self.group.ranks[0],
                                 group=self.group)

    def _register_hooks(self):
        group, world = self.group, self._world

        def hook(grad):
            if not self._sync:
                return grad
            g = grad.contiguous().clone()
            collective.all_reduce(g, group=group)
            return g / world

        for p in self._layers.parameters():
            if not p.stop_gradient:
                p._value.register_hook(hook)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: the hooks average the gradients."""
        return loss

    @property
    def _inner_layers(self):
        return self._layers

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients stay local inside the block (accumulation steps)."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True
