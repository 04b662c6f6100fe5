"""Weight initializers (paddle_tpu/nn/initializer/__init__.py).

Each draws in float32 on the parameter's device from that device's
generator (framework/random.py), then casts to the parameter's dtype, as
the TPU package draws f32 and casts.
"""
from __future__ import annotations

import math

import torch

from ..core.dtype import convert_dtype
from ..framework.random import generator

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "XavierUniform"]


def _fan_in_out(shape):
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: [out_c, in_c, *spatial] (the reference layout)
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype, device):
        """A new tensor of ``shape`` and ``dtype`` on ``device``."""
        raise NotImplementedError

    @staticmethod
    def _f32(shape, device):
        return torch.empty(tuple(int(s) for s in shape),
                           dtype=torch.float32, device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=convert_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        w = self._f32(shape, device).normal_(generator=generator(device))
        return (self.mean + self.std * w).to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device):
        w = self._f32(shape, device).uniform_(self.low, self.high,
                                              generator=generator(device))
        return w.to(convert_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)
