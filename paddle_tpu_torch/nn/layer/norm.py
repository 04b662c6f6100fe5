"""Normalization layers as eager Layers (paddle_tpu/nn/layer/norm.py:
17-158): LayerNorm through F.layer_norm (f32 arithmetic, x's dtype out);
RMSNorm through F.rms_norm to the CUDA RMSNorm kernel for a CUDA tensor;
the batch norms through F.batch_norm, their running statistics the buffers
``_mean`` (zeros) and ``_variance`` (ones) on the default place; and
SyncBatchNorm, whose training statistics are all-reduced over the world
(collective.all_reduce) when one with more than one rank is initialized."""
from __future__ import annotations

import torch

from ...core.place import to_torch_device
from ...core.tensor import Tensor
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm"]


class LayerNorm(Layer):
    """A weight of ones and a bias of zeros over ``normalized_shape``;
    ``weight_attr`` / ``bias_attr`` False leave either out."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.bias = None
        dev = to_torch_device()
        self.register_buffer("_mean", Tensor._wrap(
            torch.zeros(num_features, device=dev)))
        self.register_buffer("_variance", Tensor._wrap(
            torch.ones(num_features, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the whole world's batch. Training under an
    initialized world of more than one rank: each rank's f32 mean and
    mean of squares (no gradient), summed by one all-reduce and divided by
    the world's size, normalize x as fixed statistics (the running
    buffers are left as they are), as the reference's eager path does
    (nn/layer/norm.py:114-139). Otherwise a plain batch norm."""

    def forward(self, x):
        from ...distributed import collective

        if self.training and collective.is_initialized() and \
                collective.get_world_size() > 1:
            ch_axis = 1 if x.ndim > 2 else x.ndim - 1
            axes = tuple(i for i in range(x.ndim) if i != ch_axis)
            with torch.no_grad():
                xa = x._value.float()
                stats = torch.cat([xa.mean(dim=axes),
                                   xa.square().mean(dim=axes)])
            collective.all_reduce(stats)
            stats = stats / collective.get_world_size()
            gm = stats[:self._num_features]
            gv = stats[self._num_features:] - gm.square()
            return F.batch_norm(
                x, Tensor._wrap(gm), Tensor._wrap(gv), self.weight,
                self.bias, training=False, momentum=self._momentum,
                epsilon=self._epsilon, data_format=self._data_format,
                use_global_stats=True)
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        SyncBatchNorm holding its values."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon)
            if layer.weight is not None:
                out.weight.set_value(layer.weight)
                out.bias.set_value(layer.bias)
            out._mean.set_value(layer._mean)
            out._variance.set_value(layer._variance)
        for name, sub in layer._sub_layers.items():
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out
