"""Linear, Embedding and Dropout as eager Layers
(paddle_tpu/nn/layer/common.py:19-84), with the reference's defaults: a
Linear has a bias unless ``bias_attr=False``."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import XavierNormal
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x W + b, W [in_features, out_features] (the reference layout,
    ``x @ w``): Xavier-uniform W, zero bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        if bias_attr is not False:
            self.bias = self.create_parameter([out_features],
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    """Lookup table [num_embeddings, embedding_dim], Xavier-normal; the
    ``padding_idx`` row starts at zeros and looks up zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal())
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._value[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """F.dropout while training; the identity in eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
