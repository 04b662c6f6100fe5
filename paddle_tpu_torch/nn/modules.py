"""torch.nn.Module layers over raw torch tensors: the serving model's Linear,
Embedding and RMSNorm, and the functions they call.

The public ``nn.Linear``, ``nn.Embedding`` and ``nn.RMSNorm`` are the
eager Layers (nn/layer); the serving model (inference/serving.py) is a
torch module tree, which ``torch.export`` traces for the deploy artifact,
so it keeps these. ``rms_norm`` routes to the CUDA RMSNorm kernel for a
CUDA tensor (ops/kernels/rms_norm.py).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels import rms_norm as _rms

__all__ = ["TorchLinear", "TorchEmbedding", "TorchRMSNorm", "rms_norm",
           "linear", "embedding", "swiglu"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis, routed to the CUDA kernel for a CUDA
    tensor (nn/functional/__init__.py:683-693)."""
    return _rms.rms_norm(x, weight, epsilon)


def linear(x, weight):
    """y = x W with the reference's [in, out] weight layout (bias-free)."""
    return x @ weight


def embedding(ids, weight):
    """Rows of ``weight`` at integer ``ids``. torch's embedding, whose
    gradient sums the rows of repeated ids by segments: the gradient of
    ``weight[ids]`` (index_put with accumulation) serialises on repeated
    ids, 14.5 ms a BERT-base step on an H100 for its position and
    token-type tables (chip_smoke.py's profile phase)."""
    return torch.nn.functional.embedding(ids, weight)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x splits in two along the last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return torch.nn.functional.silu(x) * y


class TorchLinear(nn.Module):
    """y = x W (+ b) with W [in_features, out_features], the reference
    layout (``x @ w``), so carried-over weights need no transpose.
    Xavier-uniform init from ``generator``; ``bias_attr=True`` adds a bias
    [out_features] starting at zeros (the serving model's layers are
    bias-free, the default here)."""

    def __init__(self, in_features, out_features, *, bias_attr=False,
                 device=None, generator=None):
        super().__init__()
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=device)
        w.uniform_(-limit, limit, generator=generator)
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device),
                                 requires_grad=False) if bias_attr else None

    def forward(self, x):
        y = linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class TorchEmbedding(nn.Module):
    """Lookup table [num_embeddings, embedding_dim], Xavier-normal init."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 generator=None):
        super().__init__()
        std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        w = torch.empty(num_embeddings, embedding_dim, device=device)
        w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w, requires_grad=False)

    def forward(self, ids):
        return embedding(ids, self.weight)


class TorchRMSNorm(nn.Module):
    """Routed to the CUDA RMSNorm kernel for CUDA tensors
    (ops/kernels/rms_norm.py); the weight starts at ones and is trained
    (the gradient is ops/kernels/rms_norm.py::_rms_norm_bwd)."""

    def __init__(self, normalized_shape, epsilon=1e-6, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(list(normalized_shape), device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
