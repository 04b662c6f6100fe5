"""Linear and Embedding (paddle_tpu/nn/layer/common.py:19, 51)."""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """y = x W (+ b) with W [in_features, out_features], the reference
    layout (``x @ w``), so carried-over weights need no transpose.
    Xavier-uniform init from ``generator``; ``bias_attr=True`` adds a bias
    [out_features] starting at zeros, as the reference's default does (the
    port's layers are bias-free, the default here)."""

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
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Lookup table [num_embeddings, embedding_dim], Xavier-normal init."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 generator=None):
        super().__init__()
        std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        w = torch.empty(num_embeddings, embedding_dim, device=device)
        w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w, requires_grad=False)

    def forward(self, ids):
        return F.embedding(ids, self.weight)
