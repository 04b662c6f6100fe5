"""Tensor-parallel layers (paddle_tpu/distributed/meta_parallel/mp_layers.py;
reference fleet/layers/mpu/mp_layers.py:47, 334, 541, 742).

The TPU package keeps each parameter as one full array with a
NamedSharding over 'mp', and XLA inserts the collectives. Here each rank
is a process that holds its shard: the layer draws the full parameter
(every rank from the same generator state, so the shards tile the array a
single process would draw) and keeps its slice, marked ``is_distributed``
with its ``split_axis`` (as the reference's ``_shard_param``). The
forwards are Megatron's, over the model-parallel group
(fleet/layers/mpu/mp_ops.py):

- VocabParallelEmbedding: rows [r*V/n, (r+1)*V/n) of the table; ids
  outside them look up zeros, and the lookups are summed over mp;
- ColumnParallelLinear: columns r of W (and of the bias); the input's
  gradient is summed over mp (``_c_identity``); ``gather_output``
  concatenates the output slices;
- RowParallelLinear: rows r of W; the partial products are summed over mp
  and the bias, whole on every rank, is added once after the sum;
  ``input_is_parallel=False`` slices the input first;
- ParallelCrossEntropy over vocab-sharded logits: the max, the sum of
  exponentials and the picked logit each reduced over mp.
With an mp degree of 1 each is its plain layer.
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.dispatch import apply
from ...nn import functional as F
from ...nn.initializer import XavierNormal
from ..fleet.layers.mpu import mp_ops
from ..topology import get_hybrid_communicate_group

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _mp_info(mp_group=None):
    """(world, rank, group) of the model-parallel group."""
    if mp_group is not None:
        return mp_group.nranks, mp_group.rank, mp_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return 1, 0, None
    return (hcg.get_model_parallel_world_size(),
            hcg.get_model_parallel_rank(), hcg.get_model_parallel_group())


def _shard_param(param, axis, world, rank):
    """Keep this rank's slice of ``param`` along ``axis`` (the full array
    split in ``world`` equal pieces)."""
    full = param._value
    if full.shape[axis] % world:
        raise ValueError(f"axis {axis} of a {tuple(full.shape)} parameter "
                         f"does not split over {world} ranks")
    param._replace(full.chunk(world, dim=axis)[rank].contiguous())
    param.is_distributed = True
    param.split_axis = axis
    return param


class VocabParallelEmbedding(nn.Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.world_size, self.rank, self.mp_group = _mp_info(mp_group)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal())
        if self.world_size > 1:
            _shard_param(self.weight, 0, self.world_size, self.rank)

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight)
        rank, group = self.rank, self.mp_group

        def fn(ids, w):
            per = w.shape[0]
            local = ids.long() - rank * per
            outside = (local < 0) | (local >= per)
            out = torch.nn.functional.embedding(
                local.masked_fill(outside, 0), w)
            return mp_ops._MpAllreduce.apply(
                out.masked_fill(outside[..., None], 0.0), group)
        return apply(fn, x, self.weight, op_name="embedding")


class ColumnParallelLinear(nn.Layer):
    """Output columns split over mp; ``gather_output=False`` leaves the
    output split (for a RowParallelLinear), True concatenates it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.world_size, self.rank, self.mp_group = _mp_info(mp_group)
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter(
            [out_features], is_bias=True) if has_bias else None
        if self.world_size > 1:
            _shard_param(self.weight, 1, self.world_size, self.rank)
            if self.bias is not None:
                _shard_param(self.bias, 0, self.world_size, self.rank)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        x = mp_ops._c_identity(x, self.mp_group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_ops._c_concat(out, self.mp_group)
        return out


class RowParallelLinear(nn.Layer):
    """Input rows split over mp; the partial products summed over mp, then
    the bias added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.world_size, self.rank, self.mp_group = _mp_info(mp_group)
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter(
            [out_features], is_bias=True) if has_bias else None
        if self.world_size > 1:
            _shard_param(self.weight, 0, self.world_size, self.rank)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = mp_ops._c_split(x, self.mp_group)
        out = mp_ops._mp_allreduce(F.linear(x, self.weight),
                                   self.mp_group)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(nn.Layer):
    """Softmax cross entropy over logits split on the vocabulary axis
    (reference mp_layers.py:742): per-row loss, shape [..., 1]; a label of
    ``ignore_index`` gives 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.world_size, self.rank, self.mp_group = _mp_info(mp_group)

    def forward(self, input, label):
        from ...ops.manipulation import unsqueeze

        if self.world_size == 1:
            return unsqueeze(F.cross_entropy(
                input, label, reduction="none",
                ignore_index=self.ignore_index), -1)
        rank, group, ignore = self.rank, self.mp_group, self.ignore_index

        def fn(logits, lab):
            if lab.dim() == logits.dim():
                lab = lab.squeeze(-1)
            loss = mp_ops.vocab_parallel_nll(logits.float(), lab, group, rank)
            loss = loss.masked_fill(lab.long() == ignore, 0.0)
            return loss.to(logits.dtype)[..., None]
        return apply(fn, input, label, op_name="c_softmax_with_cross_entropy")
