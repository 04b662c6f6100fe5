"""Megatron-style sequence parallelism ("SP") over the model-parallel group
(paddle_tpu/distributed/fleet/sequence_parallel_utils.py; reference
fleet/utils/sequence_parallel_utils.py:85-137 and :427).

Between the tensor-parallel blocks each mp rank holds its slice of the
activations along the sequence axis (axis 0 of Paddle's [S, B, H]); a
ColumnSequenceParallelLinear all-gathers the sequence before its product,
and a RowSequenceParallelLinear reduce-scatters its partial products back
to the slices. The TPU package's ops are identities outside ``shard_map``
(GSPMD inserts the collectives from the shardings); here each rank is a
process, so each op is a pair of collectives over the mp group, as an
autograd function:

- ``ScatterOp``: this rank's slice along ``axis`` forward; the gradient
  all-gathered;
- ``GatherOp``: the slices all-gathered along ``axis``; the gradient
  sliced back;
- ``AllGatherOp``: all-gather along axis 0; the gradient reduce-scattered;
- ``ReduceScatterOp``: reduce-scatter along axis 0; the gradient
  all-gathered.

Each takes a torch tensor or an eager Tensor (then through the op funnel).
With an mp group of one rank (or no hybrid group) each is the identity, as
the reference's is outside ``shard_map``.

Parameters that see only this rank's slice of the sequence (a norm's
weight, the row layer's bias) get a partial gradient;
``mark_as_sequence_parallel_parameter`` marks them and
``register_sequence_parallel_allreduce_hooks`` sums their gradients over
the mp group.
"""
from __future__ import annotations

import torch

from ...core.dispatch import apply
from ...nn import functional as F
from ..meta_parallel.mp_layers import ColumnParallelLinear, RowParallelLinear
from ..topology import get_hybrid_communicate_group
from .layers.mpu import mp_ops

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]


def _mp_group():
    """The hybrid group's model-parallel group, or None (a world of one)."""
    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def _slice(t, group, axis):
    if not mp_ops._live(group):
        return t
    return t.chunk(group.nranks, dim=axis)[group.rank].contiguous()


class _SequenceOp(torch.autograd.Function):
    """An SP op over the mp group: ``apply`` takes a torch tensor, or an
    eager Tensor through the op funnel."""

    op_name = "sp"

    @classmethod
    def apply(cls, input, *args):
        from ...core.tensor import Tensor

        group = _mp_group()
        if isinstance(input, Tensor):
            return apply(lambda x: super(_SequenceOp, cls).apply(
                x, group, *args), input, op_name=cls.op_name)
        return super().apply(input, group, *args)


class ScatterOp(_SequenceOp):
    """This rank's slice of ``axis``; the gradient all-gathered."""

    op_name = "sp_scatter"

    @staticmethod
    def forward(ctx, x, group, axis=0):
        ctx.group, ctx.axis = group, axis
        return _slice(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return mp_ops.gather_along(g, ctx.group, ctx.axis), None, None


class GatherOp(_SequenceOp):
    """The slices all-gathered along ``axis``; the gradient sliced."""

    op_name = "sp_gather"

    @staticmethod
    def forward(ctx, x, group, axis=0):
        ctx.group, ctx.axis = group, axis
        return mp_ops.gather_along(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.axis), None, None


class AllGatherOp(_SequenceOp):
    """All-gather along axis 0; the gradient reduce-scattered."""

    op_name = "sp_allgather"

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mp_ops.gather_along(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return mp_ops.reduce_scatter_along(g.contiguous(), ctx.group, 0), \
            None


class ReduceScatterOp(_SequenceOp):
    """Reduce-scatter along axis 0; the gradient all-gathered."""

    op_name = "sp_reduce_scatter"

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mp_ops.reduce_scatter_along(x.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        return mp_ops.gather_along(g, ctx.group, 0), None


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A ColumnParallelLinear whose input is this rank's slice of the
    sequence (axis 0): the slices all-gathered, then this rank's columns
    (reference :427). The all-gather's backward reduce-scatters the input's
    gradient, which sums it over mp; the output stays split on the
    columns."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its output "
                             "split (gather_output=False)")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        return F.linear(AllGatherOp.apply(x), self.weight, self.bias)


class RowSequenceParallelLinear(RowParallelLinear):
    """A RowParallelLinear whose output is this rank's slice of the
    sequence (axis 0): the partial products reduce-scattered, then the
    bias, which sees only this slice's rows and is marked
    sequence-parallel (its gradient summed over mp by
    ``register_sequence_parallel_allreduce_hooks``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes its input "
                             "split on the features (input_is_parallel)")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name)
        if self.bias is not None and self.world_size > 1:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        out = ReduceScatterOp.apply(F.linear(x, self.weight))
        return out if self.bias is None else out + self.bias


def mark_as_sequence_parallel_parameter(parameter):
    """Mark a parameter whose gradient each mp rank computes from its
    slice of the sequence only."""
    parameter.sequence_parallel = True


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Sum the gradients of ``model``'s sequence-parallel parameters over
    the mp group as they are computed (reference :192). Nothing to do
    without an mp group of two or more ranks."""
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() <= 1:
        return
    group = hcg.get_model_parallel_group()
    if not mp_ops._live(group):
        return

    def hook(grad):
        return mp_ops.all_reduce_live(grad.contiguous().clone(), group)

    for p in model.parameters():
        if getattr(p, "sequence_parallel", False) and not p.stop_gradient:
            p._value.register_hook(hook)
