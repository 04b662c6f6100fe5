"""The model-parallel collectives as autograd functions
(paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py; reference
fleet/layers/mpu/mp_ops.py: _c_identity, _mp_allreduce, _c_split,
_c_concat).

The TPU package's versions are identities: GSPMD inserts the collectives
from the parameters' shardings. Here each rank holds its shard, so each op
is Megatron's pair of a forward and a backward collective over the
model-parallel group:

- ``_c_identity``: identity forward, all-reduce (sum) of the gradient;
- ``_mp_allreduce``: all-reduce (sum) forward, identity backward;
- ``_c_split``: this rank's slice of the last axis forward, all-gather of
  the gradient;
- ``_c_concat``: all-gather along the last axis forward, this rank's slice
  of the gradient.

Each takes a torch tensor or an eager Tensor (then through the op funnel),
and ``group`` None means the hybrid group's model-parallel group. A group
without a process group (one process, no init_parallel_env) is a world of
one: the ops are identities there.
"""
from __future__ import annotations

import torch

from .... import collective

__all__ = ["_c_identity", "_mp_allreduce", "_c_split", "_c_concat",
           "gather_along", "gather_leaf", "reduce_scatter_along",
           "all_reduce_live",
           "vocab_parallel_nll"]


def _mp_group(group):
    if group is not None:
        return group
    from ....topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def _live(group) -> bool:
    return group is not None and group.process_group is not None


def all_reduce_live(t: torch.Tensor, group, op=collective.ReduceOp.SUM):
    """All-reduce ``t`` in place over ``group`` where it has a process
    group (a world of one without one: nothing to do)."""
    if _live(group):
        collective.all_reduce(t, op=op, group=group)
    return t


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's pieces of ``t`` concatenated along ``dim``, in rank
    order."""
    if not _live(group):
        return t
    return collective.all_gather(None, t.contiguous(), group=group,
                                 axis=dim)


def reduce_scatter_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of ``t``, and of it this rank's piece along
    ``dim`` (the transpose of ``gather_along``)."""
    if not _live(group):
        return t
    pieces = t.chunk(group.nranks, dim=dim)
    out = torch.empty(pieces[0].shape, dtype=t.dtype, device=t.device)
    collective.reduce_scatter(out, list(pieces), group=group)
    return out


class _GatherLeaf(torch.autograd.Function):
    """The full tensor from its shards along ``dim`` (gathered here, or
    ``full`` when a prefetch gathered it); the gradient reduce-scattered
    (summed) back to the shard."""

    @staticmethod
    def forward(ctx, shard, group, dim, full=None):
        ctx.group, ctx.dim = group, dim
        return gather_along(shard, group, dim) if full is None else full

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, ctx.group, ctx.dim), None, None, None


def gather_leaf(shard, group, dim=0, full=None):
    """``gather_along`` as an autograd function whose backward sums the
    gradient over the group and hands each rank its piece (the FSDP
    gather of a parameter shard, and MoE's gather of the router logits)."""
    return _GatherLeaf.apply(shard, group, dim, full)


def _slice(t, group, dim):
    if not _live(group):
        return t
    return t.chunk(group.nranks, dim=dim)[group.rank].contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_live(g.contiguous().clone(), ctx.group), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_live(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.group, g.dim() - 1), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_along(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, -1), None


def vocab_parallel_nll(logits, labels, group, rank):
    """lse - picked at each position of logits split on the vocabulary
    over ``group`` (this rank's [..., V/n] columns), the max under a
    stop-gradient: the max, the sum of exponentials and the picked logit
    each reduced over the group (Megatron's cross entropy)."""
    m = all_reduce_live(logits.detach().amax(dim=-1, keepdim=True), group,
                        op=collective.ReduceOp.MAX)
    lse = m[..., 0] + torch.log(
        _MpAllreduce.apply(torch.exp(logits - m).sum(dim=-1), group))
    per = logits.shape[-1]
    local = labels.long() - rank * per
    outside = (local < 0) | (local >= per)
    picked = logits.gather(-1, local.masked_fill(outside, 0)[..., None])
    return lse - _MpAllreduce.apply(picked[..., 0].masked_fill(outside, 0.0),
                                    group)


def _run(fn, tensor, group, op_name):
    from .....core.dispatch import apply
    from .....core.tensor import Tensor

    group = _mp_group(group)
    if isinstance(tensor, Tensor):
        return apply(lambda x: fn.apply(x, group), tensor, op_name=op_name)
    return fn.apply(tensor, group)


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Identity forward, gradient all-reduced over ``group``."""
    return _run(_CIdentity, tensor, group, "c_identity")


def _mp_allreduce(tensor, group=None, use_calc_stream=True,
                  use_model_parallel=True, op=None):
    """Sum over ``group`` forward, identity backward."""
    return _run(_MpAllreduce, tensor, group, "mp_allreduce")


def _c_split(tensor, group=None):
    """This rank's slice of the last axis; the gradient all-gathered."""
    return _run(_CSplit, tensor, group, "c_split")


def _c_concat(tensor, group=None):
    """The group's slices concatenated along the last axis; the gradient
    sliced back."""
    return _run(_CConcat, tensor, group, "c_concat")
