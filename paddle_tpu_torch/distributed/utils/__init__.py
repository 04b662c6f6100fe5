"""distributed.utils (paddle_tpu/distributed/utils/__init__.py): the MoE
exchange collectives ``global_scatter`` and ``global_gather``.

The TPU package's pair ignores ``local_count`` and ``global_count``: inside
a ``shard_map`` it runs a tiled ``all_to_all`` that splits the rows equally
over the group (chunk i to rank i, the chunk from rank j at position j);
outside one it returns x unchanged. The port follows it over a process
group: ``all_to_all_single`` with equal splits, the identity for a group of
one rank (or one without a process group). Counts that are given must agree
with the equal split: a count that asks for other splits raises, since the
reference would send equal ones anyway. Both go through ``exchange``, an
autograd function over ``all_to_all_single`` with explicit splits whose
backward is the reverse exchange (``moe_block_stacked`` sends its uneven
splits through it too).
"""
from __future__ import annotations

import torch

from .. import collective

__all__ = ["global_scatter", "global_gather"]


def _group(group):
    return group or collective._get_default_group()


def _check_counts(rows, n, count, name):
    if count is None:
        return
    c = collective._raw(count)
    c = torch.as_tensor(c).reshape(-1)
    if c.numel() % n:
        raise ValueError(f"{name} has {c.numel()} entries, not a multiple "
                         f"of the group's {n} ranks")
    per_rank = c.reshape(n, -1).sum(dim=1).tolist()
    if any(int(v) != rows // n for v in per_rank):
        raise ValueError(
            f"{name} sums to {per_rank} rows a rank; the reference's "
            f"global_scatter splits the {rows} rows equally over the "
            f"{n} ranks ({rows // n} a rank) whatever its counts say")


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all(rows, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.recv, ctx.send, ctx.group), None, None, \
            None


def _all_to_all(rows, send, recv, group):
    out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
    collective.all_to_all_single(out, rows.contiguous(), recv, send,
                                 group=group)
    return out


def exchange(rows, send, recv, group):
    """One ``all_to_all_single`` over ``group``: ``send[i]`` of the rows,
    in order, to rank i, and ``recv[j]`` rows from rank j at their place in
    rank order; the gradient goes back by the reverse exchange."""
    return _Exchange.apply(rows, list(send), list(recv), group)


def global_scatter(x, local_count, global_count, group=None):
    """Send x's rows to the experts' owners over ``group`` (the world when
    None): the reference's equal split, chunk i of the rows to rank i
    (reference distributed/utils/moe_utils.py:20). Takes and returns a
    torch tensor or an eager Tensor."""
    g = _group(group)
    raw = collective._raw(x)
    n = g.nranks
    if n == 1 or g.process_group is None:
        return x
    rows = raw.shape[0]
    if rows % n:
        raise ValueError(f"global_scatter: {rows} rows do not split "
                         f"equally over the group's {n} ranks")
    _check_counts(rows, n, local_count, "local_count")
    _check_counts(rows, n, global_count, "global_count")
    split = [rows // n] * n
    return collective._like(x, exchange(raw, split, split, g))


def global_gather(x, local_count, global_count, group=None):
    """The reverse of ``global_scatter`` (moe_utils.py:153): the counts
    swap roles."""
    return global_scatter(x, global_count, local_count, group)
