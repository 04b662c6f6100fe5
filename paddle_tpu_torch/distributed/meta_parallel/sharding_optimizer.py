"""ZeRO sharding (paddle_tpu/distributed/meta_parallel/sharding_optimizer.py).

The TPU package shards by placement: its moments (stage 1-2) and
parameters (stage 3) carry a NamedSharding over 'sharding', and XLA
gathers and scatters. Here each rank holds its piece and the collectives
are explicit:

- ``all_gather_params`` (reference ``_gather_leaf``, :84-108): an autograd
  function that all-gathers a parameter's shards in the forward and
  reduce-scatters (sums) its gradient in the backward, so the gradient
  comes back sharded as the parameter is;
- ``stage3_forward`` (:110-143): a stack of layers whose parameters live as
  shards, each layer's gathered just before it runs; with ``overlap`` the
  next layer's gather is in flight (async) while this one computes;
- ``DygraphShardingOptimizer`` at stage 1 (:178-236): the gradients are
  averaged over the sharding group, and each rank keeps the moments of,
  and updates, its 1/n of every parameter (its flat slice), then the
  updated slices are all-gathered into every rank's full parameter.

The group-sharded wrappers (``GroupShardedStage2/3``,
``group_sharded_parallel``) and stages 2-3 of this optimizer are not
ported (ROADMAP.md, queue 1, item 5).
"""
from __future__ import annotations

import math

import torch

from ...core.tensor import Tensor
from .. import collective
from ..fleet.layers.mpu.mp_ops import (_live, gather_along,
                                       reduce_scatter_along)
from ..topology import get_hybrid_communicate_group

__all__ = ["all_gather_params", "stage3_forward",
           "DygraphShardingOptimizer", "DygraphShardingOptimizerV2"]


class _GatherLeaf(torch.autograd.Function):
    """The full parameter from its shards along ``dim`` (gathered here, or
    ``full`` when a prefetch gathered it); the gradient reduce-scattered
    back to the shard."""

    @staticmethod
    def forward(ctx, shard, group, dim, full=None):
        ctx.group, ctx.dim = group, dim
        return gather_along(shard, group, dim) if full is None else full

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, ctx.group, ctx.dim), None, None, None


def _gather_leaf(shard, group, dim=0, full=None):
    return _GatherLeaf.apply(shard, group, dim, full)


def all_gather_params(shards, group=None, dim=0):
    """A dict (nested) of parameter shards, each split along ``dim`` over
    ``group`` (None: the hybrid group's sharding group) -> the full
    parameters, differentiable: the backward reduce-scatters each
    gradient."""
    if group is None:
        group = get_hybrid_communicate_group().get_sharding_parallel_group()
    return {k: all_gather_params(v, group, dim) if isinstance(v, dict)
            else _gather_leaf(v, group, dim) for k, v in shards.items()}


def _prefetch(shards, group, dim):
    """Start the all-gathers of a dict of shards: {key: (buffer, work)}."""
    out = {}
    for k, s in shards.items():
        s = s.detach().contiguous()
        n = group.nranks
        buf = torch.empty((n * s.shape[0],) + tuple(s.shape[1:]),
                          dtype=s.dtype, device=s.device)
        out[k] = (buf, collective._all_gather_single(
            buf, s, group=collective._pg(group, [s]), async_op=True))
    return out


def _take(shards, pending, group, dim):
    full = {}
    for k, s in shards.items():
        buf, work = pending[k]
        work.wait()
        if dim:
            buf = torch.cat(buf.chunk(group.nranks, 0), dim=dim)
        full[k] = _gather_leaf(s, group, dim, buf)
    return full


def stage3_forward(stage_fn, layer_shards, x, group=None, dim=0,
                   overlap: bool = True):
    """``x`` through layers whose parameters live as shards: each layer's
    full parameters (``all_gather_params`` of its dict of shards) go to
    ``stage_fn(params, x) -> x``. With ``overlap`` (and a process group)
    the gather of layer i+1 is issued before layer i computes; the result
    is the same either way."""
    if group is None:
        group = get_hybrid_communicate_group().get_sharding_parallel_group()
    layer_shards = list(layer_shards)
    if not overlap or not _live(group):
        for sh in layer_shards:
            x = stage_fn(all_gather_params(sh, group, dim), x)
        return x
    pending = _prefetch(layer_shards[0], group, dim) if layer_shards \
        else None
    for i, sh in enumerate(layer_shards):
        cur = pending
        if i + 1 < len(layer_shards):
            pending = _prefetch(layer_shards[i + 1], group, dim)
        x = stage_fn(_take(sh, cur, group, dim), x)
    return x


class DygraphShardingOptimizer:
    """ZeRO stage 1 over the sharding group: each rank's moments and update
    cover its flat slice of each parameter (ceil(numel / n) elements, the
    last rank's shorter), and the updated slices are all-gathered back."""

    def __init__(self, optimizer, hcg=None, stage: int = 1):
        if stage != 1:
            raise NotImplementedError(
                f"paddle_tpu_torch: sharding stage {stage} is not ported "
                f"(ROADMAP.md, queue 1, item 5); stage 1 is")
        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._group = None if self._hcg is None else \
            self._hcg.get_sharding_parallel_group()
        self.stage = stage
        self._slices = {}

    @property
    def _n(self):
        return 1 if self._group is None else self._group.nranks

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _bounds(self, numel):
        c = math.ceil(numel / self._n)
        lo = min(self._group.rank * c if self._n > 1 else 0, numel)
        return c, lo, min(lo + c, numel)

    def _slice_of(self, p):
        """The Tensor over this rank's flat slice of ``p`` (a view: the
        inner optimizer's update writes into ``p``); one object a
        parameter, so its moments persist."""
        _, lo, hi = self._bounds(p._value.numel())
        view = p._value.detach().view(-1)[lo:hi]
        s = self._slices.get(id(p))
        if s is None:
            s = self._slices[id(p)] = Tensor._wrap(view)
            s.name = p.name
        else:
            s._value = view
        return s

    @torch.no_grad()
    def reduce_gradients(self):
        """Average every gradient over the sharding group."""
        if _live(self._group):
            for p in self._inner_opt._parameter_list:
                if p._value.grad is not None:
                    collective.all_reduce(p._value.grad,
                                          op=collective.ReduceOp.AVG,
                                          group=self._group)

    def step(self):
        self.reduce_gradients()
        self.sharded_update()

    @torch.no_grad()
    def sharded_update(self):
        """The inner optimizer's step (its clip over the full gradients)
        on this rank's slices, then every parameter's slices gathered."""
        inner = self._inner_opt
        live = [(i, p) for i, p in enumerate(inner._parameter_list)
                if not p.stop_gradient and p._value.grad is not None]
        if not live:
            return
        grads = [p._value.grad for _, p in live]
        if inner._grad_clip is not None:
            grads = inner._grad_clip.apply(grads)
        inner._step_count += 1
        lr = float(torch.tensor(inner.get_lr(), dtype=torch.float32))
        groups = {}
        for (i, p), g in zip(live, grads):
            _, lo, hi = self._bounds(p._value.numel())
            item = (self._slice_of(p), g.reshape(-1)[lo:hi])
            groups.setdefault(inner._decay(p, i), []).append(item)
        for wd, items in groups.items():
            inner._update_group(items, lr, wd)
        if self._n > 1:
            for _, p in live:
                self._gather_param(p)

    def _gather_param(self, p):
        c, lo, hi = self._bounds(p._value.numel())
        flat = p._value.detach().view(-1)
        piece = torch.zeros(c, dtype=flat.dtype, device=flat.device)
        piece[:hi - lo] = flat[lo:hi]
        full = gather_along(piece, self._group, 0)
        flat.copy_(full[:flat.numel()])

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        """This rank's slices of the moments, under the inner optimizer's
        names, and the step count."""
        out = {"_step_count": self._inner_opt._step_count}
        for i, p in enumerate(self._inner_opt._parameter_list):
            s = self._slices.get(id(p))
            st = None if s is None else \
                self._inner_opt._accumulators.get(id(s))
            for k, v in (st or {}).items():
                out[f"{p.name or f'param_{i}'}.{k}"] = Tensor._wrap(
                    v.detach().clone())
        return out


DygraphShardingOptimizerV2 = DygraphShardingOptimizer
