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
- ``DygraphShardingOptimizer`` (:178-236) over a rank's flat slice of
  every parameter (ceil(numel / n) elements, rank r's from r·ceil(numel /
  n)): at stage 1 the gradients are averaged over the sharding group, and
  each rank keeps the moments of, and updates, its slice, then the
  updated slices are all-gathered into every rank's full parameter; at
  stage 2 each gradient is reduce-scattered instead, so that a rank keeps
  only its slice's averaged gradient (the full one freed before the
  update), and the clip's global norm is the sum of the slices' squares
  over the group; at stage 3 each parameter is held as its slice between
  steps (``shard_parameter``), gathered at use and released after;
- the group-sharded wrappers (reference sharding/group_sharded.py,
  :238-297 here): ``GroupShardedOptimizerStage2`` (stage 2),
  ``GroupShardedStage2`` (a model whose gradients are reduce-scattered into
  the optimizer's slices as each is accumulated), ``GroupShardedStage3`` (a
  model whose parameters live as slices: a forward pre-hook on each layer
  that holds parameters gathers them through ``gather_leaf`` (mp_ops), whose
  backward reduce-scatters their gradient, and a post-hook releases them;
  under ``recompute`` the gather runs again in the backward) and
  ``group_sharded_parallel`` (levels "os", "os_g", "p_g_os"). Their
  ``state_dict`` holds full tensors, as the reference's global arrays, and
  ``set_state_dict`` takes full tensors and slices them.

The numbers are those of the unsharded step: the gradients averaged over
the group, the global-norm clip over the whole gradients, AdamW on each
element.
"""
from __future__ import annotations

import math

import torch

from ...core.tensor import Tensor, to_torch
from .. import collective
from ..fleet.layers.mpu.mp_ops import (_live, gather_along, gather_leaf,
                                       reduce_scatter_along)
from ..topology import get_hybrid_communicate_group
from .engines import MetaParallelBase

__all__ = ["all_gather_params", "stage3_forward", "shard_parameter",
           "DygraphShardingOptimizer", "DygraphShardingOptimizerV2",
           "GroupShardedOptimizerStage2", "GroupShardedStage2",
           "GroupShardedStage3", "group_sharded_parallel"]


def all_gather_params(shards, group=None, dim=0):
    """A dict (nested) of parameter shards, each split along ``dim`` over
    ``group`` (None: the hybrid group's sharding group) -> the full
    parameters, differentiable: the backward reduce-scatters each
    gradient."""
    if group is None:
        group = get_hybrid_communicate_group().get_sharding_parallel_group()
    return {k: all_gather_params(v, group, dim) if isinstance(v, dict)
            else gather_leaf(v, group, dim) for k, v in shards.items()}


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
        full[k] = gather_leaf(s, group, dim, buf)
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


def _nranks(group):
    return 1 if group is None or not _live(group) else group.nranks


def _bounds(numel, group):
    """(c, lo, hi): the slice length ceil(numel / n) and this rank's range
    [lo, hi) of the flat parameter (the last rank's may be shorter)."""
    n = _nranks(group)
    c = math.ceil(numel / n)
    lo = min(group.rank * c if n > 1 else 0, numel)
    return c, lo, min(lo + c, numel)


def _padded(flat, n, c):
    """A flat tensor padded with zeros to n·c elements."""
    if flat.numel() == n * c:
        return flat
    return torch.cat([flat, flat.new_zeros(n * c - flat.numel())])


def _gather_flat(piece, group, numel):
    """The full flat tensor from every rank's padded slice (no grad)."""
    if _nranks(group) == 1:
        return piece[:numel]
    return gather_along(piece.detach(), group, 0)[:numel]


class _Stage3Record:
    """A stage-3 parameter: its full shape and size, its group, and the
    leaf holding this rank's padded flat slice (ceil(numel / n)
    elements)."""

    __slots__ = ("shape", "numel", "group", "shard")

    def __init__(self, shape, numel, group, shard):
        self.shape, self.numel, self.group, self.shard = \
            shape, numel, group, shard


def shard_parameter(p, group):
    """Hold the Parameter ``p`` as this rank's padded flat slice over
    ``group`` (stage 3): ``p._value`` becomes that slice, a leaf with p's
    requires_grad. Idempotent."""
    if p._stage3 is not None:
        return
    full = p._value.detach()
    c, lo, hi = _bounds(full.numel(), group)
    piece = full.new_zeros(c)
    piece[:hi - lo] = full.reshape(-1)[lo:hi]
    piece.requires_grad_(p._value.requires_grad)
    p._stage3 = _Stage3Record(tuple(full.shape), full.numel(), group, piece)
    p._value = piece


def _gather_param(p):
    """A stage-3 parameter's full value, differentiable: all-gathered
    through gather_leaf, whose backward reduce-scatters (sums) the
    gradient into the slice's ``.grad``."""
    rec = p._stage3
    flat = rec.shard if _nranks(rec.group) == 1 else \
        gather_leaf(rec.shard, rec.group, 0)
    return flat[:rec.numel].view(rec.shape)


def _release(p):
    """Back to the slice: the full value is dropped (autograd keeps what
    it saved; under recompute, nothing)."""
    if p._stage3 is not None:
        p._value = p._stage3.shard


def _full_value(p):
    """p's full value (collective for a stage-3 parameter), detached."""
    rec = p._stage3
    if rec is None:
        return p._value.detach()
    return _gather_flat(rec.shard, rec.group, rec.numel).view(rec.shape)


def _resolve_group(group):
    """``group``, else the hybrid group's sharding group, else the
    world."""
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_sharding_parallel_group()
    return collective._get_default_group()


class DygraphShardingOptimizer:
    """ZeRO over the sharding group (``group``, else ``hcg``'s): each
    rank's moments and update cover its flat slice of each parameter
    (ceil(numel / n) elements). Stage 1: the gradients all-reduced, the
    updated slices all-gathered back. Stage 2: each gradient
    reduce-scattered into this rank's slice (or taken from the slices a
    GroupShardedStage2 model reduced), the full gradient freed; the clip's
    norm over the slices, summed over the group. Stage 3: the parameters
    held as their slices (``shard_parameter``); their gradients arrive
    reduce-scattered (a GroupShardedStage3 model's gathers), and the
    update runs on the slices in place."""

    def __init__(self, optimizer, hcg=None, stage: int = 1, group=None):
        if stage not in (1, 2, 3):
            raise ValueError(f"sharding stage {stage}: 1, 2 or 3")
        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._group = group if group is not None else (
            None if self._hcg is None
            else self._hcg.get_sharding_parallel_group())
        self.stage = stage
        self._slices = {}
        self._grad_slices = {}
        if stage == 3:
            for p in optimizer._parameter_list:
                shard_parameter(p, self._group)

    @property
    def _n(self):
        return _nranks(self._group)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _bounds(self, numel):
        return _bounds(numel, self._group)

    def _slice_of(self, p):
        """The Tensor the update runs on: at stage 3 ``p`` itself (its
        value is its slice), else one over this rank's flat slice of ``p``
        (a view: the inner optimizer's update writes into ``p``); one
        object a parameter, so its moments persist."""
        if p._stage3 is not None:
            return p
        _, lo, hi = self._bounds(p._value.numel())
        view = p._value.detach().view(-1)[lo:hi]
        s = self._slices.get(id(p))
        if s is None:
            s = self._slices[id(p)] = Tensor._wrap(view)
            s.name = p.name
        else:
            s._value = view
        return s

    def release_params(self):
        """Every stage-3 parameter back to its slice (a recomputation that
        stopped early may leave a gathered value behind)."""
        for p in self._inner_opt._parameter_list:
            _release(p)

    @torch.no_grad()
    def _reduce_to_slice(self, p, grad):
        """The group's average of ``grad`` on this rank's slice, added to
        the slices kept for the step."""
        n = self._n
        c, lo, hi = self._bounds(grad.numel())
        flat = grad.reshape(-1)
        if n > 1:
            flat = reduce_scatter_along(_padded(flat, n, c), self._group,
                                        0)[:hi - lo]
            flat.div_(n)
        else:
            flat = flat.clone()
        have = self._grad_slices.get(id(p))
        self._grad_slices[id(p)] = flat if have is None else have + flat

    @torch.no_grad()
    def reduce_gradients(self):
        """Stage 1: every gradient averaged over the sharding group. Stage
        2: each full gradient reduce-scattered into this rank's slice and
        freed. Stage 3: the slices' gradients (sums) divided by n."""
        params = self._inner_opt._parameter_list
        if self.stage == 1:
            if _live(self._group):
                for p in params:
                    if p._value.grad is not None:
                        collective.all_reduce(p._value.grad,
                                              op=collective.ReduceOp.AVG,
                                              group=self._group)
            return
        self.release_params()
        for p in params:
            g = p._value.grad
            if g is None:
                continue
            if self.stage == 2:
                self._reduce_to_slice(p, g)
                p._value.grad = None
            else:
                self._grad_slices[id(p)] = g.div_(self._n) if self._n > 1 \
                    else g

    def step(self):
        self.reduce_gradients()
        self.sharded_update()

    def _clipped(self, live, grads):
        """The inner optimizer's global-norm clip over the slices: their
        squares summed over the sharding group (and, under a hybrid clip,
        over mp and pp as it counts them)."""
        clip = self._inner_opt._grad_clip
        if clip is None:
            return grads
        from .hybrid_optimizer import _HybridClip

        if isinstance(clip, _HybridClip):
            norm = clip.global_norm(grads, [p for _, p in live],
                                    sharding=self._group)
        else:
            sq = torch.zeros((), dtype=torch.float32,
                             device=grads[0].device)
            for g in grads:
                sq = sq + g.float().square().sum()
            if _live(self._group):
                collective.all_reduce(sq, group=self._group)
            norm = torch.sqrt(sq)
        if norm is None:
            return grads
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    @torch.no_grad()
    def sharded_update(self):
        """The inner optimizer's step on this rank's slices (stage 1: its
        clip over the full gradients; stages 2-3: over the slices, summed
        over the group), then at stages 1-2 every parameter's slices
        gathered."""
        inner = self._inner_opt
        if self.stage == 1:
            live = [(i, p) for i, p in enumerate(inner._parameter_list)
                    if not p.stop_gradient and p._value.grad is not None]
            if not live:
                return
            grads = [p._value.grad for _, p in live]
            if inner._grad_clip is not None:
                grads = inner._grad_clip.apply(grads)
            grads = [g.reshape(-1)[slice(*self._bounds(p._value.numel())[1:])]
                     for (_, p), g in zip(live, grads)]
        else:
            live = [(i, p) for i, p in enumerate(inner._parameter_list)
                    if not p.stop_gradient and id(p) in self._grad_slices]
            if not live:
                return
            grads = self._clipped(
                live, [self._grad_slices[id(p)] for _, p in live])
        inner._step_count += 1
        lr = float(torch.tensor(inner.get_lr(), dtype=torch.float32))
        groups = {}
        for (i, p), g in zip(live, grads):
            groups.setdefault(inner._decay(p, i), []).append(
                (self._slice_of(p), g))
        for wd, items in groups.items():
            inner._update_group(items, lr, wd)
        self._grad_slices.clear()
        if self._n > 1 and self.stage < 3:
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
        self.release_params()
        self._inner_opt.clear_grad()
        self._grad_slices.clear()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def _names(self):
        return [(p.name or f"param_{i}", p)
                for i, p in enumerate(self._inner_opt._parameter_list)]

    def _moments(self, p):
        return self._inner_opt._accumulators.get(id(self._slice_of(p))) \
            or {}

    def local_state_dict(self):
        """This rank's slices of the moments, under the inner optimizer's
        names, and the step count."""
        out = {"_step_count": self._inner_opt._step_count}
        for name, p in self._names():
            for k, v in self._moments(p).items():
                out[f"{name}.{k}"] = Tensor._wrap(v.detach().clone())
        return out

    def state_dict(self):
        """The moments whole (collective: every rank of the group calls
        it), under the inner optimizer's names, and the step count."""
        out = {"_step_count": self._inner_opt._step_count}
        for name, p in self._names():
            rec = p._stage3
            shape = rec.shape if rec is not None else tuple(p._value.shape)
            numel = math.prod(shape)
            c, lo, hi = self._bounds(numel)
            for k, v in self._moments(p).items():
                piece = v.detach()
                if rec is None:
                    piece = _padded(piece.reshape(-1), 1, c)
                out[f"{name}.{k}"] = Tensor._wrap(
                    _gather_flat(piece, self._group, numel).reshape(shape))
        return out

    def set_state_dict(self, state):
        """Restore from ``state_dict()`` (full tensors, numpy arrays or
        Tensors): each moment sliced for this rank."""
        inner = self._inner_opt
        inner._step_count = int(state.get("_step_count", 0))
        for name, p in self._names():
            prefix = name + "."
            rec = p._stage3
            numel = rec.numel if rec is not None else p._value.numel()
            c, lo, hi = self._bounds(numel)
            st = {}
            for k, v in state.items():
                if not (isinstance(k, str) and k.startswith(prefix)):
                    continue
                flat = to_torch(v, torch.float32,
                                p._value.device).reshape(-1)
                piece = flat[lo:hi]
                if rec is not None:
                    piece = _padded(piece, 1, c)
                st[k[len(prefix):]] = piece.clone()
            if st:
                inner._accumulators[id(self._slice_of(p))] = st


DygraphShardingOptimizerV2 = DygraphShardingOptimizer


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Stage 2 over ``group`` (reference group_sharded_optimizer_stage2.py:
    53); ``params`` are the inner optimizer's."""

    def __init__(self, params, optim, group=None, offload=False,
                 device=None, **kw):
        if offload:
            raise NotImplementedError(
                "paddle_tpu_torch: group-sharded offload to the host is "
                "not ported")
        super().__init__(optim, stage=2, group=_resolve_group(group))


def full_state_dict(layer, *args, **kwargs):
    """``layer.state_dict()`` with each stage-3 parameter's full value in
    place of its slice (collective)."""
    out = layer.state_dict(*args, **kwargs)
    return out.__class__(
        (k, Tensor._wrap(_full_value(v)) if getattr(v, "_stage3", None)
         is not None else v) for k, v in out.items())


@torch.no_grad()
def set_full_state_dict(layer, state_dict, *args, **kwargs):
    """``layer.set_state_dict`` of full values: a stage-3 parameter keeps
    its slice of its value. Returns (missing, unexpected)."""
    own = layer.state_dict()
    rest = {}
    for k, v in state_dict.items():
        rec = getattr(own.get(k), "_stage3", None)
        if rec is None:
            rest[k] = v
            continue
        c, lo, hi = _bounds(rec.numel, rec.group)
        flat = to_torch(v, rec.shard.dtype, rec.shard.device).reshape(-1)
        rec.shard.zero_()
        rec.shard[:hi - lo] = flat[lo:hi]
    missing, unexpected = layer.set_state_dict(rest, *args, **kwargs)
    return [k for k in missing if k not in state_dict], unexpected


class GroupShardedStage2(MetaParallelBase):
    """The model of stage 2 (reference group_sharded_stage2.py:46): as each
    parameter's gradient is accumulated it is reduce-scattered into
    ``sharding_optimizer``'s slice and the full gradient freed, so that
    no rank holds every full gradient at once. Its state_dict holds full
    tensors (MetaParallelBase's, over ``full_state_dict``)."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23, **kw):
        super().__init__(layer, None)
        opt = sharding_optimizer
        if opt is None:
            return
        for p in layer.parameters():
            if p._value.requires_grad:
                p._value.register_post_accumulate_grad_hook(
                    self._hook(opt, p))

    @staticmethod
    def _hook(opt, p):
        def hook(leaf):
            opt._reduce_to_slice(p, leaf.grad)
            leaf.grad = None
        return hook


class GroupShardedStage3(MetaParallelBase):
    """The model of stage 3 (reference group_sharded_stage3.py:85): each
    parameter held as this rank's slice (``shard_parameter``); a forward
    pre-hook on every layer that holds parameters gathers them whole
    (through gather_leaf: the gradient comes back reduce-scattered into
    the slice) and a forward post-hook releases them. Under ``recompute``
    the layers run again in the backward, and so do their gathers. Its
    state_dict holds full tensors and set_state_dict slices full ones
    (MetaParallelBase's, over ``full_state_dict``)."""

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers=False, device=None, segment_size=2 ** 20,
                 pertrain_sync_models=True, offload=False, **kw):
        if offload:
            raise NotImplementedError(
                "paddle_tpu_torch: group-sharded offload to the host is "
                "not ported")
        super().__init__(layer, None)
        shard_layer(layer, optimizer._group if optimizer is not None
                    else _resolve_group(group))


def _gather_own(layer, inputs):
    for p in layer._parameters.values():
        if p is not None and p._stage3 is not None:
            p._value = _gather_param(p)


def _release_own(layer, inputs, outputs):
    for p in layer._parameters.values():
        if p is not None:
            _release(p)


def shard_layer(layer, group):
    """Every parameter of ``layer`` held as its slice over ``group``, and
    the gather / release hooks on each layer that holds parameters (once
    a layer)."""
    for sub in layer.sublayers(include_self=True):
        if not any(p is not None for p in sub._parameters.values()):
            continue
        for p in sub._parameters.values():
            if p is not None:
                shard_parameter(p, group)
        if _gather_own not in sub._forward_pre_hooks.values():
            sub.register_forward_pre_hook(_gather_own)
            sub.register_forward_post_hook(_release_own)


_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """(model, optimizer, scaler) sharded over ``group`` (else the hybrid
    group's sharding group, else the world) at ``level``: "os" the
    optimizer state (stage 1), "os_g" and the gradients (stage 2),
    "p_g_os" and the parameters (stage 3) (reference
    python/paddle/distributed/sharding/group_sharded.py). ``dp_group`` is
    accepted and unused, as in the reference."""
    if level not in _LEVELS:
        raise ValueError(f"unknown group_sharded level {level}: one of "
                         f"{sorted(_LEVELS)}")
    group = _resolve_group(group)
    if level == "os":
        return model, DygraphShardingOptimizer(
            optimizer, stage=1, group=group), scaler
    if level == "os_g":
        opt = GroupShardedOptimizerStage2(None, optimizer, group=group,
                                          offload=offload)
        return GroupShardedStage2(model, opt), opt, scaler
    opt = DygraphShardingOptimizer(optimizer, stage=3, group=group)
    return GroupShardedStage3(model, opt, offload=offload), opt, scaler
