"""HybridParallelOptimizer (paddle_tpu/distributed/meta_parallel/
hybrid_optimizer.py; reference fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py:255).

The TPU package's parameters are full global arrays, so its clip's local
norm is the global one. Here each rank holds shards, and the step is, in
order:

1. the gradients averaged over the data-parallel group (dp > 1);
2. with sharding > 1, the update left to DygraphShardingOptimizer at
   ``sharding_configs["stage"]``: stage 1 averages the gradients over the
   sharding group, stage 2 reduce-scatters each into this rank's slice,
   stage 3 takes the slices its gathers reduce-scattered (the model
   wrapped by ``fleet.distributed_model``, whose pre-hooks gather the
   parameters; sharding_optimizer.py);
3. the global-norm clip (``_HybridClip``; at stages 2-3 over the slices,
   their squares summed over the sharding group), which counts each
   logical element once: a distributed (mp-split) parameter's sum of squares is
   summed over the model-parallel group, a replicated one's (the RMSNorm
   weights, a replicated LM head) is taken once, since every mp rank holds
   the same gradient for it; over pp the stages' sums are added (each
   stage holds its own layers), a shared weight counted on the first
   stage that holds it only (``is_firstly_shared``);
4. the inner optimizer's update.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import ClipGradByGlobalNorm
from .. import collective
from ..fleet.layers.mpu.mp_ops import _live, all_reduce_live

__all__ = ["HybridParallelOptimizer"]


class _HybridClip:
    """ClipGradByGlobalNorm over the hybrid topology; ``apply`` takes the
    gradients of the optimizer's live parameters, in its order."""

    def __init__(self, inner_clip, hcg, parameters):
        self._clip = inner_clip
        self._hcg = hcg
        self._params = parameters
        self.clip_norm = inner_clip.clip_norm

    def global_norm(self, grads, params=None, sharding=None):
        """The norm of ``grads``, the gradients of ``params`` (None: the
        optimizer's parameters that hold a gradient). With ``sharding``
        (ZeRO stages 2-3) each gradient is this rank's slice, and the
        squares are summed over that group too."""
        live = params if params is not None else [
            p for p in self._params
            if not p.stop_gradient and p._value.grad is not None]
        pp = self._hcg.get_pipe_parallel_group()
        if not live and not (_live(pp) and pp.nranks > 1):
            return None
        dist_sq, rep_sq = [], []
        for p, g in zip(live, grads):
            if not getattr(p, "is_firstly_shared", True):
                continue
            (dist_sq if getattr(p, "is_distributed", False) else
             rep_sq).append(g.float().square().sum())
        zero = torch.zeros((), dtype=torch.float32,
                           device=self._params[0]._value.device)
        total = sum(dist_sq, zero)
        rep = sum(rep_sq, zero)
        if sharding is not None:
            both = torch.stack([total, rep])
            all_reduce_live(both, sharding)
            total, rep = both[0], both[1]
        all_reduce_live(total, self._hcg.get_model_parallel_group())
        total = total + rep
        all_reduce_live(total, pp)
        return torch.sqrt(total)

    def apply(self, grads):
        norm = self.global_norm(grads)
        if norm is None:
            return grads
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [None if g is None else (g.float() * scale).to(g.dtype)
                for g in grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if isinstance(getattr(optimizer, "_grad_clip", None),
                      ClipGradByGlobalNorm):
            optimizer._grad_clip = _HybridClip(
                optimizer._grad_clip, hcg, optimizer._parameter_list)
        self._sharding = None
        if hcg.get_sharding_parallel_world_size() > 1:
            from .sharding_optimizer import DygraphShardingOptimizer

            stage = 1
            if strategy is not None:
                stage = strategy.hybrid_configs.get(
                    "sharding_configs", {}).get("stage", 1) or 1
            self._sharding = DygraphShardingOptimizer(optimizer, hcg,
                                                      stage=stage)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    @torch.no_grad()
    def _reduce_data_parallel(self):
        group = self._hcg.get_data_parallel_group()
        if group.nranks > 1 and _live(group):
            for p in self._inner_opt._parameter_list:
                if p._value.grad is not None:
                    collective.all_reduce(p._value.grad,
                                          op=collective.ReduceOp.AVG,
                                          group=group)

    def step(self):
        if self._sharding is not None:
            self._sharding.release_params()
        self._reduce_data_parallel()
        if self._sharding is not None:
            self._sharding.step()
        else:
            self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        (self._sharding or self._inner_opt).clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        return (self._sharding or self._inner_opt).state_dict()

    def set_state_dict(self, state):
        return (self._sharding or self._inner_opt).set_state_dict(state)

    @property
    def _learning_rate(self):
        return self._inner_opt._learning_rate

    @property
    def _parameter_list(self):
        return self._inner_opt._parameter_list
