"""Hybrid-parallel model wrappers (paddle_tpu/distributed/meta_parallel/
engines.py; reference fleet/meta_parallel/tensor_parallel.py,
sharding_parallel.py, segment_parallel.py).

In the TPU package one process holds every array, so its wrappers have
nothing to synchronize. Here each rank starts from its own copy, and the
wrapper makes the copies agree before training: TensorParallel broadcasts
every parameter over the data-parallel, sep and sharding groups from their
first rank, and the replicated (not ``is_distributed``) ones over the
model-parallel group from its first rank; ShardingParallel broadcasts over
the sharding group; SegmentParallel over the data-parallel and sep
groups. Under ZeRO stage 3 TensorParallel and
ShardingParallel then hold every parameter as its slice over the sharding
group, gathered at use (sharding_optimizer.py::shard_layer).
None of them splits the inputs or reduces a gradient (the reference's
SegmentParallel neither: engines.py:83-88); a model run over 'sep' splits
the sequence and runs its attention as a ring itself
(ops/kernels/ring_attention.py).
"""
from __future__ import annotations

from ...nn.layer.layers import Layer
from .. import collective
from ..fleet.layers.mpu.mp_ops import _live

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "SegmentParallel"]


def _broadcast_params(params, group):
    if group is None or group.nranks <= 1 or not _live(group):
        return
    for p in params:
        collective.broadcast(p, src=group.ranks[0], group=group)


class MetaParallelBase(Layer):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        """Full tensors (under stage 3 gathered: collective)."""
        from .sharding_optimizer import full_state_dict

        return full_state_dict(self._layers, *args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        from .sharding_optimizer import set_full_state_dict

        return set_full_state_dict(self._layers, state_dict, *args,
                                   **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def sublayers(self, include_self=False):
        return self._layers.sublayers(include_self)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self


    def _stage3(self):
        """Under ZeRO stage 3 (``sharding_configs["stage"]`` 3 with
        sharding > 1) every parameter held as its slice over the sharding
        group, gathered by each layer's forward pre-hook
        (sharding_optimizer.py::shard_layer)."""
        cfg = {} if self._strategy is None else \
            self._strategy.hybrid_configs.get("sharding_configs", {}) or {}
        if cfg.get("stage", 1) == 3 and \
                self._hcg.get_sharding_parallel_world_size() > 1:
            from .sharding_optimizer import shard_layer

            shard_layer(self._layers,
                        self._hcg.get_sharding_parallel_group())


class TensorParallel(MetaParallelBase):
    def _prepare_for_model(self):
        params = list(self._layers.parameters())
        _broadcast_params(params, self._hcg.get_data_parallel_group())
        _broadcast_params(params, self._hcg.get_sep_parallel_group())
        _broadcast_params(params, self._hcg.get_sharding_parallel_group())
        _broadcast_params(
            [p for p in params if not getattr(p, "is_distributed", False)],
            self._hcg.get_model_parallel_group())
        self._stage3()


class ShardingParallel(MetaParallelBase):
    """Model wrapper for a sharding-only topology: the optimizer
    (sharding_optimizer.py) partitions the state; at stage 3 the
    parameters too."""

    def _prepare_for_model(self):
        _broadcast_params(list(self._layers.parameters()),
                          self._hcg.get_sharding_parallel_group())
        self._stage3()


class SegmentParallel(MetaParallelBase):
    """Model wrapper for a segment-parallel (sep) topology (reference
    fleet/meta_parallel/segment_parallel.py:26): every parameter broadcast
    over the data-parallel and the sep groups from their first rank."""

    def _prepare_for_model(self):
        params = list(self._layers.parameters())
        _broadcast_params(params, self._hcg.get_data_parallel_group())
        _broadcast_params(params, self._hcg.get_sep_parallel_group())
