"""DistributedStrategy (paddle_tpu/distributed/fleet/base.py; reference
fleet/base/distributed_strategy.py:175): a plain config object with the
field names Fleet scripts set. The parameter-server role makers are not
ported (ROADMAP.md, queue 1, item 5)."""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Dotted(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
            "mp_configs": _Dotted(),
            "pp_configs": _Dotted(micro_batch_size=1, accumulate_steps=1,
                                  schedule_mode="1F1B"),
            "sharding_configs": _Dotted(stage=1, offload=False),
        }
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "sharding_degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"
