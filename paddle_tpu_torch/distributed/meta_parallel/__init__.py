"""meta_parallel (paddle_tpu/distributed/meta_parallel/): the
tensor-parallel layers, ZeRO stage 1, the hybrid optimizer and the model
wrappers. Pipeline parallelism (pp_layers, pipeline_parallel,
pipeline_schedules, spmd_pipeline), the segment engine and the
group-sharded stage 2-3 wrappers are not ported (ROADMAP.md, queue 1,
item 5)."""
from .engines import MetaParallelBase, ShardingParallel, TensorParallel
from .hybrid_optimizer import HybridParallelOptimizer
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .sharding_optimizer import (DygraphShardingOptimizer,
                                 DygraphShardingOptimizerV2,
                                 all_gather_params, stage3_forward)

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "HybridParallelOptimizer", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "DygraphShardingOptimizer",
           "DygraphShardingOptimizerV2", "all_gather_params",
           "stage3_forward"]
