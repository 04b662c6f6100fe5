"""meta_parallel (paddle_tpu/distributed/meta_parallel/): the
tensor-parallel layers, ZeRO stages 1-3 and the group-sharded wrappers
(group_sharded_parallel), the hybrid optimizer, the model wrappers
(TensorParallel, ShardingParallel, SegmentParallel), and pipeline
parallelism (pp_layers, pipeline_schedules, the 1F1B / interleaved /
zero-bubble engines and spmd_pipeline)."""
from .engines import (MetaParallelBase, SegmentParallel, ShardingParallel,
                      TensorParallel)
from .hybrid_optimizer import HybridParallelOptimizer
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from . import pipeline_schedules
from .pipeline_parallel import (PipelineParallel,
                                PipelineParallelWithInterleave,
                                PipelineParallelZeroBubble, spmd_pipeline,
                                spmd_pipeline_interleaved)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .sharding_optimizer import (DygraphShardingOptimizer,
                                 DygraphShardingOptimizerV2,
                                 GroupShardedOptimizerStage2,
                                 GroupShardedStage2, GroupShardedStage3,
                                 all_gather_params, group_sharded_parallel,
                                 stage3_forward)

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "SegmentParallel",
           "HybridParallelOptimizer", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "pipeline_schedules", "PipelineParallel",
           "PipelineParallelWithInterleave", "PipelineParallelZeroBubble",
           "spmd_pipeline", "spmd_pipeline_interleaved", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc", "DygraphShardingOptimizer",
           "DygraphShardingOptimizerV2", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "all_gather_params", "stage3_forward"]
