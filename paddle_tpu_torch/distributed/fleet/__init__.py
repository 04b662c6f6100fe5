"""fleet (paddle_tpu/distributed/fleet/): collective Fleet, its
tensor-parallel layers, recompute, sequence parallelism
(sequence_parallel_utils) and HybridTrainer."""
from . import base
from .base import DistributedStrategy
from .fleet import (barrier_worker, distributed_model, distributed_optimizer,
                    distributed_scaler, get_hybrid_communicate_group, init,
                    init_server, init_worker, is_first_worker, is_initialized,
                    is_server, is_worker, run_server, server_num, stop_server,
                    stop_worker, worker_endpoints, worker_index, worker_num)
from . import layers
from .recompute import recompute
from . import sequence_parallel_utils
from .trainer import HybridTrainer
from .. import meta_parallel
from ..meta_parallel import (ColumnParallelLinear, ParallelCrossEntropy,
                             RowParallelLinear, VocabParallelEmbedding)
from ..topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "init", "is_initialized",
           "distributed_model", "distributed_optimizer",
           "distributed_scaler", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker", "is_worker",
           "is_server", "server_num", "worker_endpoints", "barrier_worker",
           "init_server", "run_server", "stop_server", "init_worker",
           "stop_worker", "layers", "recompute", "sequence_parallel_utils",
           "HybridTrainer",
           "meta_parallel", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "CommunicateTopology", "HybridCommunicateGroup"]
