"""paddle_tpu_torch.distributed (paddle_tpu/distributed): collectives over
torch.distributed, the hybrid topology, collective Fleet, the
tensor-parallel layers, ZeRO stages 1-3 and group_sharded_parallel,
DataParallel, HybridTrainer, and the MoE exchange (``utils``:
global_scatter, global_gather).

The TPU package is single-controller: one process holds every parameter as
a full array, GSPMD inserts the collectives, and its ``spawn`` runs the
function once, in-process. The port follows PaddlePaddle's multi-process
Fleet: one process a card (NCCL; gloo for CPU ranks), each rank holding
only its shards. ``spawn`` starts real processes (torch.multiprocessing,
start method "spawn"), each with the launcher's environment
(env.py: PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS);
the function calls init_parallel_env (or fleet.init) itself, as in Paddle.

Pipeline parallelism (meta_parallel: PipelineLayer, the 1F1B, interleaved
and zero-bubble engines, spmd_pipeline) sends the activations between the
pp ranks over point-to-point groups of the topology. Sequence-dimension
parallelism runs attention as a ring over the sep group
(ops/kernels/ring_attention.py, HybridTrainer's 'sep' axis,
SegmentParallel), and Megatron's sequence parallelism over mp
(fleet/sequence_parallel_utils.py). MoE expert parallelism
(incubate/distributed/models/moe: moe_block_stacked over an expert group)
exchanges tokens with all_to_all_single.

The semi-auto API (auto_parallel: ProcessMesh, the placements,
shard_tensor, reshard, to_static and the Engine) runs over
``torch.distributed.tensor`` (DTensor). ``python -m
paddle_tpu_torch.distributed.launch`` starts one worker a card with the
environment above, its rendezvous through the store (store.py).

Training resilience: the eager TCP tensor transport (transport.py), the
comm watchdog (watchdog.py), the distributed checkpoint with
reshard-on-load (checkpoint), the elastic manager (elastic.py) and the
self-healing supervisor with its checkpoint tiers (resilience).
"""
from __future__ import annotations

import os
import time

from . import (auto_parallel, checkpoint, collective, elastic, env, fleet,
               meta_parallel, resilience, topology, utils)
from .auto_parallel.api import (DistModel, dtensor_from_fn, reshard,
                                shard_layer, shard_optimizer, shard_tensor,
                                to_static, unshard_dtensor)
from .auto_parallel.placement import Partial, Placement, Replicate, Shard
from .auto_parallel.process_mesh import ProcessMesh
from .checkpoint import load_state_dict, save_state_dict
from .collective import (P2POp, ReduceOp, all_gather, all_gather_object,
                         all_reduce, all_to_all, all_to_all_single, barrier,
                         batch_isend_irecv, broadcast, broadcast_object_list,
                         destroy_process_group, gather, get_backend,
                         get_group, irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, scatter_object_list, send,
                         stream, wait)
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .parallel import DataParallel
from .resilience.recovery import (latest_checkpoint, resume_from_latest,
                                  save_checkpoint)
from .topology import (HybridCommunicateGroup, build_mesh,
                       get_hybrid_communicate_group, get_mesh)
from .watchdog import (comm_task_manager, disable_comm_watchdog,
                       enable_comm_watchdog)

__all__ = ["auto_parallel", "checkpoint", "collective", "elastic", "env",
           "fleet", "meta_parallel", "resilience", "topology", "utils",
           "spawn", "save_state_dict", "load_state_dict",
           "save_checkpoint", "latest_checkpoint", "resume_from_latest",
           "comm_task_manager", "enable_comm_watchdog",
           "disable_comm_watchdog",
           "shard_tensor", "reshard", "shard_layer", "shard_optimizer",
           "to_static", "dtensor_from_fn", "unshard_dtensor", "DistModel",
           "ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "ReduceType", "ShardingStage1", "ShardingStage2",
           "ShardingStage3", "Strategy", "DistAttr", "split",
           "shard_dataloader", "shard_scaler",
           "P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all", "all_to_all_single", "barrier",
           "batch_isend_irecv", "broadcast", "broadcast_object_list",
           "destroy_process_group", "gather", "get_backend", "get_group",
           "irecv", "isend", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "scatter_object_list", "send",
           "stream", "wait", "ParallelEnv", "get_rank", "get_world_size",
           "init_parallel_env", "is_initialized", "DataParallel",
           "HybridCommunicateGroup", "build_mesh",
           "get_hybrid_communicate_group", "get_mesh", "alltoall",
           "alltoall_single", "get_trainer_endpoints",
           "get_current_endpoint", "is_available"]

alltoall = all_to_all
alltoall_single = all_to_all_single


class ReduceType:
    """The reduction of a Partial placement (reference auto_parallel
    ReduceType); ``Partial(ReduceType.kRedMax)`` is ``Partial("max")``."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


class ShardingStage1:
    """The to_static sharding level (reference auto_parallel/strategy.py
    ShardingStage1), accepted as the reference accepts it."""

    def __init__(self, mesh_dim=None):
        self.mesh_dim = mesh_dim
        self.stage = 1


class ShardingStage2(ShardingStage1):
    def __init__(self, mesh_dim=None):
        super().__init__(mesh_dim)
        self.stage = 2


class ShardingStage3(ShardingStage1):
    def __init__(self, mesh_dim=None):
        super().__init__(mesh_dim)
        self.stage = 3


class Strategy:
    """reference auto_parallel Strategy: the to_static configuration
    (sharding, gradient_merge, pipeline and amp as attribute bags, from an
    optional dict). The Engine honours ``amp``."""

    class _Bag:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self, config=None):
        cfg = config or {}

        def bag(key, **defaults):
            merged = dict(defaults)
            merged.update(cfg.get(key, {}))
            return Strategy._Bag(**merged)

        self.sharding = bag("sharding", enable=False, degree=1, stage=1)
        self.gradient_merge = bag("gradient_merge", enable=False,
                                  k_steps=1, avg=True)
        self.pipeline = bag("pipeline", enable=False,
                            schedule_mode="1F1B", micro_batch_size=1,
                            accumulate_steps=1)
        self.amp = bag("amp", enable=False, dtype="bfloat16", level="O1")


class DistAttr:
    """reference DistAttr(mesh, sharding_specs): the spec form (a mesh
    axis name or None a tensor dim) mapped onto placements."""

    def __init__(self, mesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs)

    def placements(self):
        out = []
        for dim_name in getattr(self.process_mesh, "dim_names",
                                [None] * 1):
            try:
                idx = self.sharding_specs.index(dim_name)
                out.append(Shard(idx))
            except ValueError:
                out.append(Replicate())
        return out


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference distributed.split: a row- or column-parallel linear, or
    a vocab-parallel embedding, over the model-parallel group, applied to
    ``x``."""
    from .meta_parallel import mp_layers as _mp

    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = _mp.RowParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                input_is_parallel=False, has_bias=bias_attr is not False)
        else:
            layer = _mp.ColumnParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                gather_output=gather_out,
                has_bias=bias_attr is not False)
        return layer(x)
    if operation == "embedding":
        n, dim = size
        layer = _mp.VocabParallelEmbedding(n, dim, weight_attr=weight_attr)
        return layer(x)
    raise ValueError(f"unsupported operation {operation}")


def shard_dataloader(dataloader, meshes, shard_dims=None, is_dataset=False):
    """reference auto_parallel shard_dataloader: every rank iterates the
    global batches and the Engine takes each rank's rows
    (static_engine.py::_stage_batch), so the loader passes through."""
    return dataloader


def shard_scaler(scaler):
    """reference auto_parallel shard_scaler: the scaler's state is
    replicated, nothing to change."""
    return scaler


def is_available():
    import torch.distributed as tdist

    return tdist.is_available()


def get_trainer_endpoints():
    return ParallelEnv().trainer_endpoints


def get_current_endpoint():
    return ParallelEnv().current_endpoint


def _spawn_entry(index, func, args, environ):
    import faulthandler

    faulthandler.enable()     # a rank that dies on a signal shows where
    os.environ.update(environ)
    os.environ["PADDLE_TRAINER_ID"] = str(index)
    os.environ["PADDLE_LOCAL_RANK"] = str(index)
    eps = environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    os.environ["PADDLE_CURRENT_ENDPOINT"] = eps[index]
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes, one a rank
    (reference: paddle.distributed.spawn). ``nprocs`` -1 takes every
    visible card. Options: ``backend`` ("nccl" or "gloo", given to the
    ranks as PADDLE_DISTRI_BACKEND) and ``timeout`` (seconds: past it every
    rank is killed and TimeoutError raised). A rank that raises ends the
    others and the error is raised here. With ``join=False`` returns the
    torch ProcessContext."""
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as tmp

    if nprocs == -1:
        nprocs = torch.cuda.device_count()
    if nprocs < 1:
        raise ValueError("spawn needs nprocs >= 1 (no CUDA card is visible "
                         "for nprocs=-1)")
    # the rendezvous store lives here, on a port the OS gave it and held
    # from the start (a port found free and bound later by rank 0 can be
    # taken meanwhile); the ranks reach it as torch's elastic agent's store
    store = tdist.TCPStore("127.0.0.1", 0, nprocs, True,
                           wait_for_workers=False)
    environ = {"PADDLE_TRAINERS_NUM": str(nprocs),
               # the first endpoint is the rendezvous; the others name
               # the ranks
               "PADDLE_TRAINER_ENDPOINTS": ",".join(
                   f"127.0.0.1:{store.port + i}" for i in range(nprocs)),
               "TORCHELASTIC_USE_AGENT_STORE": "True",
               "TORCHELASTIC_RESTART_COUNT": "0"}
    if options.get("backend"):
        environ["PADDLE_DISTRI_BACKEND"] = options["backend"]
    ctx = tmp.start_processes(_spawn_entry, args=(func, tuple(args),
                                                  environ),
                              nprocs=nprocs, join=False, daemon=daemon,
                              start_method="spawn")
    ctx.rendezvous_store = store        # held while the ranks run
    if not join:
        return ctx
    timeout = options.get("timeout")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None else
                           max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"spawn: {nprocs} ranks did not finish "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return ctx
