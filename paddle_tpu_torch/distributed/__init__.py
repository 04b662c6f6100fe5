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

Not ported yet (ROADMAP.md, queue 1): auto_parallel and launch; the store,
transport, watchdog, resilience supervisor and checkpoint tiers (items 6
and 8).
"""
from __future__ import annotations

import os
import time

from . import (collective, env, fleet, meta_parallel, resilience, topology,
               utils)
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
from .topology import (HybridCommunicateGroup, build_mesh,
                       get_hybrid_communicate_group, get_mesh)

__all__ = ["collective", "env", "fleet", "meta_parallel", "resilience",
           "topology", "utils", "spawn",
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
