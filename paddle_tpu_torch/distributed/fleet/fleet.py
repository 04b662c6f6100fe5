"""The Fleet facade (paddle_tpu/distributed/fleet/fleet.py; reference
fleet/fleet.py: init:167, distributed_model via model.py:32,
distributed_optimizer:1326).

``init`` starts the process's rank (init_parallel_env) and builds the
hybrid topology over the world: its degrees from
``strategy.hybrid_configs``, a dp degree of -1 (or 1 while the others
leave ranks over) taking what is left. ``distributed_model`` picks the
wrapper by parallel mode and ``distributed_optimizer`` wraps the optimizer
in HybridParallelOptimizer; the pipeline mode picks the engine by
``pp_configs["schedule_mode"]`` and the PipelineLayer's virtual stages
(fleet.py:155-172); the segment-parallel mode wraps the model in
SegmentParallel. The parameter-server mode raises NotImplementedError
(ROADMAP.md, queue 1, item 5).
"""
from __future__ import annotations

import math
from typing import Optional

from .. import collective
from .. import env as _env
from .. import topology as _topology
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .base import DistributedStrategy

__all__ = ["init", "is_initialized", "distributed_model",
           "distributed_optimizer", "distributed_scaler",
           "get_hybrid_communicate_group", "worker_num", "worker_index",
           "is_first_worker", "is_worker", "is_server", "worker_endpoints",
           "barrier_worker", "server_num", "init_server", "run_server",
           "stop_server", "init_worker", "stop_worker"]

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}

_NOT_PORTED = "is not ported (ROADMAP.md, queue 1, item 5)"


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO", backend=None):
    """Collective Fleet: the rank's process group (``backend`` as
    init_parallel_env takes it) and the hybrid topology of
    ``strategy.hybrid_configs``."""
    if role_maker is not None and not getattr(role_maker, "_is_collective",
                                              True):
        raise NotImplementedError(f"parameter-server Fleet {_NOT_PORTED}")
    _env.init_parallel_env(backend)
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    degrees = {a: int(hc.get(f"{a}_degree", 1) or 1)
               for a in ("dp", "pp", "sharding", "sep", "mp")}
    world = _env.get_world_size()
    others = math.prod(v for k, v in degrees.items() if k != "dp")
    if degrees["dp"] == -1 or (degrees["dp"] == 1 and others < world):
        degrees["dp"] = max(world // others, 1)
    topo = CommunicateTopology(list(degrees), list(degrees.values()))
    hcg = HybridCommunicateGroup(topo)
    hcg.build_mesh()
    _topology.set_hybrid_communicate_group(hcg)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _fleet_state["hcg"]


def _hcg() -> HybridCommunicateGroup:
    if _fleet_state["hcg"] is None:
        init(is_collective=True)
    return _fleet_state["hcg"]


def distributed_model(model):
    """The model wrapped for the parallel mode (reference model.py:32)."""
    from ..meta_parallel import (SegmentParallel, ShardingParallel,
                                 TensorParallel)
    from ..parallel import DataParallel

    hcg = _hcg()
    strategy = _fleet_state["strategy"]
    mode = hcg.get_parallel_mode()
    if mode == "single":
        return model
    if mode == "data_parallel":
        return DataParallel(model, group=hcg.get_data_parallel_group())
    if mode == "tensor_parallel":
        return TensorParallel(model, hcg, strategy=strategy)
    if mode == "sharding_parallel":
        return ShardingParallel(model, hcg, strategy=strategy)
    if mode == "segment_parallel":
        return SegmentParallel(model, hcg, strategy=strategy)
    if mode == "pipeline":
        from ..meta_parallel.pipeline_parallel import (
            PipelineParallel, PipelineParallelWithInterleave,
            PipelineParallelZeroBubble)
        from ..meta_parallel.pp_layers import PipelineLayer

        pp_cfg = dict(strategy.hybrid_configs.get("pp_configs", {}) or {}) \
            if strategy is not None else {}
        sched = str(pp_cfg.get("schedule_mode", "1F1B")).upper()
        v = model.get_num_virtual_stages() \
            if isinstance(model, PipelineLayer) else 1
        if sched in ("ZBH1", "ZB-H1", "ZERO_BUBBLE"):
            return PipelineParallelZeroBubble(model, hcg, strategy=strategy)
        if v > 1 or sched == "VPP":
            return PipelineParallelWithInterleave(
                model, hcg, strategy=strategy,
                num_virtual_pipeline_stages=max(v, 1))
        return PipelineParallel(model, hcg, strategy=strategy)
    raise NotImplementedError(f"Fleet's {mode} mode {_NOT_PORTED}")


def distributed_optimizer(optimizer, strategy=None):
    """HybridParallelOptimizer over the hybrid group (reference
    fleet.py:1326)."""
    from ..meta_parallel.hybrid_optimizer import HybridParallelOptimizer

    return HybridParallelOptimizer(
        optimizer, _hcg(), _fleet_state["strategy"] or strategy)


def distributed_scaler(scaler):
    return scaler


def worker_num():
    return _env.get_world_size()


def worker_index():
    return _env.global_rank()


def is_worker():
    return True


def is_server():
    return False


def server_num():
    return 0


def is_first_worker():
    return worker_index() == 0


def worker_endpoints(to_string=False):
    eps = _env.ParallelEnv().trainer_endpoints
    return ",".join(eps) if to_string else eps


def barrier_worker():
    collective.barrier()


def _ps(*args, **kwargs):
    raise NotImplementedError(f"parameter-server Fleet {_NOT_PORTED}")


init_server = run_server = stop_server = init_worker = stop_worker = _ps
