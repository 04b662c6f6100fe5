"""Process environment (paddle_tpu/distributed/env.py).

The TPU package is single-controller: one process drives every chip and a
"rank" is a host. The port follows PaddlePaddle's own multi-process
collective mode instead: one process a card, each with its own rank in a
``torch.distributed`` world. ``init_parallel_env`` reads the launcher's
environment under the reference's names (env.py:29-58):

- ``PADDLE_TRAINER_ID``: this process's rank;
- ``PADDLE_TRAINERS_NUM``: the world size;
- ``PADDLE_TRAINER_ENDPOINTS``: "host:port,..." a rank; the first is the
  rendezvous address (rank 0 serves the store there);
- ``PADDLE_LOCAL_RANK``: the card of this process on its host (default:
  the rank modulo the cards visible);
- ``PADDLE_DISTRI_BACKEND``: "nccl" or "gloo", when ``backend`` is None.

NCCL carries CUDA tensors and gloo CPU tensors (collective.py refuses the
other pairing). With NCCL the process selects its own card
(``torch.cuda.set_device``) before anything touches CUDA, so
``resolve_device(None)`` and the eager default place ("gpu:<local rank>")
land on it; with gloo the eager default place becomes the CPU.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as tdist

__all__ = ["init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "global_rank", "local_rank", "backend",
           "ParallelEnv"]

_state = {"backend": None, "local_rank": 0}


def _env_int(name, default=0):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _endpoints():
    return [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]


def init_parallel_env(backend=None):
    """Start ``torch.distributed`` from the launcher's environment
    (reference: paddle.distributed.init_parallel_env); a second call
    returns the same ParallelEnv. ``backend`` None reads
    ``PADDLE_DISTRI_BACKEND``, else "nccl", which needs CUDA and raises
    without it (pass backend="gloo" for CPU ranks)."""
    if tdist.is_available() and tdist.is_initialized():
        return ParallelEnv()
    backend = (backend or os.environ.get("PADDLE_DISTRI_BACKEND")
               or "nccl").lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    world = _env_int("PADDLE_TRAINERS_NUM", 1)
    rank = _env_int("PADDLE_TRAINER_ID", 0)
    if not 0 <= rank < world:
        raise ValueError(f"PADDLE_TRAINER_ID={rank} outside a world of "
                         f"{world}")
    from ..core import place

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: init_parallel_env(backend='nccl') needs "
                "CUDA, but torch.cuda.is_available() is False; pass "
                "backend='gloo' for CPU ranks")
        local = _env_int("PADDLE_LOCAL_RANK",
                         rank % torch.cuda.device_count())
        torch.cuda.set_device(local)
        place.set_device(f"gpu:{local}")
    else:
        local = _env_int("PADDLE_LOCAL_RANK", rank)
        place.set_device("cpu")
    eps = _endpoints()
    if eps:
        init_method = f"tcp://{eps[0]}"
    elif world == 1:
        # a world of one needs no peer: a store in this process
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            init_method = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    else:
        raise RuntimeError("PADDLE_TRAINER_ENDPOINTS is not set for a world "
                           f"of {world}")
    # no device_id: each group's communicator is made among its members at
    # its first collective (not split from the world's at new_group)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world)
    _state.update(backend=backend, local_rank=local)
    return ParallelEnv()


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def backend():
    """"nccl", "gloo", or None before init_parallel_env."""
    return _state["backend"] if is_initialized() else None


def global_rank() -> int:
    if is_initialized():
        return tdist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", 0)


def local_rank() -> int:
    return _state["local_rank"] if is_initialized() else \
        _env_int("PADDLE_LOCAL_RANK", 0)


def get_rank(group=None) -> int:
    if group is not None:
        return group.get_group_rank(global_rank())
    return global_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if is_initialized():
        return tdist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", 1)


class ParallelEnv:
    def __init__(self):
        self.rank = global_rank()
        self.world_size = get_world_size()
        self.device_id = local_rank()
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self.trainer_endpoints = _endpoints()

    @property
    def local_rank(self):
        return self.device_id

    @property
    def nranks(self):
        return self.world_size

    @property
    def dev_id(self):
        return self.device_id
