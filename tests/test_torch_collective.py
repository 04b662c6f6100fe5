"""The port's collectives (paddle_tpu_torch.distributed: collective, env,
topology, spawn) at 4 gloo ranks on the CPU, held to numpy, as
tests/collective_worker.py holds the reference's two-trainer battery.

Each multi-rank test runs ``paddle_tpu_torch.distributed.spawn`` (new
processes, start method "spawn", the rendezvous store held by the parent
on a port the OS gave it) of a
rank function in tests/torch_dist_workers.py, which imports only torch and
the port; each spawn has its own time limit, past which its ranks are
killed. Collectives move numbers without arithmetic, or sum small
integers, so every comparison is exact.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import collective, topology
from paddle_tpu_torch.distributed.fleet import HybridTrainer
from paddle_tpu_torch.models import llama as TL

WORLD = 4


def run(fn, tmp_path, *args, nprocs=WORLD, timeout=120):
    dist.spawn(fn, args=(str(tmp_path),) + args, nprocs=nprocs,
               backend="gloo", timeout=timeout)
    out = []
    for r in range(nprocs):
        path = tmp_path / f"rank{r}.pkl"
        out.append(pickle.loads(path.read_bytes()) if path.exists()
                   else None)
    return out


@pytest.mark.parametrize("eager", [False, True], ids=["torch", "Tensor"])
def test_every_collective_at_four_ranks_matches_numpy(tmp_path, eager):
    res = run(W.collectives, tmp_path, eager)
    base = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * (r + 1)
            for r in range(WORLD)]
    stack = np.stack(base)
    for r, got in enumerate(res):
        eq = np.testing.assert_array_equal
        eq(got["all_reduce_sum"], stack.sum(0))
        eq(got["all_reduce_max"], stack.max(0))
        eq(got["all_reduce_min"], stack.min(0))
        eq(got["all_reduce_prod"], stack.prod(0))
        eq(got["all_reduce_avg"], stack.mean(0))
        eq(got["all_reduce_async"], stack.sum(0))
        eq(got["all_reduce_bf16"], stack.sum(0))    # small integers: exact
        eq(got["all_gather_list"], stack)
        eq(got["all_gather_axis0"], np.concatenate(base, 0))
        eq(got["all_gather_axis1"], np.concatenate(base, 1))
        assert got["all_gather_object"] == [(k, "x" * (k + 1))
                                            for k in range(WORLD)]
        full = np.stack([np.arange(8, dtype=np.float32) + 100 * (k + 1)
                         for k in range(WORLD)])
        eq(got["reduce_scatter"], full.sum(0)[2 * r:2 * r + 2])
        eq(got["reduce_scatter_list_max"], full.max(0)[2 * r:2 * r + 2])
        eq(got["all_to_all"], np.stack([np.full(2, 10.0 * k + r)
                                        for k in range(WORLD)]))
        eq(got["all_to_all_single"], np.asarray(
            [r + 10.0 * k for k in range(WORLD)], np.float32))
        eq(got["all_to_all_single_uneven"], np.concatenate(
            [np.full(k + 1, float(k)) for k in range(WORLD)]))
        eq(got["broadcast"], base[2])
        assert got["broadcast_object_list"] == [{"from": 1}, 3]
        if r == 3:        # elsewhere the buffer's contents are undefined
            eq(got["reduce"], stack.sum(0))
        eq(got["scatter"], np.full(2, float(r)))
        assert got["scatter_object_list"] == f"o{r}"
        if r == 1:
            eq(got["gather"], stack)
        else:
            assert got["gather"] is None
        prv = (r - 1) % WORLD
        eq(got["send_recv"], np.full(3, float(prv)))
        eq(got["isend_irecv"], np.full(3, prv + 0.5))
        eq(got["batch_isend_irecv"], np.full(3, prv + 1.0))
        pair = [k for k in range(WORLD) if k % 2 == r % 2]
        eq(got["subgroup_all_reduce"], sum(base[k] for k in pair))
        assert got["subgroup_rank"] == (pair.index(r), 2, True, r % 2 == 0)
        assert got["backend"] == "GLOO"


def _wait_dead(pids, seconds=10):
    deadline = time.monotonic() + seconds
    alive = list(pids)
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _alive(p)]
        time.sleep(0.1)
    return alive


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie (killed, not yet reaped by a parent) is dead too
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_spawn_kills_its_ranks_past_the_time_limit(tmp_path):
    seen = []
    orig = torch.multiprocessing.start_processes

    def recording(*a, **k):
        ctx = orig(*a, **k)
        seen.extend(p.pid for p in ctx.processes)
        return ctx

    torch.multiprocessing.start_processes = recording
    try:
        t = time.monotonic()
        with pytest.raises(TimeoutError):
            dist.spawn(W.sleeper, args=(str(tmp_path),), nprocs=2,
                       backend="gloo", timeout=10)
        assert time.monotonic() - t < 30
    finally:
        torch.multiprocessing.start_processes = orig
    assert len(seen) == 2 and _wait_dead(seen) == []


def test_a_failing_rank_ends_the_others(tmp_path):
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="on purpose"):
        dist.spawn(W.raiser, args=(str(tmp_path),), nprocs=2,
                   backend="gloo", timeout=60)


class _FakeGroup(collective.Group):
    def __init__(self, backend):
        super().__init__([0], 7, "fake", pg=object())
        self._backend = backend

    @property
    def backend(self):
        return self._backend


class _CudaLike:
    is_cuda = True


def test_a_tensor_on_the_other_backend_raises():
    # a CPU tensor never goes over NCCL, a CUDA tensor never over gloo
    with pytest.raises(RuntimeError, match="CPU tensor on an NCCL group"):
        collective._pg(_FakeGroup("nccl"), [torch.zeros(2)])
    with pytest.raises(RuntimeError, match="CUDA tensor on a gloo group"):
        collective._pg(_FakeGroup("gloo"), [_CudaLike()])
    assert collective._pg(_FakeGroup("gloo"), [torch.zeros(2)]) is not None
    # no collective before init_parallel_env
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        collective.all_reduce(torch.zeros(2))


def test_nccl_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_parallel_env(backend="nccl")
    assert not dist.is_initialized()


def test_topology_grid_groups_and_mesh_limits():
    topo = topology.CommunicateTopology(list(topology.AXES), [2, 1, 2, 1, 2])
    assert topo.world_size() == 8
    c = topo.get_coord(5)
    assert (c.dp, c.sharding, c.mp) == (1, 0, 1)
    assert topo.get_rank(dp=1, pp=0, sharding=0, sep=0, mp=1) == 5
    # mp innermost: consecutive ranks share a model-parallel group
    assert topo.get_comm_list("mp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert topo.get_comm_list("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert topo.get_comm_list(("dp", "sharding")) == [
        [0, 2, 4, 6], [1, 3, 5, 7]]
    assert topo.get_axis_list("dp", 0) == [0, 1, 2, 3]
    # one process, no init: a world of one
    assert dist.get_world_size() == 1
    with pytest.raises(ValueError, match="world"):
        dist.build_mesh(dp=2)
    with pytest.raises(ValueError, match="world"):
        topology.HybridCommunicateGroup(topo)
    assert dist.build_mesh().shape == dict.fromkeys(topology.AXES, 1)
    cfg = TL.LlamaConfig(**dict(vars(TL.LLAMA_PRESETS["debug"])))
    with pytest.raises(ValueError, match="world"):
        HybridTrainer(cfg, mesh={"mp": 2, "sharding": 2}, device="cpu")
    # the rank layout a converter reads at a given rank
    lay = topology.rank_layout({"dp": 2, "mp": 2}, rank=3)
    assert (lay.coords["dp"], lay.coords["mp"], lay.degrees["mp"]) == \
        (1, 1, 2)
