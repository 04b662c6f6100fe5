"""The hybrid-parallel topology (paddle_tpu/distributed/topology.py).

The 5-D rank grid over ("dp", "pp", "sharding", "sep", "mp"), mp innermost
(consecutive ranks share a model-parallel group, as in the reference's
mesh), its groups, and the port's mesh object.

The TPU package's mesh is a jax Mesh that one process spans; its
HybridCommunicateGroup makes only the caller's group of each axis. Here
each rank is a process, and ``torch.distributed.new_group`` is collective:
every rank makes every group of every axis, in the same order, and keeps
its own. A mesh larger than the initialized world raises.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from . import collective, env

__all__ = ["AXES", "Mesh", "CommunicateTopology", "HybridCommunicateGroup",
           "build_mesh", "get_mesh", "set_mesh", "mesh_degrees",
           "RankLayout", "rank_layout", "hcg_for_mesh",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

AXES = ("dp", "pp", "sharding", "sep", "mp")  # outermost -> innermost

# the fused groups the port's layers and trainer reduce over: the data
# ranks (dp x sharding), and with them the sep ranks, whose sequence shards
# are more of the global batch's tokens
_FUSED = (("dp", "sharding"), ("dp", "sep"), ("dp", "sharding", "sep"),
          ("pp", "mp"))

_current_hcg: Optional["HybridCommunicateGroup"] = None
_current_mesh: Optional["Mesh"] = None


class Mesh:
    """Axis sizes over AXES (the ranks laid out mp innermost). ``shape`` is
    a dict, as the jax Mesh's, which HybridTrainer reads."""

    axis_names = AXES

    def __init__(self, dp=1, pp=1, sharding=1, sep=1, mp=1):
        self.shape = {"dp": int(dp), "pp": int(pp),
                      "sharding": int(sharding), "sep": int(sep),
                      "mp": int(mp)}
        if min(self.shape.values()) < 1:
            raise ValueError(f"mesh axis sizes must be >= 1: {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{k}={v}" for k, v in
                                   self.shape.items()) + ")"


def mesh_degrees(mesh) -> dict:
    """{axis: size} over AXES of a Mesh, a jax-style object with a
    ``shape`` mapping, or a dict (missing axes are 1)."""
    shape = dict(getattr(mesh, "shape", mesh))
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are "
                         f"{AXES}")
    return {a: int(shape.get(a, 1)) for a in AXES}


def _check_world(total: int):
    world = env.get_world_size()
    if total > world:
        raise ValueError(
            f"a mesh of {total} ranks needs a world of {total} processes; "
            f"the initialized world has {world} (init_parallel_env, or "
            f"spawn with nprocs={total})")


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, devices=None) -> Mesh:
    """The mesh over the first dp*pp*sharding*sep*mp ranks; more ranks than
    the initialized world raises."""
    mesh = Mesh(dp, pp, sharding, sep, mp)
    _check_world(mesh.size)
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


class CommunicateTopology:
    """Pure rank-grid arithmetic (reference topology.py:65)."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or AXES)
        self._dims = [int(d) for d in (dims or [1] * len(
            self._parallel_names))]
        self._world = int(np.prod(self._dims))
        self._rank_grid = np.arange(self._world).reshape(tuple(self._dims))
        self._coord = collections.namedtuple("Coord", self._parallel_names)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        return int(self._rank_grid[tuple(kwargs[n] for n in
                                         self._parallel_names)])

    def get_coord(self, rank):
        coord = np.unravel_index(rank, self._rank_grid.shape)
        return self._coord(*[int(c) for c in coord])

    def get_axis_list(self, axis_name, index):
        ax = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[ax] = index
        return sorted(self._rank_grid[tuple(sl)].reshape(-1).tolist())

    def get_comm_list(self, axis_names):
        """Every group along ``axis_names`` (one axis or several): a list
        of rank lists, in grid order."""
        names = [axis_names] if isinstance(axis_names, str) else \
            list(axis_names)
        axes = [self._parallel_names.index(n) for n in names]
        moved = np.moveaxis(self._rank_grid, axes,
                            list(range(-len(axes), 0)))
        size = int(np.prod([self._dims[a] for a in axes]))
        return moved.reshape(-1, size).tolist()

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)._asdict()
        coord.update(kwargs)
        return self.get_rank(**coord)


class HybridCommunicateGroup:
    """The groups of the grid (reference topology.py:178). Every rank makes
    every group of every axis, and of the fused axes, in the same order
    (``new_group`` is collective), and keeps those it belongs to."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = env.global_rank()
        self.nranks = topology.world_size()
        _check_world(self.nranks)
        if env.is_initialized() and self.nranks != env.get_world_size():
            raise ValueError(
                f"the topology spans {self.nranks} ranks, the initialized "
                f"world {env.get_world_size()}: a rank outside the mesh "
                f"would have no part to play")
        coord = topology.get_coord(self.global_rank)
        for axis in AXES:
            setattr(self, f"_{axis}_degree", topology.get_dim(axis))
            setattr(self, f"_{axis}_rank", getattr(coord, axis))
        self._groups = {}
        for axes in [(a,) for a in AXES] + list(_FUSED):
            mine = None
            for ranks in topology.get_comm_list(axes):
                g = collective.new_group(ranks, axis_name="_".join(axes))
                if self.global_rank in ranks:
                    mine = g
            self._groups[axes] = mine
        self._p2p = self._make_p2p_groups(topology)

    def _make_p2p_groups(self, topology):
        """The point-to-point groups of the pipeline: one a ring edge
        (stage s, stage s+1 mod P) of every pp group, made by every rank in
        the same order. An edge's group carries the activations that go
        forward over it and the gradients that come back over it, so that a
        step's send and receive with one neighbour go in one batch (one
        NCCL group); with P = 2 the two edges are two groups over the same
        two ranks, so each still carries one flow each way. Returns
        (this rank's next edge, its previous edge), or None below pp 2."""
        p = self._pp_degree
        if p < 2:
            return None
        nxt = prev = None
        for ranks in topology.get_comm_list("pp"):
            for s in range(p):
                edge = (ranks[s], ranks[(s + 1) % p])
                g = collective.new_group(list(edge), axis_name="pp_p2p")
                if self.global_rank == edge[0]:
                    nxt = g
                if self.global_rank == edge[1]:
                    prev = g
        return nxt, prev

    def get_group(self, *axes) -> collective.Group:
        """This rank's group over ``axes`` (one axis, or fused axes made up
        front: dp+sharding, dp+sep, dp+sharding+sep, pp+mp)."""
        return self._groups[tuple(axes)]

    # parallel mode dispatch (reference fleet/model.py:32)
    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1 and self._dp_degree <= 1 and \
                self._mp_degree <= 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "tensor_parallel"
        if self._sep_degree > 1:
            return "segment_parallel"
        if self._dp_degree > 1:
            return "data_parallel"
        return "single"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def degrees(self) -> dict:
        return {a: getattr(self, f"_{a}_degree") for a in AXES}

    def layout(self) -> "RankLayout":
        """This rank's degrees and coordinates over AXES."""
        return RankLayout(self.degrees(),
                          {a: getattr(self, f"_{a}_rank") for a in AXES})

    # -- data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self.get_group("dp")

    def get_data_parallel_group_src_rank(self):
        return self.get_group("dp").ranks[0]

    # -- model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self.get_group("mp")

    def get_model_parallel_group_src_rank(self):
        return self.get_group("mp").ranks[0]

    # -- pipeline
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self.get_group("pp")

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    def get_p2p_groups(self):
        """(send_next, send_prev, recv_next, recv_prev) as Paddle's
        topology gives them: the next edge's group sends forward and
        receives from the next stage, the previous edge's group the other
        two (``_make_p2p_groups``); None below pp 2."""
        if self._p2p is None:
            return None
        nxt, prev = self._p2p
        return nxt, prev, nxt, prev

    def get_p2p_neighbours(self):
        """The global ranks of the previous and the next stage on this
        rank's pp ring (stage s - 1 and s + 1, mod pp)."""
        p, s = self._pp_degree, self._pp_rank
        return (self.get_rank_from_stage((s - 1) % p),
                self.get_rank_from_stage((s + 1) % p))

    # -- sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self.get_group("sharding")

    def get_sharding_parallel_group_src_rank(self):
        return self.get_group("sharding").ranks[0]

    # -- sep (context parallel)
    def get_sep_parallel_rank(self):
        return self._sep_rank

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self.get_group("sep")

    def get_sep_parallel_neighbours(self):
        """The global ranks of the previous and the next rank on this
        rank's sep ring (sep rank r - 1 and r + 1, mod sep): the ring
        attention's K/V come from the first and go to the second."""
        n, r = self._sep_degree, self._sep_rank
        coord = self._topo.get_coord(self.global_rank)._asdict()
        return tuple(self._topo.get_rank(**dict(coord, sep=(r + d) % n))
                     for d in (-1, 1))

    # -- fused axes
    def get_dp_sep_parallel_group(self):
        return self.get_group("dp", "sep")

    def get_pp_mp_parallel_group(self):
        return self.get_group("pp", "mp")

    def get_check_parallel_group(self, *a):
        return self.get_group("mp")

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(
            self.global_rank, pp=stage_id, **kwargs)

    def build_mesh(self) -> Mesh:
        mesh = Mesh(**self.degrees())
        set_mesh(mesh)
        return mesh


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _current_hcg


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _current_hcg
    _current_hcg = hcg


class RankLayout:
    """A rank's place on a mesh: ``degrees`` and ``coords``, each {axis:
    int} over AXES (the axis's size, and this rank's index on it)."""

    def __init__(self, degrees, coords):
        self.degrees, self.coords = dict(degrees), dict(coords)


def rank_layout(mesh_or_hcg, rank=None) -> RankLayout:
    """The place of a HybridCommunicateGroup's rank, or of ``rank`` (else
    the global rank) on a mesh (a Mesh or a dict of axis sizes)."""
    if isinstance(mesh_or_hcg, RankLayout):
        return mesh_or_hcg
    if isinstance(mesh_or_hcg, HybridCommunicateGroup):
        return mesh_or_hcg.layout()
    degrees = mesh_degrees(mesh_or_hcg)
    coord = CommunicateTopology(list(AXES), [degrees[a] for a in AXES]) \
        .get_coord(env.global_rank() if rank is None else rank)
    return RankLayout(degrees, coord._asdict())


def hcg_for_mesh(mesh) -> HybridCommunicateGroup:
    """The current hybrid group when its degrees are ``mesh``'s, else a
    new one over ``mesh`` (collective: every rank calls it)."""
    degrees = mesh_degrees(mesh)
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.degrees() == degrees:
        return hcg
    return HybridCommunicateGroup(CommunicateTopology(
        list(AXES), [degrees[a] for a in AXES]))
