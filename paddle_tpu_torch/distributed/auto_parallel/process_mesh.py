"""ProcessMesh (paddle_tpu/distributed/auto_parallel/process_mesh.py;
reference: python/paddle/distributed/auto_parallel/process_mesh.py).

The reference's resolves to a jax Mesh over the job's devices
(``to_jax_mesh``); here the process ids are ranks of the
``torch.distributed`` world and ``to_device_mesh`` makes the DTensor
``DeviceMesh`` over them: device type "cuda" under NCCL, "cpu" under gloo.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ProcessMesh"]

# DeviceMeshes made so far, by (ranks, shape, dim names, backend): equal
# ProcessMeshes share one, so their process groups are made once
_device_meshes = {}


def clear_device_meshes():
    """Forget the DeviceMeshes (their groups go with the world's, at
    destroy_process_group)."""
    _device_meshes.clear()


class ProcessMesh:
    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 process_ids=None):
        self._mesh_arr = np.asarray(mesh)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(self._mesh_arr.ndim)]
        self._dim_names = list(dim_names)

    @property
    def shape(self):
        return list(self._mesh_arr.shape)

    @property
    def ndim(self):
        return self._mesh_arr.ndim

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._mesh_arr.reshape(-1).tolist()

    @property
    def mesh(self):
        return self._mesh_arr

    def get_dim_size(self, dim_name):
        return self._mesh_arr.shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        coord = np.argwhere(self._mesh_arr == process_id)
        if coord.size == 0:
            return -1
        return int(coord[0][self._dim_names.index(dim_name)])

    def to_device_mesh(self):
        """The DeviceMesh over these ranks, made once (collective: every
        rank of the world makes it). Raises before init_parallel_env, and
        when the mesh's process ids are not the world's ranks."""
        from torch.distributed.device_mesh import DeviceMesh

        from .. import env

        backend = env.backend()
        if backend is None:
            raise RuntimeError(
                "ProcessMesh.to_device_mesh: call "
                "paddle_tpu_torch.distributed.init_parallel_env() first "
                "(NCCL over CUDA cards by default; backend='gloo' for CPU "
                "ranks)")
        world = env.get_world_size()
        if sorted(self.process_ids) != list(range(world)):
            raise ValueError(
                f"ProcessMesh {self.process_ids} does not hold the world's "
                f"ranks 0..{world - 1} once each")
        key = (tuple(self.process_ids), tuple(self.shape),
               tuple(self._dim_names), backend)
        dm = _device_meshes.get(key)
        if dm is None:
            import torch

            dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                            torch.as_tensor(self._mesh_arr,
                                            dtype=torch.int64),
                            mesh_dim_names=tuple(self._dim_names))
            _device_meshes[key] = dm
        return dm

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._mesh_arr, other._mesh_arr)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._mesh_arr.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dims={self._dim_names})"
