"""Auto-parallel (semi-auto) API over DTensor
(paddle_tpu/distributed/auto_parallel/api.py; reference:
python/paddle/distributed/auto_parallel/api.py: shard_tensor, reshard,
shard_layer, shard_optimizer, to_static).

The TPU package's DistTensor is a jax array with a NamedSharding, and XLA
propagates shardings and inserts the collectives. Here it is a
``torch.distributed.tensor.DTensor`` over the ProcessMesh's DeviceMesh,
one process a rank, each holding its shard: ``shard_tensor`` slices each
rank's shard from the full value (nothing is sent), ``reshard`` is
``redistribute`` (DTensor runs the collective), ``unshard_dtensor`` is
``full_tensor()``, and the eager ops run DTensor's sharding propagation
through the op funnel (core/dispatch.py). Placements are per mesh
dimension, in both.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ...core.tensor import Parameter, Tensor, dtensor_class, shard_of
from .placement import Placement, Replicate, Shard, to_dtensor
from .process_mesh import ProcessMesh

__all__ = ["shard_tensor", "reshard", "shard_layer", "shard_optimizer",
           "to_static", "dtensor_from_fn", "unshard_dtensor",
           "placements_to_spec", "DistAttr", "DistModel", "get_dist_meta"]


class DistAttr:
    def __init__(self, mesh, placements):
        self.process_mesh = mesh
        self.placements = placements


def placements_to_spec(mesh: ProcessMesh, placements: List[Placement]):
    """[Shard(0), Replicate()] over mesh dims -> the per-TENSOR-dim spec:
    a tuple holding, for each tensor dim up to the last sharded one, the
    mesh axis name sharding it, a tuple of names, or None (the entries of
    the reference's PartitionSpec)."""
    dim_axes = {}
    for mesh_dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            dim_axes.setdefault(placement.get_dim(), []).append(
                mesh.dim_names[mesh_dim])
    if not dim_axes:
        return ()
    entries = []
    for d in range(max(dim_axes) + 1):
        axes = dim_axes.get(d)
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    return tuple(entries)


class _DistMeta:
    __slots__ = ("process_mesh", "placements")

    def __init__(self, mesh, placements):
        self.process_mesh = mesh
        self.placements = placements


def _attach(t: Tensor, mesh, placements):
    # on the tensor itself (a slot), as the reference's _attach (:78)
    t._dist_attr = _DistMeta(mesh, list(placements))
    return t


def get_dist_meta(t: Tensor) -> Optional[_DistMeta]:
    return getattr(t, "_dist_attr", None)


def _device_of(dm) -> torch.device:
    if dm.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(dm.device_type)


def _distribute(value: torch.Tensor, mesh: ProcessMesh, placements):
    """``value`` (full, or a DTensor) as a DTensor placed on ``mesh``:
    each rank slices its own shard of a full value."""
    dm = mesh.to_device_mesh()
    pls = tuple(to_dtensor(p) for p in placements)
    if len(pls) != dm.ndim:
        raise ValueError(f"{len(pls)} placements for a {dm.ndim}-d mesh")
    from torch.distributed.tensor import DTensor

    if isinstance(value, DTensor):
        if value.device_mesh != dm:
            value = value.full_tensor()
        else:
            return value.redistribute(dm, pls)
    return shard_of(value.to(_device_of(dm)), dm, pls)


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 place=None, stop_gradient=None):
    """``data`` as a DTensor on ``mesh`` with ``placements`` (one a mesh
    dimension). A Parameter keeps its identity: its ``_value`` becomes a
    DTensor leaf holding this rank's shard. Collective: every rank of the
    mesh calls it with the same full value."""
    t = data if isinstance(data, Tensor) else Tensor(data, dtype=dtype,
                                                     place=place)
    arr = _distribute(t._value.detach(), mesh, placements)
    if isinstance(t, Parameter):
        t._value = arr.requires_grad_(t._value.requires_grad)
        out = t
    else:
        grad = not (t.stop_gradient if stop_gradient is None
                    else stop_gradient)
        out = Tensor._wrap(arr.requires_grad_(grad) if grad else arr)
    return _attach(out, mesh, placements)


def reshard(dist_tensor: Tensor, mesh: ProcessMesh, placements):
    """Change placements; DTensor runs the collective (differentiable)."""
    v = dist_tensor._value
    dt = dtensor_class()
    if dt is not None and isinstance(v, dt) \
            and v.device_mesh == mesh.to_device_mesh():
        arr = v.redistribute(v.device_mesh,
                             tuple(to_dtensor(p) for p in placements))
    else:
        arr = _distribute(v, mesh, placements)
    return _attach(Tensor._wrap(arr), mesh, placements)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def unshard_dtensor(dist_tensor: Tensor) -> Tensor:
    """The full tensor on every rank (``full_tensor()``, differentiable)."""
    v = dist_tensor._value
    dt = dtensor_class()
    if dt is not None and isinstance(v, dt):
        v = v.full_tensor()
    return Tensor._wrap(v)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """reference api.py:678. Default: replicate every parameter on the
    mesh."""
    if shard_fn is None:
        def shard_fn(name, lyr, mesh):
            for p in lyr._parameters.values():
                if p is not None:
                    shard_tensor(p, mesh, [Replicate()] * len(mesh.shape))
    for name, sub in layer.named_sublayers(include_self=True):
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """reference api.py:1353: the moments take their parameter's
    placements (the optimizers make a DTensor parameter's moments with
    its placements); ``shard_fn`` is kept for the caller."""
    optimizer._shard_fn = shard_fn
    return optimizer


class DistModel:
    """The model ``to_static`` returns (reference DistModel): called in
    train mode with an optimizer, one Engine step; in eval mode (or
    without an optimizer) with a loss, the forward and the loss; without
    a loss, the outputs. The Engine owns the training state: the layer's
    weights are a snapshot until ``state_dict()`` writes them back."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, input_spec=None, mesh=None):
        from .static_engine import Engine

        self.network = layer
        self._loss, self._optimizer = loss, optimizer
        self.engine = Engine(layer, loss=loss, optimizer=optimizer,
                             strategy=strategy)
        if mesh is not None or optimizer is not None or loss is not None:
            self.engine.prepare(mesh=mesh)
        self._mode = "train"

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def __call__(self, *args):
        if self._mode == "train" and self._optimizer is not None:
            return self.engine.run_step(*args)
        if self._loss is not None:
            return self.engine.run_eval_step(*args)
        return self.engine.run_pred_step(*args)

    def state_dict(self, mode="all"):
        return self.engine.state_dict(mode)

    def dist_main_program(self, mode="train", *sample_batch):
        if not sample_batch:
            return None
        return self.engine.dist_main_program(mode, *sample_batch)


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              input_spec=None, mesh=None):
    """reference api.py:2345: ``layer`` trained over its placements by
    the Engine (static_engine.py), no model-specific trainer. Nothing is
    compiled: the Engine's step runs the eager ops over DTensors
    (compiling is ROADMAP.md, queue 1, item 9)."""
    return DistModel(layer, loader, loss, optimizer, strategy, input_spec,
                     mesh)

