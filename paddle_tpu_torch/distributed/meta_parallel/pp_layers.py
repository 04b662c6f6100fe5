"""Pipeline model partitioning (paddle_tpu/distributed/meta_parallel/
pp_layers.py; reference fleet/meta_parallel/parallel_layers/pp_layers.py:
LayerDesc:56, SharedLayerDesc:76, PipelineLayer:257).

The TPU package is single-controller: its PipelineLayer builds every
stage's layers in one process, and the stage boundaries only steer its
schedules. The port follows PaddlePaddle's multi-process Fleet: each pp
rank builds only the descs of its own chunks (the layers of its stage; under
VPP, of its virtual stages), and the engines (pipeline_parallel.py) send the
activations between the ranks.

- Segmentation is the TPU package's: ``"uniform"`` (by count) or
  ``"layer:<Cls>"`` (by the instances of a class) into pp stages; under VPP
  (``num_virtual_pipeline_stages`` v > 1) the run functions split evenly
  into pp * v chunks, chunk gv on stage gv % pp, as its chunk executor
  splits them (pipeline_parallel.py:156-157).
- A layer is named by its global index in the whole model
  (``layers_list.<i>.``), so the whole model's ``state_dict`` loads onto any
  stage: ``set_state_dict`` takes the stage's entries and counts the other
  stages' as neither missing nor unexpected.
- A SharedLayerDesc (tied weights) is built on every stage that uses it,
  named by its first use; those stages broadcast it from the first of them
  at construction, and ``allreduce_shared_weight_gradients`` sums its
  gradients over them before the optimizer step (Paddle's
  allreduce_shared_weight_gradients): in the TPU package one object is
  shared in one process, so its gradient is already that sum.
- ``forward`` (the whole model) runs only where one rank holds every stage
  (pp 1); at pp > 1 it raises, naming ``forward_stage``.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ...nn.layer.layers import Layer, LayerDict
from .. import collective
from ..fleet.layers.mpu.mp_ops import _live

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _shared_fn(layer, fwd):
    return (lambda x: fwd(layer, x)) if fwd else layer


class PipelineLayer(Layer):
    """Partition a layer list into pp stages; this rank builds and holds
    its own chunks (all of them without a pp group of 2 or more)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        from ..topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg else 1
        if num_stages is None:
            num_stages = pp
        self._num_stages = max(num_stages, 1)
        if pp > 1 and self._num_stages != pp:
            raise ValueError(f"num_stages={self._num_stages} on a pp group "
                             f"of {pp} ranks")
        self._num_virtual_pipeline_stages = max(
            num_virtual_pipeline_stages or 1, 1)
        self._recompute_interval = recompute_interval
        self._hcg = hcg if pp > 1 else None
        self._stage_id = hcg.get_stage_id() if pp > 1 else None

        # the TPU package's run functions, in order, without building them:
        # (kind, desc, index of the layer in its layers_list) and the class
        # name its "layer:<Cls>" segmentation counts
        self._items, names, first_use = [], [], {}
        self._n_layers = 0
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in first_use:
                    first_use[d.layer_name] = self._n_layers
                    self._n_layers += 1
                self._items.append(("shared", d, first_use[d.layer_name]))
                names.append("function")
            elif isinstance(d, (LayerDesc, Layer)):
                self._items.append(("layer", d, self._n_layers))
                self._n_layers += 1
                names.append(d.layer_cls.__name__
                             if isinstance(d, LayerDesc)
                             else type(d).__name__)
            elif callable(d):
                self._items.append(("func", d, None))
                names.append(type(d).__name__)
            else:
                raise TypeError(f"bad pipeline item {d!r}")

        n = len(self._items)
        bounds = np.linspace(0, n, self._num_stages + 1, dtype=int).tolist()
        if isinstance(seg_method, str) and seg_method.startswith("layer:"):
            cls_name = seg_method.split(":", 1)[1]
            marks = [i for i, name in enumerate(names) if name == cls_name]
            if len(marks) >= self._num_stages:
                per = len(marks) // self._num_stages
                bounds = [0] + [marks[s * per] for s in
                                range(1, self._num_stages)] + [n]
        self._stage_bounds = bounds
        q = self._num_stages * self._num_virtual_pipeline_stages
        self._chunk_bounds = bounds if q == self._num_stages else \
            np.linspace(0, n, q + 1, dtype=int).tolist()
        if any(lo >= hi for lo, hi in zip(self._chunk_bounds,
                                          self._chunk_bounds[1:])):
            raise ValueError(
                f"{n} pipeline items do not fill {self._num_stages} stages "
                f"x {self._num_virtual_pipeline_stages} chunks")

        # build this rank's chunks, each layer under its global index
        self.layers_list = LayerDict()
        self._fns, self._layer_of, self._shared = {}, {}, {}
        for gv in self.held_chunks():
            for i in range(self._chunk_bounds[gv], self._chunk_bounds[gv + 1]):
                kind, d, idx = self._items[i]
                if kind == "func":
                    self._fns[i] = d
                    continue
                key = str(idx)
                if key not in self.layers_list:
                    self.layers_list[key] = d.build_layer() \
                        if isinstance(d, LayerDesc) else d
                layer = self._layer_of[i] = self.layers_list[key]
                if kind == "shared":
                    self._shared[d.layer_name] = layer
                    self._fns[i] = _shared_fn(layer, d.forward_func)
                else:
                    self._fns[i] = layer
        self._shared_groups = self._make_shared_groups()

    # -- placement ----------------------------------------------------------
    @property
    def num_stages(self):
        return self._num_stages

    @property
    def stage_id(self):
        """This rank's stage, or None where it holds every stage."""
        return self._stage_id

    def get_num_virtual_stages(self):
        return self._num_virtual_pipeline_stages

    def held_chunks(self) -> List[int]:
        """The virtual stages gv (chunk c of stage s is gv = c * pp + s)
        whose layers this rank holds."""
        q = self._num_stages * self._num_virtual_pipeline_stages
        if self._stage_id is None:
            return list(range(q))
        return list(range(self._stage_id, q, self._num_stages))

    def chunk_fns(self, gv: int) -> List[Callable]:
        lo, hi = self._chunk_bounds[gv], self._chunk_bounds[gv + 1]
        if gv not in self.held_chunks():
            raise ValueError(f"chunk {gv} is not held on stage "
                             f"{self._stage_id}")
        return [self._fns[i] for i in range(lo, hi)]

    def chunk_parameters(self, gv: int):
        """The trainable parameters of chunk gv's layers (a shared layer's
        too), each once."""
        self.chunk_fns(gv)
        out, seen = [], set()
        for i in range(self._chunk_bounds[gv], self._chunk_bounds[gv + 1]):
            if i not in self._layer_of:
                continue
            for p in self._layer_of[i].parameters():
                if id(p) not in seen and not p.stop_gradient:
                    seen.add(id(p))
                    out.append(p)
        return out

    def stage_fns(self, stage_id: int) -> List[Callable]:
        lo, hi = self._stage_bounds[stage_id], self._stage_bounds[stage_id + 1]
        missing = [i for i in range(lo, hi) if i not in self._fns]
        if missing:
            raise ValueError(f"stage {stage_id}'s layers are not held on "
                             f"stage {self._stage_id}")
        return [self._fns[i] for i in range(lo, hi)]

    def forward_stage(self, x, stage_id: int):
        for fn in self.stage_fns(stage_id):
            x = fn(x)
        return x

    def forward(self, x):
        if self._stage_id is not None:
            raise RuntimeError(
                f"PipelineLayer.forward runs the whole model, which one rank "
                f"holds only at pp 1; this rank holds stage {self._stage_id} "
                f"of {self._num_stages}: call forward_stage(x, "
                f"{self._stage_id}), or train through a pipeline engine")
        for i in range(len(self._items)):
            x = self._fns[i](x)
        return x

    # -- state --------------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load this stage's entries of a whole model's ``state_dict``; the
        other stages' entries (``layers_list.<i>.`` of a layer held
        elsewhere) are neither missing nor unexpected."""
        own = self.state_dict()
        missing, _ = super().set_state_dict(
            {k: v for k, v in state_dict.items() if k in own})
        held = set(self.layers_list.keys())

        def elsewhere(name):
            parts = name.split(".")
            return (len(parts) > 2 and parts[0] == "layers_list"
                    and parts[1].isdigit() and parts[1] not in held
                    and int(parts[1]) < self._n_layers)

        unexpected = [k for k in state_dict if k not in own
                      and not elsewhere(k)]
        return missing, unexpected

    load_dict = set_state_dict

    # -- shared weights -----------------------------------------------------
    def _make_shared_groups(self):
        """For each shared key used on two or more stages, the group of
        those stages' ranks (made on every rank, in the same order, over
        every pp group of the topology), with its weights broadcast from
        the first of them; {key: group} of the groups this rank is in."""
        if self._hcg is None:
            return {}
        stages = {}
        for gv in range(len(self._chunk_bounds) - 1):
            for i in range(self._chunk_bounds[gv], self._chunk_bounds[gv + 1]):
                kind, d, _ = self._items[i]
                if kind == "shared":
                    stages.setdefault(d.layer_name, set()).add(
                        gv % self._num_stages)
        mine = {}
        rank = self._hcg.get_global_rank()
        for ranks in self._hcg.topology().get_comm_list("pp"):
            for key, used in stages.items():
                if len(used) < 2:
                    continue
                members = [ranks[s] for s in sorted(used)]
                g = collective.new_group(members, axis_name="pp_shared")
                if rank in members:
                    mine[key] = (g, members[0])
        for key, (g, first) in mine.items():
            for p in self._shared[key].parameters():
                p.is_firstly_shared = rank == first
                if _live(g):
                    collective.broadcast(p, src=first, group=g)
        return {key: g for key, (g, _) in mine.items()}

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's gradients over the stages that use it
        (every rank of the pp group calls it)."""
        for key, g in self._shared_groups.items():
            if not _live(g):
                continue
            for p in self._shared[key].parameters():
                if p.stop_gradient:
                    continue
                t = p._value
                if t.grad is None:      # every member takes part
                    t.grad = torch.zeros_like(t)
                collective.all_reduce(t.grad, group=g)
