"""The auto-parallel Engine (paddle_tpu/distributed/auto_parallel/
static_engine.py:70-415; reference: python/paddle/distributed/
auto_parallel/static/engine.py:68, fit at :1213).

The TPU package compiles the whole step into one donated XLA executable,
and GSPMD completes the placements. Here the step runs eagerly over
DTensors, one process a rank; nothing is compiled (compiling is
ROADMAP.md, queue 1, item 9):

- **completion** (``prepare``): annotated parameters keep their
  placements, every other parameter and buffer enters ``Replicate()`` on
  the mesh; the Engine stages COPIES, and the optimizer's moments take
  their parameter's placements;
- **batches** (``_stage_batch``): ``Shard(0)`` on the mesh's first axis
  when that axis divides dim 0, else replicated; each rank takes its rows
  of the global batch every rank passes;
- **the step** follows the reference Engine's (jit/api.py::
  build_train_step, :502-571): every trainable parameter in the optimizer
  is updated, one the loss does not reach included (a zero gradient: AdamW
  still decays it), frozen ones pass through, under ``strategy.amp`` the
  floating parameters are cast to the AMP dtype for the forward (the
  gradients come back in the parameter's dtype), the loss is f32, and the
  global-norm clip runs over the sharded gradients. DTensor's sharding
  propagation runs the forward and backward; each gradient is
  redistributed to its parameter's placements (the data-parallel
  reduction), then the optimizer's own update runs on the local shards,
  which is exact: the update is elementwise and the parameter, its
  gradient and its moments share placements.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...core.tensor import (Tensor, full_value, replication_scope, shard_of,
                            to_torch)
from .api import get_dist_meta
from .placement import Replicate, to_dtensor
from .process_mesh import ProcessMesh

__all__ = ["Engine", "Strategy"]


def _all_reduce(t, pg):
    """A sum over a mesh dimension's process group, through
    collective.py under that group's own id (comm/* counters; a CommTask
    under the watchdog)."""
    from .. import collective

    collective.all_reduce(t, group=collective.group_of(pg))


class Strategy:
    """reference: dist.Strategy (auto_parallel/strategy.py). ``amp`` is
    honoured; ``sharding``, ``pipeline`` and ``gradient_merge`` are
    accepted, as the reference accepts them."""

    def __init__(self):
        self.amp = _Cfg(enable=False, dtype="bfloat16", level="O1")
        self.sharding = _Cfg(enable=False, stage=1, degree=1)
        self.pipeline = _Cfg(enable=False, schedule_mode="1F1B",
                             micro_batch_size=1, accumulate_steps=1)
        self.gradient_merge = _Cfg(enable=False, k_steps=1)


class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Slot:
    """What the optimizer's update reads of a parameter: its name and a
    value (here the local shard of the Engine's copy)."""

    __slots__ = ("_value", "name")

    def __init__(self, name):
        self._value = None
        self.name = name


def _local(t):
    # the DTensor's own local tensor: the update writes into it in place
    return t._local_tensor


class Engine:
    """Layer + mesh placements -> a training step over DTensors, no
    model-specific trainer code.

    Usage (mirrors the reference Engine):
        engine = Engine(model, loss, optimizer)
        engine.prepare(mesh=pm)        # or the mesh of the annotations
        engine.fit(loader, epochs=1)   # or engine.run_step(x, y)
    """

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy: Optional[Strategy] = None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics
        self.strategy = strategy or Strategy()
        self._mesh: Optional[ProcessMesh] = None
        self._dm = None
        self._device = None
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._buffers: Optional[Dict[str, torch.Tensor]] = None
        self._opt_states: Optional[Dict[str, Dict[str, torch.Tensor]]] = \
            None
        self._slots: Dict[str, _Slot] = {}
        self.history: List[float] = []
        # the global gradient norm of the last step, when the optimizer
        # clips (a 0-d tensor on the device)
        self.last_grad_norm = None

    # -- completion --------------------------------------------------------
    def _placements(self, param):
        meta = get_dist_meta(param)
        if meta is not None and meta.process_mesh == self._mesh:
            return tuple(to_dtensor(p) for p in meta.placements)
        v = param._value
        if getattr(v, "device_mesh", None) is self._dm:
            return tuple(v.placements)
        return tuple(to_dtensor(Replicate()) for _ in range(self._dm.ndim))

    def _stage(self, value, pls):
        """A copy of ``value`` (full, or a DTensor) placed by ``pls``."""
        from torch.distributed.tensor import DTensor

        value = value.detach()
        if isinstance(value, DTensor) and value.device_mesh is self._dm:
            return value.redistribute(self._dm, pls).clone()
        return shard_of(full_value(value).to(self._device), self._dm, pls)

    def prepare(self, inputs_spec=None, labels_spec=None, mode: str = "train",
                mesh: Optional[ProcessMesh] = None):
        """Complete the placements and stage copies of the parameters,
        buffers and moments on the mesh (reference Engine.prepare)."""
        if mesh is not None:
            self._mesh = mesh
        if self._mesh is None:
            for _, p in self.model.named_parameters():
                meta = get_dist_meta(p)
                if meta is not None:
                    self._mesh = meta.process_mesh
                    break
        if self._mesh is None:
            from .. import env

            self._mesh = ProcessMesh(list(range(env.get_world_size())),
                                     dim_names=["dp"])
        self._dm = self._mesh.to_device_mesh()
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if self._dm.device_type == "cuda"
                        else torch.device("cpu"))
        named = dict(self.model.named_parameters())
        self._params = {}
        for k, p in named.items():
            v = self._stage(p._value, self._placements(p))
            self._params[k] = v.requires_grad_(p._value.requires_grad)
        repl = tuple(to_dtensor(Replicate()) for _ in range(self._dm.ndim))
        self._buffers = {k: self._stage(b._value, repl)
                         for k, b in self.model.named_buffers()}
        self._opt_states = None
        if self.optimizer is not None:
            self._opt_states = {}
            for k, p in named.items():
                leaf = self._params[k]
                st = self.optimizer._accumulators.get(id(p))
                if st is None:
                    slot = _Slot(p.name)
                    slot._value = leaf
                    st = self.optimizer._init_state(slot)
                self._opt_states[k] = {
                    sk: self._stage(sv, leaf.placements).float()
                    if tuple(sv.shape) == tuple(leaf.shape) else sv.clone()
                    for sk, sv in st.items()}
        return self

    def _ensure_prepared(self):
        if self._params is None:
            self.prepare()

    # -- batches -----------------------------------------------------------
    def _stage_batch(self, batch) -> List[Tensor]:
        from torch.distributed.tensor import DTensor, Replicate as R, Shard

        n = self._dm.size(0)
        row = self._dm.get_coordinate()[0]
        out = []
        for b in batch:
            t = to_torch(b._value if isinstance(b, Tensor) else b)
            t = full_value(t).to(self._device)
            rest = [R()] * (self._dm.ndim - 1)
            if t.dim() > 0 and n > 1 and t.shape[0] % n == 0:
                local = t.chunk(n, dim=0)[row].contiguous()
                arr = DTensor.from_local(local, self._dm, [Shard(0)] + rest,
                                         run_check=False, shape=t.shape,
                                         stride=t.stride())
            else:
                arr = DTensor.from_local(t, self._dm, [R()] + rest,
                                         run_check=False)
            out.append(Tensor._wrap(arr))
        return out

    # -- the step ----------------------------------------------------------
    def _amp_dtype(self):
        amp = self.strategy.amp
        if not amp.enable:
            return None
        return torch.bfloat16 if amp.dtype == "bfloat16" else torch.float16

    def _bind(self, cast=None):
        """Point the model's parameters and buffers at the Engine's copies
        (cast to ``cast`` when given); returns the values to restore."""
        saved = []
        named = dict(self.model.named_parameters())
        for k, p in named.items():
            saved.append((p, p._value))
            v = self._params[k]
            if cast is not None and v.is_floating_point():
                v = v.to(cast)
            p._value = v
        for k, b in self.model.named_buffers():
            saved.append((b, b._value))
            b._value = self._buffers[k]
        return saved

    @staticmethod
    def _unbind(saved):
        for t, v in saved:
            t._value = v

    def _forward_loss(self, batch, train: bool):
        saved_mode = self.model.training
        self.model.train() if train else self.model.eval()
        binding = self._bind(self._amp_dtype())
        try:
            if self.loss is not None:
                out = self.model(*batch[:-1])
                loss = self.loss(out, batch[-1])
            else:
                loss = self.model(*batch)
        finally:
            self._unbind(binding)
            self.model.train() if saved_mode else self.model.eval()
        return loss._value.float()

    def _trainable(self):
        """(name, parameter, its index in the optimizer) of every leaf the
        step updates: in the optimizer and not stopped."""
        index = {id(p): i
                 for i, p in enumerate(self.optimizer._parameter_list)}
        return [(k, p, index[id(p)])
                for k, p in self.model.named_parameters()
                if id(p) in index and not p.stop_gradient]

    def _replicated(self, loss):
        """A scalar DTensor's value on every rank, as a plain tensor."""
        from torch.distributed.tensor import DTensor

        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return loss.detach()

    def _reduce_grads(self, leaves, grads):
        """Each gradient as the local shard of its leaf's placements: a
        missing one zeros; a Partial(sum) mesh dimension where the leaf is
        replicated (the data-parallel and model-parallel sums) reduced in
        buckets of one flat buffer a set of such dimensions and dtype, one
        all-reduce a dimension and bucket (as DTensor's redistribute sums
        them, dimension by dimension); any other difference through
        ``redistribute``."""
        from ...optimizer.optimizer import _GROUP_ELEMENTS

        out, buckets = [], {}
        for i, (leaf, g) in enumerate(zip(leaves, grads)):
            if g is None:
                out.append(torch.zeros_like(_local(leaf)))
                continue
            dims = tuple(d for d, (gp, lp) in enumerate(zip(
                g.placements, leaf.placements)) if gp != lp)
            if all(g.placements[d].is_partial()
                   and getattr(g.placements[d], "reduce_op", "") == "sum"
                   and leaf.placements[d].is_replicate() for d in dims):
                if dims:
                    buckets.setdefault((dims, g.dtype), []).append(i)
                out.append(_local(g))
            else:
                out.append(_local(g.redistribute(self._dm,
                                                 leaf.placements)))
        for (dims, _), idx in buckets.items():
            while idx:
                take, size = [], 0
                while idx and (not take or size < _GROUP_ELEMENTS):
                    take.append(idx.pop(0))
                    size += out[take[-1]].numel()
                flat = torch.cat([out[i].reshape(-1) for i in take])
                for d in dims:
                    _all_reduce(flat, self._dm.get_group(d))
                for i, piece in zip(take, flat.split(
                        [out[i].numel() for i in take])):
                    out[i] = piece.view(out[i].shape)
        return out

    def _global_norm(self, local_grads, leaves):
        """sqrt of the sum of squares of every gradient (sharded ones
        summed over the mesh dimensions that shard them)."""
        by_dims = {}
        for g, leaf in zip(local_grads, leaves):
            dims = tuple(i for i, p in enumerate(leaf.placements)
                         if p.is_shard())
            sq = g.float().square().sum()
            by_dims[dims] = by_dims[dims] + sq if dims in by_dims else sq
        total = torch.zeros((), dtype=torch.float32, device=self._device)
        for dims, sq in by_dims.items():
            for i in dims:
                _all_reduce(sq, self._dm.get_group(i))
            total = total + sq
        return torch.sqrt(total)

    def run_step(self, *batch) -> Tensor:
        """One training step. The Engine owns the training state (write
        it back to the model with state_dict or save). LR schedulers
        follow the eager convention: the caller steps them (fit does)."""
        self._ensure_prepared()
        opt = self.optimizer
        staged = self._stage_batch(batch)
        train = self._trainable()
        leaves = [self._params[k] for k, _, _ in train]
        loss = self._forward_loss(staged, train=True)
        with replication_scope([loss]):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        lr = opt.get_lr()
        opt._step_count += 1
        with torch.no_grad():
            local_grads = self._reduce_grads(leaves, grads)
            clip = opt._grad_clip
            if clip is not None and leaves:
                norm = self.last_grad_norm = self._global_norm(local_grads,
                                                               leaves)
                scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
                local_grads = [(g.float() * scale).to(g.dtype)
                               for g in local_grads]
            self._update(train, local_grads, lr)
        loss = self._replicated(loss)
        return Tensor._wrap(loss)

    def _update(self, train, local_grads, lr):
        """The optimizer's own update (its ``_update_group``) on the local
        shards, with the Engine's moments in place of its accumulators."""
        from ...optimizer.optimizer import _GROUP_ELEMENTS, _f32

        opt = self.optimizer
        states, groups = {}, {}
        for (k, p, i), g in zip(train, local_grads):
            slot = self._slots.setdefault(k, _Slot(p.name))
            slot._value = _local(self._params[k])
            states[id(slot)] = {sk: _local(sv) if hasattr(sv, "placements")
                                else sv
                                for sk, sv in self._opt_states[k].items()}
            groups.setdefault(opt._decay(p, i), []).append((slot, g))
        saved = opt._accumulators
        opt._accumulators = states
        try:
            for wd, items in groups.items():
                chunk, size = [], 0
                for item in items:
                    chunk.append(item)
                    size += item[0]._value.numel()
                    if size >= _GROUP_ELEMENTS:
                        opt._update_group(chunk, _f32(lr), wd)
                        chunk, size = [], 0
                if chunk:
                    opt._update_group(chunk, _f32(lr), wd)
        finally:
            opt._accumulators = saved

    def fit(self, train_data, epochs: int = 1, steps_per_epoch=None,
            valid_data=None, log_freq: int = 10, verbose: int = 1):
        """reference Engine.fit (engine.py:1213)."""
        self._ensure_prepared()
        for epoch in range(epochs):
            for i, batch in enumerate(train_data):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                batch = batch if isinstance(batch, (tuple, list)) else \
                    (batch,)
                loss = self.run_step(*batch)
                lr_sched = getattr(self.optimizer, "_learning_rate", None)
                if hasattr(lr_sched, "step"):
                    lr_sched.step()
                self.history.append(float(loss.numpy()))
                if verbose and i % log_freq == 0:
                    print(f"[auto_parallel.Engine] epoch {epoch} "
                          f"step {i} loss {self.history[-1]:.5f}")
            if valid_data is not None:
                self.evaluate(valid_data, verbose=verbose)
        return self.history

    # -- evaluation ----------------------------------------------------------
    def run_eval_step(self, *batch) -> Tensor:
        """The forward and the loss in eval mode (the outputs without a
        loss), no gradient."""
        self._ensure_prepared()
        if self.loss is None:
            return self.run_pred_step(*batch)
        with torch.no_grad():
            loss = self._forward_loss(self._stage_batch(batch), train=False)
        return Tensor._wrap(self._replicated(loss))

    def run_pred_step(self, *batch):
        """The model's outputs in eval mode, full on every rank."""
        self._ensure_prepared()
        saved_mode = self.model.training
        self.model.eval()
        binding = self._bind(self._amp_dtype())
        try:
            with torch.no_grad():
                out = self.model(*self._stage_batch(batch))
        finally:
            self._unbind(binding)
            self.model.train() if saved_mode else self.model.eval()
        return _tree(out, lambda t: Tensor._wrap(full_value(t._value)))

    def evaluate(self, eval_data, steps=None, verbose: int = 0):
        if self.loss is None:
            raise ValueError("Engine.evaluate requires a loss function; "
                             "use predict() for raw outputs")
        losses = []
        for i, batch in enumerate(eval_data):
            if steps is not None and i >= steps:
                break
            batch = batch if isinstance(batch, (tuple, list)) else (batch,)
            losses.append(float(self.run_eval_step(*batch).numpy()))
        mean = float(np.mean(losses)) if losses else float("nan")
        if verbose:
            print(f"[auto_parallel.Engine] eval loss {mean:.5f}")
        return {"loss": mean}

    def predict(self, test_data, steps=None):
        outs = []
        for i, batch in enumerate(test_data):
            if steps is not None and i >= steps:
                break
            batch = batch if isinstance(batch, (tuple, list)) else (batch,)
            outs.append(_tree(self.run_pred_step(*batch),
                              lambda t: t.numpy()))
        return outs

    # -- program/cost surface ------------------------------------------------
    def dist_main_program(self, mode: str = "train", *batch) -> str:
        """The reference returns the partitioned program (StableHLO text);
        the port compiles nothing yet."""
        raise NotImplementedError(
            "paddle_tpu_torch: Engine.dist_main_program needs the compile "
            "tier (ROADMAP.md, queue 1, item 9); the Engine's step runs "
            "eagerly over DTensors")

    def cost_analysis(self, *batch, mode: str = "train") -> Dict[str, Any]:
        """``flops`` of one forward and backward (mode "train") or forward
        (otherwise) on this rank, counted by FlopCounterMode plus the flash
        kernels' own count from their shapes (a kernel launched through
        ctypes is invisible to it), and ``peak_memory_bytes`` of the CUDA
        allocator over it (0 on the CPU). Nothing is updated."""
        from torch.utils.flop_counter import FlopCounterMode

        from ...ops.kernels import flash_attention as FA

        self._ensure_prepared()
        staged = self._stage_batch(batch)
        cuda = self._device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernel_flops = FA.launched_flops
        counter = FlopCounterMode(display=False)
        with counter:
            if mode == "train" and self.optimizer is not None:
                loss = self._forward_loss(staged, train=True)
                leaves = [self._params[k] for k, _, _ in self._trainable()]
                with replication_scope([loss]):
                    torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                with torch.no_grad():
                    self._forward_loss(staged, train=False)
        out = {"flops": float(counter.get_total_flops()
                              + FA.launched_flops - kernel_flops)}
        if cuda:
            torch.cuda.synchronize()
            out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
        else:
            out["peak_memory_bytes"] = 0
        return out

    # -- state -------------------------------------------------------------
    def state_dict(self, mode: str = "all") -> Dict[str, Tensor]:
        """Write COPIES of the Engine's parameters, buffers and moments
        back into the model and its optimizer, and return the model's
        state dict (its DTensor entries give full arrays)."""
        self._ensure_prepared()
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                v = self._params[k].detach().clone()
                p._value = v.requires_grad_(self._params[k].requires_grad)
            for k, b in self.model.named_buffers():
                b._value = self._buffers[k].clone()
            if self._opt_states is not None:
                for k, p in self.model.named_parameters():
                    self.optimizer._accumulators[id(p)] = {
                        sk: sv.clone()
                        for sk, sv in self._opt_states[k].items()}
        return self.model.state_dict()

    def save(self, path: str, training: bool = True):
        """``path + ".pdparams"``: the full parameters (and with
        ``training`` the moments and the step count), written by rank 0;
        collective."""
        blob = {"state_dict": {k: v.numpy()
                               for k, v in self.state_dict().items()}}
        if training and self._opt_states is not None:
            blob["opt_states"] = {
                k: {sk: full_value(sv).cpu().numpy()
                    for sk, sv in st.items()}
                for k, st in self._opt_states.items()}
            blob["opt_step_count"] = int(self.optimizer._step_count)
        if self._dm.get_rank() == 0:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path + ".pdparams", "wb") as f:
                pickle.dump(blob, f)
        _barrier()

    def load(self, path: str):
        with open(path + ".pdparams", "rb") as f:
            data = pickle.load(f)
        self.model.set_state_dict(data["state_dict"])
        if self._params is not None or self.optimizer is not None:
            # staged again now, so that the moments below land on it
            self.prepare()
        if "opt_states" in data and self._opt_states is not None:
            for k, st in data["opt_states"].items():
                if k in self._opt_states:
                    leaf = self._params[k]
                    self._opt_states[k] = {
                        sk: self._stage(torch.from_numpy(sv),
                                        leaf.placements)
                        if tuple(sv.shape) == tuple(leaf.shape)
                        else torch.from_numpy(sv)
                        for sk, sv in st.items()}
            self.optimizer._step_count = int(
                data.get("opt_step_count", self.optimizer._step_count))


def _barrier():
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.barrier()


def _tree(out, fn):
    if isinstance(out, (list, tuple)):
        return type(out)(_tree(o, fn) for o in out)
    if isinstance(out, Tensor):
        return fn(out)
    return out

