"""Optimizers of the eager surface (paddle_tpu/optimizer/optimizer.py:
55-369): the Optimizer base, SGD, Momentum, Adam, AdamW and the gradient
clips.

The TPU package jits one fused update over the parameter pytree; here the
update runs as ``torch._foreach_*`` ops over the parameter list, in place,
with the TPU package's f32 arithmetic: gradients, velocities and moments
in f32, the bias corrections 1 - beta^t computed in f32, AdamW's decay
added to the update (decoupled, ``_decay_tag``). Adam writes the new f32
value back cast to the parameter's dtype; SGD and Momentum subtract the
step cast to the parameter's dtype first, ``p - (lr * upd).astype(p.dtype)``
(on a bf16 parameter the step is rounded before the subtraction, and the
bits differ from rounding the f32 difference once). The weight
decay is a float (L2) or a regularizer (regularizer.py: L2Decay, L1Decay).
The learning rate is a float or an LRScheduler (optimizer/lr.py). The
state is made on the default place (core/place.py), as Paddle makes its
accumulators on the expected place.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.place import to_torch_device
from ..core.tensor import Tensor, dtensor_class, to_torch
from ..regularizer import _normalize_weight_decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "ClipGradByGlobalNorm"]

# parameters a foreach group updates at most: bounds the f32 temporaries
# (four of the group's size) at ~2 GB
_GROUP_ELEMENTS = 1 << 27


def _f32(x) -> float:
    """A Python float holding the f32 rounding of ``x``: multiplying an
    f32 tensor by it is the TPU package's f32 arithmetic."""
    return float(torch.tensor(x, dtype=torch.float32))


def _decayed(gs, pf, wd):
    """The gradients with a weight-decay tag's term added
    (optimizer.py::_decay_tag): a float is L2, g + wd * p; ("l1", coeff)
    is L1, g + coeff * sign(p)."""
    if isinstance(wd, tuple):
        return torch._foreach_add(gs, torch._foreach_mul(
            [p.sign() for p in pf], _f32(wd[1])))
    return torch._foreach_add(gs, torch._foreach_mul(pf, _f32(wd)))


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / max(global norm, clip_norm), the
    global norm over all of them in f32 (optimizer.py:55)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        sq = [g.float().square().sum() for g in grads if g is not None]
        return torch.sqrt(sum(sq)) if sq else None

    def apply(self, grads):
        norm = self.global_norm(grads)
        if norm is None:
            return grads
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [None if g is None else (g.float() * scale).to(g.dtype)
                for g in grads]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (eager mode)")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._weight_decay = _normalize_weight_decay(weight_decay)
        self._grad_clip = grad_clip
        self._accumulators: Dict[int, dict] = {}
        self._step_count = 0

    # -- learning rate ------------------------------------------------------
    def get_lr(self) -> float:
        """The learning rate: a float, or the value of a scheduler (an
        LRScheduler, or any object called for its current rate)."""
        lr = self._learning_rate
        return float(lr() if callable(lr) else lr)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)
        return self._learning_rate

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state --------------------------------------------------------------
    def _zeros(self, p):
        v = p._value
        dt = dtensor_class()
        if dt is not None and isinstance(v, dt):
            # a DTensor parameter's moments take its placements
            # (auto_parallel.shard_optimizer)
            return torch.zeros_like(v, dtype=torch.float32)
        return torch.zeros(v.shape, dtype=torch.float32,
                           device=to_torch_device())

    def _init_state(self, p) -> dict:
        return {}

    def _get_state(self, p) -> dict:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    def _decay(self, p, index):
        """The weight-decay tag of one parameter (``_decayed``): none where
        AdamW's ``apply_decay_param_fun`` refuses its name."""
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None and not fn(p.name or f"param_{index}"):
            return 0.0
        return self._weight_decay

    # -- the step -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        live = [(i, p) for i, p in enumerate(self._parameter_list)
                if not p.stop_gradient and p._value.grad is not None]
        if not live:
            return
        grads = [p._value.grad for _, p in live]
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        self._step_count += 1
        lr = _f32(self.get_lr())
        groups = {}
        for (i, p), g in zip(live, grads):
            groups.setdefault(self._decay(p, i), []).append((p, g))
        for wd, items in groups.items():
            chunk, size = [], 0
            for p, g in items:
                chunk.append((p, g))
                size += p._value.numel()
                if size >= _GROUP_ELEMENTS:
                    self._update_group(chunk, lr, wd)
                    chunk, size = [], 0
            if chunk:
                self._update_group(chunk, lr, wd)

    def _update_group(self, items, lr, wd):
        raise NotImplementedError

    @staticmethod
    def _write_back(params, new):
        """Each new f32 value into its parameter, cast to its dtype."""
        for p, n in zip(params, new):
            p._value.copy_(n)

    @staticmethod
    def _subtract(params, steps):
        """p - step.astype(p.dtype): each f32 step rounded to its
        parameter's dtype, then subtracted in that dtype."""
        for p, s in zip(params, steps):
            p._value.sub_(s.to(p._value.dtype))

    @torch.no_grad()
    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad()

    clear_gradients = clear_grad

    # -- serialization ------------------------------------------------------
    def state_dict(self):
        """{"_step_count": n, "<param name>.<moment>": Tensor copy, ...},
        with "LR_Scheduler" (its state_dict) under a scheduler."""
        out = {"_step_count": self._step_count}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for i, p in enumerate(self._parameter_list):
            st = self._accumulators.get(id(p))
            for k, v in (st or {}).items():
                out[f"{p.name or f'param_{i}'}.{k}"] = Tensor._wrap(
                    v.detach().clone())
        return out

    def set_state_dict(self, state):
        """Restore from ``state_dict()`` (Tensors, torch tensors or numpy
        arrays, put on the default place)."""
        self._step_count = int(state.get("_step_count", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = (p.name or f"param_{i}") + "."
            st = {k[len(prefix):]: to_torch(v, torch.float32,
                                            to_torch_device()).clone()
                  for k, v in state.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[id(p)] = st


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_group(self, items, lr, wd):
        ps = [p for p, _ in items]
        gs = [g.float() for _, g in items]
        if wd:
            gs = _decayed(gs, [p._value.float() for p in ps], wd)
        self._subtract(ps, torch._foreach_mul(gs, lr))


class Momentum(Optimizer):
    """v = momentum * v + g (f32 velocity, the decay in g); the step is
    lr * v, or lr * (g + momentum * v) with Nesterov
    (optimizer.py:289-311)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": self._zeros(p)}

    def _update_group(self, items, lr, wd):
        ps = [p for p, _ in items]
        v = [self._get_state(p)["velocity"] for p in ps]
        gs = [g.float() for _, g in items]
        if wd:
            gs = _decayed(gs, [p._value.float() for p in ps], wd)
        mom = _f32(self._momentum)
        torch._foreach_mul_(v, mom)
        torch._foreach_add_(v, gs)
        upd = torch._foreach_add(gs, torch._foreach_mul(v, mom)) \
            if self._nesterov else v
        self._subtract(ps, torch._foreach_mul(upd, lr))


class Adam(Optimizer):
    """Adam; its weight decay is L2 (added to the gradient). AdamW's is
    decoupled (added to the update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _init_state(self, p):
        st = {"moment1": self._zeros(p), "moment2": self._zeros(p)}
        if self._amsgrad:
            st["moment2_max"] = self._zeros(p)
        return st

    def _decoupled(self):
        return False

    def _update_group(self, items, lr, wd):
        ps = [p for p, _ in items]
        sts = [self._get_state(p) for p in ps]
        m = [s["moment1"] for s in sts]
        v = [s["moment2"] for s in sts]
        gs = [g.float() for _, g in items]
        pf = [p._value.float() for p in ps]
        b1, b2 = self._beta1, self._beta2
        t = torch.tensor(float(self._step_count), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        if wd and not self._decoupled():
            gs = _decayed(gs, pf, wd)
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g
        torch._foreach_mul_(m, _f32(b1))
        torch._foreach_add_(m, torch._foreach_mul(gs, _f32(1 - b1)))
        torch._foreach_mul_(v, _f32(b2))
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(gs, _f32(1 - b2)), gs))
        del gs
        vhat = torch._foreach_div(v, bc2)
        if self._amsgrad:
            vmax = [s["moment2_max"] for s in sts]
            torch._foreach_maximum_(vmax, vhat)
            vhat = [x.clone() for x in vmax]
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, _f32(self._eps))
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, vhat)
        del vhat
        if wd and self._decoupled():
            upd = _decayed(upd, pf, wd)
        torch._foreach_mul_(upd, lr)
        new = torch._foreach_sub(pf, upd)
        self._write_back(ps, new)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self):
        return True
