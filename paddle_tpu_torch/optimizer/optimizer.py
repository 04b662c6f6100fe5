"""Optimizers of the eager surface (paddle_tpu/optimizer/optimizer.py:
55-369): the Optimizer base, SGD, Adam, AdamW and the gradient clips.

The TPU package jits one fused update over the parameter pytree; here the
update runs as ``torch._foreach_*`` ops over the parameter list, in place,
with the TPU package's f32 arithmetic: gradients and moments in f32, the
bias corrections 1 - beta^t computed in f32, AdamW's decay added to the
update (decoupled, ``_decay_tag``), and the new value cast back to the
parameter's dtype. The moments are made on the default place
(core/place.py), as Paddle makes its accumulators on the expected place.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.place import to_torch_device
from ..core.tensor import Tensor, dtensor_class, to_torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "ClipGradByGlobalNorm"]

# parameters a foreach group updates at most: bounds the f32 temporaries
# (four of the group's size) at ~2 GB
_GROUP_ELEMENTS = 1 << 27


def _f32(x) -> float:
    """A Python float holding the f32 rounding of ``x``: multiplying an
    f32 tensor by it is the TPU package's f32 arithmetic."""
    return float(torch.tensor(x, dtype=torch.float32))


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
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._accumulators: Dict[int, dict] = {}
        self._step_count = 0

    # -- learning rate ------------------------------------------------------
    def get_lr(self) -> float:
        """The learning rate: a float, or the value of a scheduler (an
        object called for its current rate, as Paddle's LRScheduler)."""
        lr = self._learning_rate
        return float(lr() if callable(lr) else lr)

    def set_lr(self, value):
        self._learning_rate = float(value)
        return self._learning_rate

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
        """The weight decay of one parameter: none where AdamW's
        ``apply_decay_param_fun`` refuses its name."""
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

    @torch.no_grad()
    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad()

    clear_gradients = clear_grad

    # -- serialization ------------------------------------------------------
    def state_dict(self):
        """{"_step_count": n, "<param name>.<moment>": Tensor copy, ...}."""
        out = {"_step_count": self._step_count}
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
        pf = [p._value.float() for p in ps]
        if wd:
            # L2: grad + wd * param
            gs = torch._foreach_add(gs, torch._foreach_mul(pf, _f32(wd)))
        new = torch._foreach_sub(pf, torch._foreach_mul(gs, lr))
        self._write_back(ps, new)


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
            gs = torch._foreach_add(gs, torch._foreach_mul(pf, _f32(wd)))
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
            torch._foreach_add_(upd, torch._foreach_mul(pf, _f32(wd)))
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
