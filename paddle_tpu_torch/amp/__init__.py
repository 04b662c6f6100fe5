"""AMP (paddle_tpu/amp/__init__.py): ``auto_cast`` at O1 and O2,
``decorate`` at O2 (LayerNorm and RMSNorm kept in float32) and
``GradScaler``.

bfloat16 shares float32's exponent range, so O1 bf16 needs no loss
scaling: GradScaler with bf16 stays a pass-through in effect, and its
inf/nan skip still guards the step (fp16 scales dynamically).
"""
from __future__ import annotations

import torch

from ..core import amp_state
from ..core.dtype import convert_dtype

__all__ = ["auto_cast", "decorate", "GradScaler"]


class auto_cast:
    """Context manager: auto_cast(enable, custom_white_list,
    custom_black_list, level, dtype)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.white = custom_white_list
        self.black = custom_black_list
        self.level = level
        self.dtype = convert_dtype(dtype)

    def __enter__(self):
        self._prev = amp_state.set_amp(self.enable, self.dtype, self.level,
                                       self.white, self.black)
        return self

    def __exit__(self, *exc):
        amp_state.restore_amp(self._prev)
        return False


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast the models' float parameters to the AMP dtype, except those
    of norm layers (LayerNorm, RMSNorm: amp/__init__.py:65-90, whose batch
    and group norms the port has not yet) and of ``excluded_layers``."""
    from ..nn.layer.norm import LayerNorm, RMSNorm

    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        target = convert_dtype(dtype)
        skip = (LayerNorm, RMSNorm) + tuple(excluded_layers or ())
        for model in model_list:
            for layer in model.sublayers(include_self=True):
                if isinstance(layer, skip):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.dtype.is_floating_point:
                        p._replace(p._value.to(target))
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaler (paddle_tpu/amp/__init__.py:95-185)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable or self._scale == 1.0:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        self._unscaled = True
        inv = 1.0 / self._scale
        found = False
        for p in optimizer._parameter_list:
            g = p._value.grad
            if g is None:
                continue
            gf = g.float() * inv
            if not bool(torch.isfinite(gf).all()):
                found = True
            g.copy_(gf)
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale_ratio(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]
