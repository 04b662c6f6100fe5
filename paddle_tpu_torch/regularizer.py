"""Weight-decay regularizers (paddle_tpu/regularizer.py).

An optimizer's ``weight_decay`` takes a float (L2), an ``L2Decay`` or an
``L1Decay``. Each resolves to a tag its update folds into the gradient
(optimizer/optimizer.py::_decayed): a float is L2, grad + coeff * param;
("l1", coeff) is L1, grad + coeff * sign(param).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    """Base class of weight-decay regularizers."""

    def __call__(self, param, grad):
        raise NotImplementedError

    def _wd_tag(self):
        """The hashable tag the optimizers' update reads."""
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: grad += coeff * sign(param)."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        from .core.dispatch import apply

        return apply(lambda p, g: g + torch.sign(p) * self._coeff, param,
                     grad, op_name="l1_decay")

    def _wd_tag(self):
        return ("l1", self._coeff)

    def __str__(self):
        return f"L1Decay, coeff={self._coeff}"


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        return grad + param * self._coeff

    def _wd_tag(self):
        return self._coeff      # the float's tag: the same update

    def __str__(self):
        return f"L2Decay, coeff={self._coeff}"


def _normalize_weight_decay(wd):
    """float | L1Decay | L2Decay | None -> the update's tag."""
    if wd is None:
        return 0.0
    if isinstance(wd, WeightDecayRegularizer):
        return wd._wd_tag()
    return float(wd)
