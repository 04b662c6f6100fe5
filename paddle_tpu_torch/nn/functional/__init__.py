"""Functional ops of the eager surface (paddle_tpu/nn/functional): each
goes through the op funnel (core/dispatch.py::apply) under the reference's
op name, which the AMP lists key on.

``linear``, ``rms_norm`` and ``embedding`` run the serving model's raw
functions (nn/modules.py) inside the funnel. ``rms_norm`` and
``scaled_dot_product_attention`` call the kernels' wrappers
(ops/kernels/rms_norm.py, ops/kernels/flash_attention.py::
flash_attention_bshd): on a CUDA tensor of a shape the kernels take they
launch the CUDA kernels, on a CPU tensor they take the plain versions, and
at other shapes (a decode step's Sq = 1, a prefill not a multiple of 128)
the reference's own dense fallback, on either device.
"""
from __future__ import annotations

import torch

from ...core.dispatch import apply
from ...framework.random import generator
from ...ops.kernels import flash_attention as _fa
from ...ops.math import promote
from .. import modules as _m

__all__ = ["linear", "rms_norm", "embedding", "cross_entropy",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None, name=None):
    """x @ W (+ b), W [in, out] (nn/functional/__init__.py:226)."""
    if bias is None:
        return apply(lambda a, w: _m.linear(*promote(a, w)), x, weight,
                     op_name="linear")

    def fn(a, w, b):
        y, b = promote(_m.linear(*promote(a, w)), b)
        return y + b
    return apply(fn, x, weight, bias, op_name="linear")


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (nn/functional/__init__.py:683): the CUDA
    kernel and its gradient kernel for a CUDA tensor."""
    return apply(_m.rms_norm, x, weight, epsilon, op_name="rms_norm")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; zeros at ``padding_idx``
    (nn/functional/__init__.py:988)."""
    if padding_idx is None:
        return apply(_m.embedding, x, weight, op_name="embedding")

    def fn(ids, w):
        out = _m.embedding(ids, w)
        return torch.where((ids == padding_idx)[..., None],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device), out)
    return apply(fn, x, weight, op_name="embedding")


def _reduce_loss(per, reduction):
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Computed in f32 whatever the logits' dtype
    (nn/functional/__init__.py:1016): hard labels as lse - picked, the
    max under a stop-gradient; ``ignore_index`` rows count zero and are
    left out of the mean. ``use_softmax=False`` (probabilities as input)
    is not ported: no caller of the port needs it yet."""
    if not use_softmax:
        raise NotImplementedError(
            "paddle_tpu_torch: cross_entropy(use_softmax=False) is not "
            "ported yet")

    def fn(logits, lab, *w):
        ax = int(axis) % logits.dim()
        n_classes = logits.shape[ax]
        if soft_label:
            lf = logits.float()
            logp = torch.log_softmax(lf, dim=ax)
            labf = lab.float()
            if label_smoothing > 0.0:
                labf = labf * (1 - label_smoothing) \
                    + label_smoothing / n_classes
            return _reduce_loss(-(labf * logp).sum(dim=ax), reduction)
        li = lab
        if li.dim() == logits.dim() and li.shape[ax] == 1:
            li = li.squeeze(ax)
        li = li.long()
        valid = li != ignore_index
        li_safe = torch.where(valid, li, torch.zeros_like(li))
        picked = torch.take_along_dim(logits, li_safe.unsqueeze(ax),
                                      dim=ax).squeeze(ax).float()
        m = logits.amax(dim=ax, keepdim=True).float().detach()
        s = torch.exp(logits.float() - m).sum(dim=ax)
        lse = m.squeeze(ax) + torch.log(s)
        per = lse - picked
        if label_smoothing > 0.0:
            mean_logit = logits.float().mean(dim=ax)
            per = (1 - label_smoothing) * per \
                + label_smoothing * (lse - mean_logit)
        zero = torch.zeros((), dtype=per.dtype, device=per.device)
        per = torch.where(valid, per, zero)
        if w:
            wt = torch.where(valid, w[0].float()[li_safe], zero)
            per = per * wt
            if reduction == "mean":
                return per.sum() / torch.clamp(wt.sum(), min=1e-12)
        if reduction == "mean":
            return per.sum() / torch.clamp(valid.float().sum(), min=1.0)
        return _reduce_loss(per, reduction)

    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args, op_name="cross_entropy")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention in the reference layout [B, S, H, D]
    (nn/functional/__init__.py:1332-1347): flash_attention_bshd, whose
    forward and backward are the CUDA flash kernels for a CUDA tensor of a
    kernel shape. Dropout draws its seed from the port's generator of the
    query's device."""
    p = dropout_p if training else 0.0

    def fn(q, k, v, *m):
        d = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
        q, k, v = q.to(d), k.to(d), v.to(d)
        return _fa.flash_attention_bshd(
            q, k, v, m[0] if m else None, is_causal=is_causal, dropout_p=p,
            generator=generator(q.device) if p > 0.0 else None)

    args = [query, key, value] + ([attn_mask] if attn_mask is not None
                                  else [])
    return apply(fn, *args, op_name="scaled_dot_product_attention")
