"""Functional ops of the eager surface (paddle_tpu/nn/functional): each
goes through the op funnel (core/dispatch.py::apply) under the reference's
op name, which the AMP lists key on.

``layer_norm`` computes in f32 and casts back to x's dtype, as the
reference does, so an O2 model's bf16 activations meet its f32 LayerNorm
weights. ``dropout`` draws its keep mask from the port's generator of the
tensor's device (framework/random.py): the reference's jax.random bits
cannot be reproduced, a seed repeats a draw within the port.

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
from ...core.tensor import Tensor
from ...framework.random import generator
from ...ops.kernels import flash_attention as _fa
from ...ops.math import promote
from .. import modules as _m

__all__ = ["linear", "rms_norm", "layer_norm", "embedding", "relu", "tanh",
           "gelu", "dropout", "cross_entropy", "mse_loss",
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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes
    (nn/functional/__init__.py:659-680): x, the weight and the bias in
    f32, the result cast back to x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(int(n) for n in normalized_shape)

    def fn(a, *wb):
        it = iter(wb)
        w = next(it).float() if weight is not None else None
        b = next(it).float() if bias is not None else None
        return torch.nn.functional.layer_norm(a.float(), shape, w, b,
                                              epsilon).to(a.dtype)

    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply(fn, *args, op_name="layer_norm")


def _act(op_name, fn):
    def op(x, name=None):
        return apply(fn, x, op_name=op_name)
    op.__name__ = op_name
    return op


relu = _act("relu", torch.relu)
tanh = _act("tanh", torch.tanh)


def gelu(x, approximate=False, name=None):
    """GELU: exact (erf) by default, the tanh form with ``approximate``
    (nn/functional/__init__.py:85)."""
    form = "tanh" if approximate else "none"
    return apply(lambda a: torch.nn.functional.gelu(a, approximate=form), x,
                 op_name="gelu")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (along ``axis`` only: one
    draw shared by the other axes); ``upscale_in_train`` scales the kept
    ones by 1 / (1 - p). Returns x itself when not training or p is 0
    (nn/functional/__init__.py:935-951)."""
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(x)

    def fn(a):
        shape = list(a.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            keep_axes = [ax % a.dim() for ax in axes]
            shape = [s if i in keep_axes else 1 for i, s in enumerate(shape)]
        keep = torch.rand(shape, generator=generator(a.device),
                          device=a.device) < 1.0 - p
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), zero)
        return torch.where(keep, a, zero)

    return apply(fn, x, op_name="dropout")


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


def mse_loss(input, label, reduction="mean", name=None):
    """The squared error, reduced (nn/functional/__init__.py:1101)."""
    return apply(lambda a, b: _reduce_loss(torch.square(a - b), reduction),
                 input, label, op_name="mse_loss")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention in the reference layout [B, S, H, D]
    (nn/functional/__init__.py:1332-1347): flash_attention_bshd, whose
    forward and backward are the CUDA flash kernels for a CUDA tensor of a
    kernel shape. ``attn_mask`` of the form [B|1, 1, 1, Sk], bool (True
    attends) or additive, streams through the kernels as their key-padding
    bias; any other mask (a 2-D [Sq, Sk] one, a generic [B, H, Sq, Sk] one)
    takes the materialised dense attention, dropout included
    (ops/pallas/flash_attention.py:633-690). Dropout draws its seed from
    the port's generator of the query's device."""
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
