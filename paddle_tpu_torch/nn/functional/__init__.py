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

Conv, pooling and batch norm (nn/functional/__init__.py:236-861) have no
Pallas kernel in the reference (lax.conv_general_dilated, lax.reduce_window
and jnp): here conv is PyTorch's ``F.conv*d`` (cuDNN on a card) and
pooling PyTorch's pools, held to the reference's padding forms, output
shapes and divisors; batch norm's training statistics and backward are
``_BatchNormTrain``, a torch.autograd.Function with the reference's
numerics.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ...core.dispatch import apply
from ...core.tensor import Tensor
from ...framework.random import generator
from ...ops.kernels import flash_attention as _fa
from ...ops.math import promote
from .. import modules as _m

__all__ = ["linear", "rms_norm", "layer_norm", "embedding", "relu", "tanh",
           "gelu", "dropout", "cross_entropy", "mse_loss",
           "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "batch_norm", "flatten"]


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


# ---------------------------------------------------------------------------
# conv (nn/functional/__init__.py:236-395)
# ---------------------------------------------------------------------------

_TF = torch.nn.functional
_CONV = {1: _TF.conv1d, 2: _TF.conv2d, 3: _TF.conv3d}
_CONV_T = {1: _TF.conv_transpose1d, 2: _TF.conv_transpose2d,
           3: _TF.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v * n if len(v) == 1 else v


def _explicit_pads(padding, n):
    """The reference's padding forms: an int, one per spatial dim, or
    [lo, hi] per dim, flat (nn/functional/__init__.py:252-263)."""
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    p = [int(i) for i in np.asarray(padding).reshape(-1)]
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    return [(i, i) for i in p[:n]]


def _string_pads(padding, sizes, windows, strides):
    """XLA's "SAME" / "VALID" as explicit (lo, hi) pads: SAME keeps
    ceil(size / stride) outputs at any stride and puts total // 2 low
    (torch's padding="same" refuses stride > 1)."""
    mode = padding.upper()
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode not in ("SAME", "SAME_LOWER"):
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for size, k, s in zip(sizes, windows, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        lo = total // 2 if mode == "SAME" else total - total // 2
        pads.append((lo, total - lo))
    return pads


def _torch_pad(pads):
    """[(lo, hi)] by spatial dim -> F.pad's order (last dim first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channel_last(data_format):
    return data_format.endswith("C") and len(data_format) > 2


def _add_bias(out, b, n):
    out, b = promote(out, b)
    return out + b.reshape([1, -1] + [1] * n)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, n, op_name):
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    last = _channel_last(data_format)

    def fn(a, w, *bs):
        a, w = promote(a, w)
        if last:
            a = a.movedim(-1, 1)
        if isinstance(padding, str):
            pads = _string_pads(
                padding, a.shape[2:],
                [(w.shape[2 + i] - 1) * dilations[i] + 1 for i in range(n)],
                strides)
        else:
            pads = _explicit_pads(padding, n)
        if all(lo == hi >= 0 for lo, hi in pads):
            sym = [lo for lo, _ in pads]
        else:
            a, sym = _TF.pad(a, _torch_pad(pads)), 0
        out = _CONV[n](a, w, None, strides, sym, dilations, groups)
        if bs:
            out = _add_bias(out, bs[0], n)
        return out.movedim(1, -1) if last else out

    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, op_name=op_name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3, "conv3d")


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, data_format, n, op_name):
    """The whole transposed product (weight [in, out / groups, *k]), then
    each dim cut to the reference's window: ``lo`` off the low side,
    ``hi - output_padding`` off the high side (zeros where that is
    negative), as its dilated conv with pads (k - 1 - lo,
    k - 1 - hi + output_padding) gives (nn/functional/__init__.py:313-371).
    Unlike torch's, any output_padding is taken."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    last = _channel_last(data_format)
    pads = _explicit_pads(padding, n)
    opad = _norm_tuple(output_padding, n)
    cut = _torch_pad([(-lo, -hi + o) for (lo, hi), o in zip(pads, opad)])

    def fn(a, w, *bs):
        a, w = promote(a, w)
        if last:
            a = a.movedim(-1, 1)
        out = _CONV_T[n](a, w, None, strides, 0, 0, groups, dilations)
        if any(cut):
            out = _TF.pad(out, cut)
        if bs:
            out = _add_bias(out, bs[0], n)
        return out.movedim(1, -1) if last else out

    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, op_name=op_name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              1, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              2, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, data_format,
                              3, "conv3d_transpose")


# ---------------------------------------------------------------------------
# pooling (nn/functional/__init__.py:397-607)
# ---------------------------------------------------------------------------

_MAX_POOL = {2: _TF.max_pool2d, 3: _TF.max_pool3d}
_AVG_POOL = {2: _TF.avg_pool2d, 3: _TF.avg_pool3d}


def _lowest(dtype):
    """The pad value a max never picks (ops/nn_compat.py:170-175)."""
    if dtype.is_floating_point:
        return float(np.finfo(np.float32).min) if dtype == torch.bfloat16 \
            else float(torch.finfo(dtype).min)
    return int(torch.iinfo(dtype).min)


def _pool_nd(x, kernel_size, stride, padding, n, kind, ceil_mode,
             count_include_pad, data_format, op_name, divisor_override=None):
    """The reference's reduce_window pools. Its ``ceil_mode`` widens the
    high padding and keeps a last window that starts in it (torch drops
    that window), and its average divides by the real elements a window
    covers under ceil_mode or string padding whatever ``exclusive`` says.
    Where torch's pool computes the same (symmetric pads of at most half
    the window, no ceil_mode, no string), it runs as it is; otherwise the
    input is padded explicitly (the lowest value for max, 0 for avg) and
    the sum divided by a pool of ones. A 1-D pool runs as a 2-D one."""
    ks = _norm_tuple(kernel_size, n)
    st = _norm_tuple(stride if stride is not None else kernel_size, n)
    last = _channel_last(data_format)
    string = isinstance(padding, str)

    def fn(a):
        if last:
            a = a.movedim(-1, 1)
        sizes = a.shape[-n:]
        if string:
            pads = _string_pads(padding, sizes, ks, st)
        else:
            pads = _explicit_pads(padding, n)
            if ceil_mode:
                pads = [(lo, hi + max((-(-(s + lo + hi - k) // d)) * d + k
                                      - (s + lo + hi), 0))
                        for (lo, hi), s, k, d in zip(pads, sizes, ks, st)]
        k2, s2, p2 = ks, st, pads
        if n == 1:
            a, k2, s2, p2 = a.unsqueeze(-2), (1,) + ks, (1,) + st, \
                [(0, 0)] + pads
        m = len(k2)
        native = not string and not ceil_mode and all(
            lo == hi and 0 <= lo <= k // 2 for (lo, hi), k in zip(p2, k2))
        sym = [lo for lo, _ in p2]
        if kind == "max":
            if native:
                out = _MAX_POOL[m](a, k2, s2, sym)
            else:
                out = _MAX_POOL[m](_TF.pad(a, _torch_pad(p2),
                                           value=_lowest(a.dtype)), k2, s2)
        elif native:
            out = _AVG_POOL[m](a, k2, s2, sym,
                               count_include_pad=count_include_pad,
                               divisor_override=divisor_override)
        else:
            total = _AVG_POOL[m](_TF.pad(a, _torch_pad(p2)), k2, s2,
                                 divisor_override=1)
            if divisor_override is not None:
                out = total / float(divisor_override)
            elif count_include_pad and not ceil_mode and not string:
                out = total / float(math.prod(ks))
            else:
                ones = torch.ones((1, 1) + tuple(a.shape[-m:]),
                                  dtype=a.dtype, device=a.device)
                counts = _AVG_POOL[m](_TF.pad(ones, _torch_pad(p2)), k2, s2,
                                      divisor_override=1)
                out = total / counts
        if n == 1:
            out = out.squeeze(-2)
        return out.movedim(1, -1) if last else out

    return apply(fn, x, op_name=op_name)


def _max_pool_with_index(x, kernel_size, stride, padding, n,
                         ceil_mode=False):
    """Values and flat spatial indices of each window's max
    (ops/nn_compat.py:178-230): the input padded with the lowest value,
    one strided slice a window offset stacked on a K axis, max and argmax
    (the first) over it."""
    def tup(v):
        if isinstance(v, (int, np.integer)):
            return (int(v),) * n
        return tuple(int(i) for i in np.asarray(v).reshape(-1))[:n]

    ks, st, pd = tup(kernel_size), tup(stride or kernel_size), tup(padding)
    spatial = x.shape[2:2 + n]
    pads = []
    for d in range(n):
        hi = pd[d]
        if ceil_mode:
            span = spatial[d] + 2 * pd[d] - ks[d]
            out_d = -(-span // st[d]) + 1
            hi = max(hi, (out_d - 1) * st[d] + ks[d] - spatial[d] - pd[d])
        pads.append((pd[d], hi))
    xp = _TF.pad(x, _torch_pad(pads), value=_lowest(x.dtype))
    out_sp = tuple((xp.shape[2 + d] - ks[d]) // st[d] + 1 for d in range(n))
    slabs = []
    for off in itertools.product(*[range(k) for k in ks]):
        idx = (slice(None), slice(None)) + tuple(
            slice(off[d], off[d] + (out_sp[d] - 1) * st[d] + 1, st[d])
            for d in range(n))
        slabs.append(xp[idx])
    patches = torch.stack(slabs, dim=2)
    vals = patches.amax(dim=2)
    rem = patches.argmax(dim=2)
    grid = torch.meshgrid(*[torch.arange(s, device=x.device)
                            for s in out_sp], indexing="ij")
    idx = torch.zeros_like(rem)
    for d in range(n):
        inner = math.prod(ks[d + 1:])
        off_d, rem = rem // inner, rem % inner
        pos = grid[d].reshape((1, 1) + out_sp) * st[d] - pd[d] + off_d
        idx = idx * spatial[d] + pos.clamp(0, spatial[d] - 1)
    return vals, idx.to(torch.int32)


def _max_pool_indices(x, kernel_size, stride, padding, n, ceil_mode,
                      data_format, op_name):
    last = data_format in ("NLC", "NHWC", "NDHWC")
    if isinstance(padding, str):
        if padding.upper() != "VALID":
            raise NotImplementedError(
                "padding='SAME' with return_mask=True is not supported; "
                "pass explicit integer padding")
        padding = 0
    if isinstance(padding, (list, tuple)) and len(padding) not in (1, n):
        raise ValueError(
            f"return_mask=True expects per-dim padding of length {n}, "
            f"got {padding!r} (per-side [lo, hi] pads unsupported here)")

    def fn(a):
        if last:
            a = a.movedim(-1, 1)
        v, i = _max_pool_with_index(a, kernel_size, stride, padding, n,
                                    ceil_mode)
        if last:
            v, i = v.movedim(1, -1), i.movedim(1, -1)
        return v, i

    return apply(fn, x, op_name=op_name)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_indices(x, kernel_size, stride, padding, 1,
                                 ceil_mode, data_format,
                                 "max_pool1d_with_index")
    return _pool_nd(x, kernel_size, stride, padding, 1, "max", ceil_mode,
                    True, data_format, "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_indices(x, kernel_size, stride, padding, 2,
                                 ceil_mode, data_format,
                                 "max_pool2d_with_index")
    return _pool_nd(x, kernel_size, stride, padding, 2, "max", ceil_mode,
                    True, data_format, "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_indices(x, kernel_size, stride, padding, 3,
                                 ceil_mode, data_format,
                                 "max_pool3d_with_index")
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", ceil_mode,
                    True, data_format, "max_pool3d")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", ceil_mode,
                    not exclusive, data_format, "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", ceil_mode,
                    not exclusive, data_format, "avg_pool2d",
                    divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", ceil_mode,
                    not exclusive, data_format, "avg_pool3d",
                    divisor_override)


_ADAPTIVE = {("avg", 2): _TF.adaptive_avg_pool2d,
             ("avg", 3): _TF.adaptive_avg_pool3d,
             ("max", 2): _TF.adaptive_max_pool2d,
             ("max", 3): _TF.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, n, mode, op_name):
    """Windows [floor(i * in / out), ceil((i + 1) * in / out)) over the
    last ``n`` axes, as the reference's (nn/functional/__init__.py:
    551-583), which reads no data_format either."""
    osize = _norm_tuple(output_size, n)

    def fn(a):
        if n == 1:
            return _ADAPTIVE[mode, 2](a.unsqueeze(-2), (1,) + osize) \
                .squeeze(-2)
        return _ADAPTIVE[mode, n](a, osize)
    return apply(fn, x, op_name=op_name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 1, "max", "adaptive_max_pool1d")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 2, "max", "adaptive_max_pool2d")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 3, "max", "adaptive_max_pool3d")
    return (out, None) if return_mask else out


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    from ...ops.manipulation import flatten as _flatten

    return _flatten(x, start_axis, stop_axis)


# ---------------------------------------------------------------------------
# batch norm (nn/functional/__init__.py:699-861)
# ---------------------------------------------------------------------------

_LOW = (torch.bfloat16, torch.float16)


def _stat_dtype(a):
    """f32 statistics, f64 for an f64 x (which the reference never has)."""
    return torch.float64 if a.dtype == torch.float64 else torch.float32


class _BatchNormTrain(torch.autograd.Function):
    """Training batch norm: f32 batch statistics (mean and biased
    variance over every axis but the channel's) and a backward written by
    hand, x-hat recomputed from the saved input (nn/functional/__init__.py:
    699-761): one reduction pass for the weight's and bias's gradients,
    one elementwise pass for x's. Returns (out, mean, var); mean and var
    carry no gradient.

    A bf16 / fp16 x takes the reference's core: the normalize folded into
    one per-channel multiply-add in x's dtype, the backward in x's dtype
    with f32 sums. Any other x takes the reference's f32 formula,
    ``(x - mean) * rsqrt(var + eps) * w + b`` (its gradient, which the
    reference's autodiff computes, is the same two passes in f32); only x
    is saved, not the formula's f32 intermediates. An f64 x stays f64
    throughout."""

    @staticmethod
    def forward(ctx, a, w, b, ch_axis, eps):
        axes = tuple(i for i in range(a.dim()) if i != ch_axis)
        sh = [1] * a.dim()
        sh[ch_axis] = -1
        sd = _stat_dtype(a)
        var, mean = torch.var_mean(a.to(sd), dim=axes, correction=0)
        if a.dtype in _LOW:
            scale = torch.rsqrt(var + eps) * w
            off = b - mean * scale
            out = a * scale.to(a.dtype).reshape(sh) \
                + off.to(a.dtype).reshape(sh)
        else:
            out = ((a.to(sd) - mean.reshape(sh))
                   * torch.rsqrt(var.reshape(sh) + eps) * w.reshape(sh)
                   + b.reshape(sh)).to(a.dtype)
        ctx.save_for_backward(a, w, mean, var)
        ctx.geometry = (axes, sh, eps)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        a, w, mean, var = ctx.saved_tensors
        axes, sh, eps = ctx.geometry
        n = float(math.prod(a.shape[i] for i in axes))
        k = torch.rsqrt(var + eps)
        sd = _stat_dtype(a)
        dt = a.dtype if a.dtype in _LOW else sd
        x = a.to(dt)
        dy = dy.to(dt)
        xhat = (x - mean.to(dt).reshape(sh)) * k.to(dt).reshape(sh)
        dbeta = dy.sum(dim=axes, dtype=sd)
        dgamma = (dy * xhat).sum(dim=axes, dtype=sd)
        g = (w * k).to(dt).reshape(sh)
        dx = g * (dy - (dbeta / n).to(dt).reshape(sh)
                  - xhat * (dgamma / n).to(dt).reshape(sh))
        return dx.to(a.dtype), dgamma, dbeta, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's, in four branches as
    the reference's (nn/functional/__init__.py:765-861): training on
    batch statistics (``_BatchNormTrain``; bf16 and f32 x), bf16 inference
    as one folded per-channel multiply-add in x's dtype, f32 inference.
    In training the running buffers follow Paddle's convention, in place:
    running = momentum * running + (1 - momentum) * batch, with the
    unbiased variance (n / (n - 1)), from the statistics the op computed.
    Under auto_cast, batch_norm is black-listed: x arrives in f32."""
    ndim = len(x.shape)
    ch_axis = 1 if (data_format[1] == "C" or ndim <= 2) else ndim - 1
    if ndim <= 2:
        ch_axis = ndim - 1
    use_batch_stats = training and not use_global_stats

    def fn(a, rm, rv, *wb):
        shape = [1] * a.dim()
        shape[ch_axis] = -1
        it = iter(wb)
        w = next(it) if weight is not None else None
        b = next(it) if bias is not None else None
        sd = _stat_dtype(a)
        if use_batch_stats:
            c = a.shape[ch_axis]
            w = w.to(sd) if w is not None else \
                torch.ones(c, dtype=sd, device=a.device)
            b = b.to(sd) if b is not None else \
                torch.zeros(c, dtype=sd, device=a.device)
            return _BatchNormTrain.apply(a, w, b, ch_axis, epsilon)
        if a.dtype in _LOW:
            k = torch.rsqrt(rv.float() + epsilon)
            if w is not None:
                k = k * w.float()
            off = -rm.float() * k
            if b is not None:
                off = off + b.float()
            return a * k.to(a.dtype).reshape(shape) \
                + off.to(a.dtype).reshape(shape)
        out = (a.to(sd) - rm.reshape(shape)) * torch.rsqrt(
            rv.reshape(shape).to(sd) + epsilon)
        if w is not None:
            out = out * w.reshape(shape).to(sd)
        if b is not None:
            out = out + b.reshape(shape).to(sd)
        return out.to(a.dtype)

    args = [x, running_mean, running_var] + [
        t for t in (weight, bias) if t is not None]
    if not use_batch_stats:
        return apply(fn, *args, op_name="batch_norm")
    out, m_t, v_t = apply(fn, *args, op_name="batch_norm")
    n = float(math.prod(x.shape[i] for i in range(ndim) if i != ch_axis))
    with torch.no_grad():
        rm, rv = running_mean._value, running_var._value
        unbiased = v_t._value * (n / max(n - 1, 1.0))
        rm.mul_(momentum).add_(m_t._value.to(rm.dtype) * (1 - momentum))
        rv.mul_(momentum).add_(unbiased.to(rv.dtype) * (1 - momentum))
    return out
