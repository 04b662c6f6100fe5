"""The attention ops of the op registry (paddle_tpu/ops/yaml_extra.py:
796-860), registered through ops/registry.py::register under the
reference's op names. Each takes and returns torch tensors, as the
reference's take and return arrays, wraps them into eager Tensors (the
autograd graph kept) and returns (out, None, None, None):

- ``flash_attn`` / ``flash_attn_qkvpacked``: [B, S, H, D] attention
  through F.scaled_dot_product_attention (the flash kernels for a CUDA
  tensor of a kernel shape). As the reference writes them, they pass on
  the mask and ``causal`` and no dropout;
- ``flash_attn_unpadded`` / ``flash_attn_varlen_qkvpacked``: packed
  [total, H, D] attention through incubate.nn.functional's entries (the
  varlen forward and its two backward kernels on a card); a dense
  ``attn_mask`` raises, as in the reference.

The rest of the reference's yaml_extra ops are ROADMAP.md's queue 1, item
10.
"""
from __future__ import annotations

from ..core.tensor import Tensor
from .registry import register

__all__ = []


def _reg(name, differentiable=True):
    def deco(f):
        f.__name__ = name
        register(name, f, differentiable=differentiable)
        globals()[name] = f
        __all__.append(name)
        return f
    return deco


def _t(x):
    return None if x is None else Tensor._wrap(x)


@_reg("flash_attn")
def _flash_attn(q, k, v, fixed_seed_offset=None, attn_mask=None,
                dropout=0.0, causal=False, return_softmax=False,
                is_test=False, rng_name=""):
    from ..nn import functional as F

    out = F.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                         attn_mask=_t(attn_mask),
                                         is_causal=causal)
    return out._value, None, None, None


@_reg("flash_attn_qkvpacked")
def _flash_attn_qkvpacked(qkv, fixed_seed_offset=None, attn_mask=None,
                          dropout=0.0, causal=False, return_softmax=False,
                          is_test=False, rng_name=""):
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, S, 3, H, D]
    return _flash_attn(q, k, v, fixed_seed_offset, attn_mask, dropout,
                       causal, return_softmax, is_test, rng_name)


@_reg("flash_attn_unpadded")
def _flash_attn_unpadded_op(q, k, v, cu_seqlens_q, cu_seqlens_k,
                            fixed_seed_offset=None, attn_mask=None,
                            max_seqlen_q=0, max_seqlen_k=0, scale=1.0,
                            dropout=0.0, causal=False,
                            return_softmax=False, is_test=False,
                            rng_name=""):
    from ..incubate.nn import functional as incf

    if attn_mask is not None:
        raise NotImplementedError(
            "flash_attn_unpadded: a dense attn_mask on the varlen path is "
            "not implemented: dropping it would unmask positions")
    out, _ = incf.flash_attn_unpadded(
        _t(q), _t(k), _t(v), cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, scale or None, dropout, causal, return_softmax,
        training=not is_test)
    return out._value, None, None, None


@_reg("flash_attn_varlen_qkvpacked")
def _flash_attn_varlen_qkvpacked_op(qkv, cu_seqlens_q, cu_seqlens_k, **kw):
    from ..incubate.nn import functional as incf

    fwd_kw = {k_: v_ for k_, v_ in kw.items()
              if k_ in ("max_seqlen_q", "max_seqlen_k", "scale", "dropout",
                        "causal", "return_softmax")}
    fwd_kw["training"] = not kw.get("is_test", False)
    out, _ = incf.flash_attn_varlen_qkvpacked(_t(qkv), cu_seqlens_q,
                                              cu_seqlens_k, **fwd_kw)
    return out._value, None, None, None
