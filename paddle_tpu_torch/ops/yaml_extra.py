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

Beside them, the MoE helper ops (yaml_extra.py:571-626): ``number_count``,
``assign_pos``, ``limit_by_capacity``, ``prune_gate_by_capacity``,
``random_routing`` (its uniform draw from a torch.Generator seeded with
``seed``, or given) and the dense-expert ``moe`` block.

The rest of the reference's yaml_extra ops are ROADMAP.md's queue 1, item
10.
"""
from __future__ import annotations

import torch

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


# ---------------------------------------------------------------------------
# MoE helper ops (yaml_extra.py:571-626)
# ---------------------------------------------------------------------------

@_reg("number_count", differentiable=False)
def _number_count(numbers, upper_range):
    """How many of ``numbers`` fall on each of 0 .. upper_range - 1, a
    number outside the range counted at its clipped end (int64)."""
    n = int(upper_range)
    flat = torch.as_tensor(numbers).reshape(-1).long().clamp(0, n - 1)
    return torch.zeros(n, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


@_reg("assign_pos", differentiable=False)
def _assign_pos(x, cum_count, eff_num_len):
    """The first ``eff_num_len`` token indices in expert order (a stable
    sort of the expert ids)."""
    flat = torch.as_tensor(x).reshape(-1)
    return torch.argsort(flat, stable=True)[:int(eff_num_len)]


@_reg("limit_by_capacity", differentiable=False)
def _limit_by_capacity(expert_count, capacity, n_worker):
    counts = torch.as_tensor(expert_count).reshape(int(n_worker), -1)
    cap = torch.as_tensor(capacity, device=counts.device)
    return torch.minimum(counts, cap[None, :]).reshape(-1)


@_reg("prune_gate_by_capacity", differentiable=False)
def _prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker):
    """Each token's gate index, or -1 where it is past its expert's
    count, in token order (an index outside the experts, as -1, counts
    nowhere and stays as it is)."""
    g = torch.as_tensor(gate_idx).reshape(-1).long()
    counts = torch.as_tensor(expert_count).reshape(-1)
    total = int(n_expert) * int(n_worker)
    one_hot = (g[:, None] == torch.arange(total, device=g.device)).long()
    pos = (one_hot.cumsum(dim=0) * one_hot).sum(dim=-1) - 1
    return torch.where(pos < counts[g], g, torch.full_like(g, -1))


@_reg("random_routing", differentiable=False)
def _random_routing(prob, topk_value, topk_idx, seed=0, draw=None):
    """topk_idx where prob beats a uniform draw, else -1. The reference
    draws from jax.random, which this package cannot reproduce bit for
    bit: here the draw comes from a torch.Generator seeded with ``seed``
    (the port's default generator when 0), or is given as ``draw``."""
    prob = torch.as_tensor(prob)
    if draw is None:
        if seed:
            gen = torch.Generator(device=prob.device).manual_seed(int(seed))
        else:
            from ..framework.random import generator
            gen = generator(prob.device)
        draw = torch.rand(prob.shape, generator=gen, device=prob.device)
    keep = prob.reshape(-1) > torch.as_tensor(draw).reshape(-1)
    idx = torch.as_tensor(topk_idx).reshape(-1)
    return torch.where(keep, idx, torch.full_like(idx, -1))


@_reg("moe")
def _moe(x, gate, bmm0_w, bmm1_w, act_type="gelu"):
    """The dense-expert MoE block: every expert's FFN (GELU in its tanh
    form, as jax.nn.gelu's default, or ReLU) mixed by the softmax of
    ``gate`` (experts on the weights' leading dim)."""
    probs = torch.softmax(gate, dim=-1)
    h = torch.einsum("bsd,edf->ebsf", x, bmm0_w)
    h = torch.nn.functional.gelu(h, approximate="tanh") \
        if act_type == "gelu" else torch.relu(h)
    y = torch.einsum("ebsf,efd->ebsd", h, bmm1_w)
    return torch.einsum("ebsd,bse->bsd", y, probs)
