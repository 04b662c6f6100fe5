"""Fused ops of the ported slices (paddle_tpu/incubate/nn/functional).

``block_multihead_attention`` is the paged-KV attention of the serving
step. Its fresh-prefill route runs the varlen flash-attention kernel; its
decode and chunked-prefill route runs the paged-attention kernel
(ops/kernels/paged_attention.py), which reads K and V through the block
table. The stacked caches are updated IN PLACE (the reference returns new
arrays): a serving step writes each layer's new K/V straight into the one
[L, num_blocks, HKV, block_size, D] buffer pair, with no copy of the pool.
Before either, one RoPE-and-append kernel a layer
(ops/kernels/rope_append.py) rotates q and k and writes k and v into their
pages: cast for float pages, quantized with per-slot scales for the int8
mode (``use_dynamic_cachekv_quant``), whose pages the paged-attention
kernel's int8 instantiations read.
``paged_metadata`` computes what every layer of a step shares (each
token's row, position, page, slot and RoPE angles) once a step; a model
passes it to each layer's call.

``flash_attn_unpadded`` and ``flash_attn_varlen_qkvpacked`` are the
packed-sequence entry points, differentiable: their kernel route runs the
varlen flash-attention forward and its two backward kernels. They take
torch tensors (the packed trainer's) or eager Tensors, which go through
the op funnel as the op ``flash_attn_unpadded``. ``flash_attention`` is the
dense [B, S, H, D] entry over F.scaled_dot_product_attention.

``fused_rotary_position_embedding`` and ``swiglu`` are eager ops (through
core/dispatch.py::apply; they take and return Tensors), the eager Llama's
(incubate/nn/functional/__init__.py:58-181). ``fused_ec_moe`` is the
expert-computation MoE block (:424-443), an eager op too: every expert's
FFN on every token, mixed by the softmax of the gate, GELU in the tanh
form as the reference's ``jax.nn.gelu``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply
from ...core.tensor import Tensor
from ...nn import modules as _modules
from ...ops.kernels import paged_attention as PA
from ...ops.kernels import rope_append as RA
from ...ops.kernels.rope_append import _rope  # noqa: F401 (this module's)
from ...ops.kernels.varlen_attention import (segment_ids_from_cu_seqlens,
                                             varlen_flash_attention,
                                             varlen_flash_attention_packed)

__all__ = ["swiglu", "fused_rotary_position_embedding",
           "block_multihead_attention", "paged_metadata",
           "PagedMetadata", "flash_attention", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "fused_ec_moe"]


def swiglu(x, y=None, name=None):
    """silu(x) * y; with y None, x splits in two along the last axis
    (the serving model's nn/modules.py::swiglu inside the funnel)."""
    return apply(_modules.swiglu, x, y, op_name="swiglu")


def _apply_rope(t, cos, sin, use_neox):
    # t: [B, S, H, D] f32
    if use_neox:
        d2 = t.shape[-1] // 2
        rotated = torch.cat([-t[..., d2:], t[..., :d2]], dim=-1)
    else:
        rotated = torch.stack([-t[..., 1::2], t[..., 0::2]],
                              dim=-1).reshape(t.shape)
    return t * cos + rotated * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE of q (and k, v) in the layout [B, S, H, D], computed in f32 and
    cast back to each input's dtype. Without ``sin``/``cos`` the angles are
    position x rotary_emb_base^(-2i/D), at ``position_ids`` ([B, S] or
    [1, S], absolute positions) or 0..S-1; given tables are indexed by
    ``position_ids`` when it is set. Returns (q, k, v), None where not
    given (incubate/nn/functional/__init__.py:58-147)."""
    def fn(qa, *rest):
        it = iter(rest)
        ka = next(it) if k is not None else None
        va = next(it) if v is not None else None
        if sin is not None:
            sa, ca = next(it), next(it)
            if position_ids is not None:
                pid = next(it).long()
                d_last = sa.shape[-1]
                sa = sa.reshape(-1, d_last)[pid][:, :, None, :]
                ca = ca.reshape(-1, d_last)[pid][:, :, None, :]
        else:
            s, d = qa.shape[1], qa.shape[-1]
            inv = 1.0 / (rotary_emb_base ** (
                torch.arange(0, d, 2, dtype=torch.float32,
                             device=qa.device) / d))
            if position_ids is not None:
                freqs = next(it).float()[..., None] * inv      # [B, S, d/2]
            else:
                pos = torch.arange(s, dtype=torch.float32, device=qa.device)
                freqs = torch.outer(pos, inv)[None]           # [1, S, d/2]
            emb = torch.cat([freqs, freqs], dim=-1) if use_neox_rotary_style \
                else torch.repeat_interleave(freqs, 2, dim=-1)
            ca = torch.cos(emb)[:, :, None, :]
            sa = torch.sin(emb)[:, :, None, :]
        ca, sa = ca.float(), sa.float()
        return tuple(_apply_rope(t.float(), ca, sa,
                                 use_neox_rotary_style).to(t.dtype)
                     for t in (qa, ka, va) if t is not None)

    args = [q] + [t for t in (k, v) if t is not None]
    if sin is not None:
        args += [sin, cos]
    if position_ids is not None:
        args += [position_ids]
    outs = iter(apply(fn, *args, op_name="fused_rope"))
    return tuple(next(outs) if t is not None else None for t in (q, k, v))


class PagedMetadata(NamedTuple):
    """What every layer of one paged step shares: for each of the T packed
    tokens its batch row ``t2b``, cache position ``pos``, page and slot
    (where its new K/V go), and the RoPE ``cos`` / ``sin`` at its position
    ([T, 1, D/2], f32). All index tensors are int64 [T]."""
    t2b: torch.Tensor
    pos: torch.Tensor
    page: torch.Tensor
    slot: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def paged_metadata(num_tokens, seq_lens_encoder, seq_lens_decoder,
                   cu_seqlens_q, block_tables, block_size, rope_emb):
    """The per-step metadata of ``block_multihead_attention``
    (incubate/nn/functional/__init__.py:682-701): token -> (batch row,
    position), the page and slot each token writes, and the RoPE angles
    from rope_emb [2, B, 1, max_seq, D/2] at each position. Out-of-range
    lookups clamp as the reference's gathers do (the trash row's padding
    can run past max_seq). Tensor code only: no host sync, so it runs
    inside a CUDA graph's capture."""
    bt = block_tables.long()
    B, max_blocks = bt.shape
    cu_q = cu_seqlens_q.long()
    tok = torch.arange(num_tokens, device=cu_q.device)
    t2b = torch.searchsorted(cu_q[1:].contiguous(), tok, right=True) \
        .clamp(max=B - 1)
    tok_in_seq = tok - cu_q[t2b]
    start = torch.where(seq_lens_encoder.reshape(-1) > 0,
                        torch.zeros_like(seq_lens_decoder.reshape(-1)),
                        seq_lens_decoder.reshape(-1)).long()
    pos = start[t2b] + tok_in_seq
    re = rope_emb.reshape(2, B, -1, rope_emb.shape[-1])
    pos_r = pos.clamp(max=re.shape[2] - 1)
    cos = re[0][t2b, pos_r][:, None, :]
    sin = re[1][t2b, pos_r][:, None, :]
    page = bt[t2b, (pos // block_size).clamp(max=max_blocks - 1)]
    slot = pos % block_size
    return PagedMetadata(t2b, pos, page, slot, cos, sin)


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, cu_seqlens_q,
                              block_tables, rope_emb, *, layer_idx,
                              fresh_prefill=False,
                              cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              use_dynamic_cachekv_quant=False,
                              pre_key_cache=None, mask=None, tgt_mask=None,
                              metadata=None):
    """Paged-KV attention (incubate/nn/functional/__init__.py:544-772).

    qkv [T, (HQ + 2 HKV) D] packs each batch row's tokens of this step: row
    b contributes seq_lens_this_time[b] tokens starting at cache position
    seq_lens_decoder[b] (0 when seq_lens_encoder[b] > 0). Caches are the
    stacked page pools [L, num_blocks, HKV, block_size, D]; this call
    reads and writes layer ``layer_idx``. block_tables [B, max_blocks]
    maps each row's logical blocks to pages. HKV divides HQ (GQA).
    rope_emb [2, B, 1, max_seq, D/2] holds (cos, sin) for interleaved
    RoPE. One ``rope_append`` call rotates q and k and writes the new K/V
    into their pages in place, then each token attends its row's filled
    prefix (causal) through the paged-attention kernel (the plain versions
    for CPU tensors). Returns (out [T, HQ D], qkv, key_cache,
    value_cache).

    ``metadata``: this step's ``paged_metadata`` (the same for every
    layer), computed here from the arguments when None; the results are
    the same bits either way.

    fresh_prefill=True asserts every scheduled row starts at position 0:
    attention then runs as block-diagonal varlen flash over the packed
    step, and the LAST batch row (B - 1) is the engine's trash row, whose
    tokens get segment id -1 and attend nothing.

    Int8 cache (use_dynamic_cachekv_quant=True, :577-587): the caches are
    int8 page pools and cache_k_quant_scales / cache_v_quant_scales the
    stacked per-slot f32 scale pools [L, num_blocks, HKV, block_size]; each
    written (token, head) stores its codes and scale (ops/kernels/
    rope_append.py), and the paged route dequantizes what it reads to qkv's
    dtype. A fresh-prefill step attends over the step's unquantized k and
    v, as the reference does, and writes only the int8 pages. Returns
    (out, qkv, key_cache, value_cache, k_scales, v_scales). The reference's
    refusals stay: static per-tensor scales, pre_key_cache and explicit
    masks raise.
    """
    if cache_k_quant_scales is not None and not use_dynamic_cachekv_quant:
        raise NotImplementedError("block_multihead_attention: static "
                                  "per-tensor cache scales are CUDA-"
                                  "specific; use dynamic cachekv quant")
    if use_dynamic_cachekv_quant and (cache_k_quant_scales is None
                                      or cache_v_quant_scales is None):
        raise ValueError("dynamic cachekv quant needs k/v scale pools")
    if pre_key_cache is not None:
        raise NotImplementedError("pre_caches not supported")
    if mask is not None or tgt_mask is not None:
        raise NotImplementedError("block_multihead_attention: explicit "
                                  "masks beyond the built-in causal/"
                                  "length masking are not supported")
    quant = bool(use_dynamic_cachekv_quant)
    ks = cache_k_quant_scales if quant else None
    vs = cache_v_quant_scales if quant else None
    T = qkv.shape[0]
    HKV, bs, D = key_cache.shape[2:]
    B = block_tables.shape[0]
    HQ = qkv.shape[1] // D - 2 * HKV

    md = metadata if metadata is not None else paged_metadata(
        T, seq_lens_encoder, seq_lens_decoder, cu_seqlens_q, block_tables,
        bs, rope_emb)
    caches = (key_cache, value_cache) + ((ks, vs) if quant else ())

    if fresh_prefill:
        # q, k, v heads first, as the varlen kernel reads them
        q, k, v = RA.rope_append(qkv, key_cache, value_cache, ks, vs,
                                 layer_idx, md, heads_first=True)
        seg = torch.where(md.t2b == B - 1, -1, md.t2b).to(torch.int32)[None]
        o, _ = varlen_flash_attention_packed(q[None], k[None], v[None], seg,
                                             seg, is_causal=True)
        out = o[0].transpose(0, 1).reshape(T, HQ * D)
        return (out, qkv) + caches

    q = RA.rope_append(qkv, key_cache, value_cache, ks, vs, layer_idx, md)
    out = PA.paged_attention(q, key_cache, value_cache, layer_idx, md.t2b,
                             md.pos, block_tables.long(), ks, vs)
    return (out.reshape(T, HQ * D), qkv) + caches


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """Attention of [B, S, H, D] Tensors through
    F.scaled_dot_product_attention (incubate/nn/functional/__init__.py:
    184-193): the flash kernels for a CUDA tensor of a kernel shape,
    dropout inside them. Returns (out, None) whenever ``return_softmax``
    is not None (False included), as the reference writes it, else out."""
    from ...nn import functional as F

    out = F.scaled_dot_product_attention(
        query, key, value, attn_mask=None, dropout_p=dropout,
        is_causal=causal, training=training)
    return (out, None) if return_softmax is not None else out


def _host_offsets(cu):
    """Cumulative sequence offsets on the host, as int64 numpy (the TPU
    package reads them with ``.numpy()``): from a list, a numpy array, an
    eager Tensor or a torch tensor on any device."""
    if isinstance(cu, Tensor):
        cu = cu._value
    if isinstance(cu, torch.Tensor):
        cu = cu.detach().cpu().numpy()
    return np.asarray(cu).astype(np.int64)


def _unpadded_kernel_route(d, cq, ck, scale, dropout, training):
    """Where the TPU package takes its segment-id kernel route
    (incubate/nn/functional/__init__.py:224-229, without its use_pallas()
    term): no live dropout, the default scale, D a multiple of 64 and one
    set of offsets for queries and keys."""
    return ((dropout == 0.0 or not training) and scale is None
            and d % 64 == 0 and np.array_equal(cq, ck))


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Varlen (packed) attention (incubate/nn/functional/__init__.py:
    196-285): query/key/value [total, H, D] with cumulative offsets
    ``cu_seqlens_q`` / ``cu_seqlens_k`` (a list, numpy array or tensor,
    read on the host). Returns (out [total, H, D], None). Differentiable.

    Kernel route (``_unpadded_kernel_route``): pad the token axis to a
    multiple of 128, give the padding segment id -1, run
    ``varlen_flash_attention`` on [1, H, Tp, D] and slice the padding off.
    Otherwise the per-segment dense route: each segment's attention in
    f32, causal bottom-right aligned when a segment has fewer queries than
    keys, ``scale`` (default 1/sqrt(D)) and dropout. The TPU package draws
    its dropout bits from jax.random, which cannot be reproduced: here
    they come from ``generator`` (the default generator of the tensors'
    device when None), so a seed repeats a draw within the port only.
    Eager Tensors in give a Tensor out, through the op funnel."""
    cq, ck = _host_offsets(cu_seqlens_q), _host_offsets(cu_seqlens_k)
    if isinstance(query, Tensor):
        out = apply(lambda q, k, v: _unpadded(
            q, k, v, cq, ck, scale, dropout, causal, training, generator),
            query, key, value, op_name="flash_attn_unpadded")
        return out, None
    return _unpadded(query, key, value, cq, ck, scale, dropout, causal,
                     training, generator), None


def _unpadded(query, key, value, cq, ck, scale, dropout, causal, training,
              generator):
    """flash_attn_unpadded's output on torch tensors."""
    d = int(query.shape[-1])
    if _unpadded_kernel_route(d, cq, ck, scale, dropout, training):
        total = int(query.shape[0])
        padded = 128 * ((total + 127) // 128)
        seg = torch.from_numpy(segment_ids_from_cu_seqlens(cq, padded)) \
            .to(query.device)[None]

        def packed(t):                        # [total, H, D] -> [1, H, Tp, D]
            return TF.pad(t, (0, 0, 0, 0, 0, padded - total)) \
                .transpose(0, 1)[None]

        o = varlen_flash_attention(packed(query), packed(key),
                                   packed(value), seg, seg,
                                   is_causal=causal)
        return o[0].transpose(0, 1)[:total]

    s = scale if scale is not None else 1.0 / d ** 0.5
    live_dropout = dropout > 0.0 and training
    outs = []
    for i in range(len(cq) - 1):
        qs = query[int(cq[i]):int(cq[i + 1])].float()
        ks = key[int(ck[i]):int(ck[i + 1])].float()
        vs = value[int(ck[i]):int(ck[i + 1])].float()
        logits = torch.einsum("qhd,khd->hqk", qs, ks) * s
        if causal:
            # bottom-right aligned (FA2 varlen): with q_len < k_len the
            # queries sit at the END of the keys
            off = ks.shape[0] - qs.shape[0]
            qi = torch.arange(qs.shape[0], device=query.device)[:, None] \
                + off
            ki = torch.arange(ks.shape[0], device=query.device)[None, :]
            logits = torch.where((qi >= ki)[None], logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        if live_dropout:
            keep = torch.rand(probs.shape, generator=generator,
                              device=probs.device) < 1.0 - dropout
            probs = probs * keep / (1.0 - dropout)
        outs.append(torch.einsum("hqk,khd->qhd", probs, vs))
    return torch.cat(outs, dim=0).to(query.dtype)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                generator=None, **kw):
    """Packed [total, 3, H, D] varlen attention
    (incubate/nn/functional/__init__.py:288-298): unpack and delegate to
    ``flash_attn_unpadded``."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale, dropout, causal,
                               return_softmax, training=training,
                               generator=generator)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type):
    """out = sum_e softmax(gate)_e * ffn_e(x): x [B, S, H], gate [B, S, E],
    bmm0_weight [E, H, I], bmm0_bias [E, 1, I], bmm1_weight [E, I, H],
    bmm1_bias [E, 1, H]; ``act_type`` "gelu" (the tanh form) or "relu"
    (reference incubate/nn/functional/fused_ec_moe.py)."""
    if act_type not in ("gelu", "relu"):
        raise ValueError(f"fused_ec_moe: act_type {act_type!r} is not "
                         f"gelu or relu")

    def fn(xa, ga, w0, b0, w1, b1):
        probs = torch.softmax(ga.float(), dim=-1).to(xa.dtype)
        h = torch.einsum("bsh,ehi->bsei", xa, w0) \
            + b0.reshape(1, 1, w0.shape[0], -1)
        h = TF.gelu(h, approximate="tanh") if act_type == "gelu" \
            else torch.relu(h)
        o = torch.einsum("bsei,eih->bseh", h, w1) \
            + b1.reshape(1, 1, w1.shape[0], -1)
        return torch.einsum("bseh,bse->bsh", o, probs)

    return apply(fn, x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
                 bmm1_bias, op_name="fused_ec_moe")
