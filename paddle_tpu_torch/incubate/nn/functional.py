"""Fused serving ops of the ported slice (paddle_tpu/incubate/nn/functional).

``block_multihead_attention`` is the paged-KV attention of the serving
step. Its fresh-prefill route runs the varlen flash-attention kernel; its
decode and chunked-prefill route is tensor code, as the reference's is.
The stacked caches are updated IN PLACE (the reference returns new
arrays): a serving step writes each layer's new K/V straight into the one
[L, num_blocks, HKV, block_size, D] buffer pair, with no copy of the pool.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops.kernels.varlen_attention import varlen_flash_attention_packed

__all__ = ["swiglu", "block_multihead_attention"]


def swiglu(x, y=None):
    """silu(x) * y; with y None, x splits in two along the last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


def _rope(t, cos_h, sin_h):
    """Rotate interleaved pairs of [T, heads, D] at f32 angles [T, 1, D/2]
    (use_neox_style=False in the reference); returns f32."""
    tf = t.float()
    t1, t2 = tf[..., 0::2], tf[..., 1::2]
    return torch.stack([t1 * cos_h - t2 * sin_h,
                        t2 * cos_h + t1 * sin_h], dim=-1).reshape(t.shape)


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, cu_seqlens_q,
                              block_tables, rope_emb, *, layer_idx,
                              fresh_prefill=False,
                              use_dynamic_cachekv_quant=False):
    """Paged-KV attention (incubate/nn/functional/__init__.py:544-772).

    qkv [T, (HQ + 2 HKV) D] packs each batch row's tokens of this step: row
    b contributes seq_lens_this_time[b] tokens starting at cache position
    seq_lens_decoder[b] (0 when seq_lens_encoder[b] > 0). Caches are the
    stacked page pools [L, num_blocks, HKV, block_size, D]; this call
    reads and writes layer ``layer_idx``. block_tables [B, max_blocks]
    maps each row's logical blocks to pages. HKV divides HQ (GQA).
    rope_emb [2, B, 1, max_seq, D/2] holds (cos, sin) for interleaved
    RoPE. New K/V are scattered into their pages in place, then each token
    attends its row's filled prefix (causal). Returns (out [T, HQ D], qkv,
    key_cache, value_cache).

    fresh_prefill=True asserts every scheduled row starts at position 0:
    attention then runs as block-diagonal varlen flash over the packed
    step, and the LAST batch row (B - 1) is the engine's trash row, whose
    tokens get segment id -1 and attend nothing.
    """
    if use_dynamic_cachekv_quant:
        raise NotImplementedError(
            "block_multihead_attention: the int8 dynamic cache-KV path is "
            "not ported yet")
    T = qkv.shape[0]
    pool_k = key_cache[layer_idx]                        # views
    pool_v = value_cache[layer_idx]
    num_blocks, HKV, bs, D = pool_k.shape
    bt = block_tables.long()
    B, max_blocks = bt.shape
    max_seq = max_blocks * bs
    HQ = qkv.shape[1] // D - 2 * HKV
    q = qkv[:, :HQ * D].reshape(T, HQ, D)
    k = qkv[:, HQ * D:(HQ + HKV) * D].reshape(T, HKV, D)
    v = qkv[:, (HQ + HKV) * D:].reshape(T, HKV, D)

    # token -> (batch row, position); out-of-range lookups clamp as the
    # reference's gathers do (the trash row's padding can run past max_seq)
    cu_q = cu_seqlens_q.long()
    tok = torch.arange(T, device=qkv.device)
    t2b = torch.searchsorted(cu_q[1:].contiguous(), tok, right=True) \
        .clamp(max=B - 1)
    tok_in_seq = tok - cu_q[t2b]
    start = torch.where(seq_lens_encoder.reshape(-1) > 0,
                        torch.zeros_like(seq_lens_decoder.reshape(-1)),
                        seq_lens_decoder.reshape(-1)).long()
    pos = start[t2b] + tok_in_seq
    re = rope_emb.reshape(2, B, -1, rope_emb.shape[-1])
    pos_r = pos.clamp(max=re.shape[2] - 1)
    cos_h = re[0][t2b, pos_r][:, None, :]
    sin_h = re[1][t2b, pos_r][:, None, :]
    # rope runs in f32; the cast back precedes the cache scatter
    q = _rope(q, cos_h, sin_h).to(qkv.dtype)
    k = _rope(k, cos_h, sin_h).to(qkv.dtype)

    page = bt[t2b, (pos // bs).clamp(max=max_blocks - 1)]
    slot = pos % bs
    # in place: [pages, HKV, bs, D] viewed as [pages, bs, HKV, D]
    pool_k.transpose(1, 2)[page, slot] = k.to(pool_k.dtype)
    pool_v.transpose(1, 2)[page, slot] = v.to(pool_v.dtype)

    if fresh_prefill:
        seg = torch.where(t2b == B - 1, -1, t2b).to(torch.int32)[None]
        o, _ = varlen_flash_attention_packed(
            q.transpose(0, 1)[None], k.transpose(0, 1)[None],
            v.transpose(0, 1)[None], seg, seg, is_causal=True)
        out = o[0].transpose(0, 1).reshape(T, HQ * D)
        return out, qkv, key_cache, value_cache

    # decode / chunked prefill: gather whole pages into each row's dense
    # view, then attend over ALL rows' views at once with every column of
    # another row masked to -inf. That equals the reference's per-token
    # gather kd[t2b] ([T, HKV, S, D], ~100 MB a layer at T=256) without
    # materialising it: a masked column adds exactly 0.
    kd = pool_k[bt].permute(2, 0, 1, 3, 4).reshape(HKV, B * max_seq, D)
    vd = pool_v[bt].permute(2, 0, 1, 3, 4).reshape(HKV, B * max_seq, D)
    G = HQ // HKV
    qg = q.reshape(T, HKV, G, D)
    logits = torch.einsum("tkgd,kcd->tkgc", qg.float(), kd.float()) \
        / math.sqrt(D)
    col = torch.arange(B * max_seq, device=qkv.device)
    valid = ((col // max_seq)[None, :] == t2b[:, None]) \
        & ((col % max_seq)[None, :] <= pos[:, None])          # [T, B*S]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("tkgc,kcd->tkgd", probs.to(qkv.dtype).float(),
                       vd.float()).to(qkv.dtype)
    return out.reshape(T, HQ * D), qkv, key_cache, value_cache
