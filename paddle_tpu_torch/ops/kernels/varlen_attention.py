"""Varlen (packed, segment-id) flash-attention forward: the CUDA kernel
(csrc/varlen_attention.cu) and its plain version.

Replaces paddle_tpu/ops/pallas/varlen_attention.py::_vfa_kernel (the
forward; its two backward kernels wait for the training slice).
Raggedness is carried by segment ids over one packed token axis; -1 marks
padding. Causality uses packed positions: within a segment packed order is
sequence order and cross-segment pairs are masked anyway, so row >= col
is per-sequence causal.

Rows with no valid key (padding) return a finite uniform average of V, as
in the reference (flash_attention.py:26-27). Which keys that average
covers follows the reference's routing: where the TPU package runs its
kernel (both lengths divisible by one of its blocks 512/256/128, D a
multiple of 64), the keys its causal loop visits; elsewhere, where it runs
its dense reference, every key. ``_key_bounds`` computes the block sizes
that reproduce both.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["varlen_flash_attention_packed", "segment_ids_from_cu_seqlens"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

# finite stand-in for -inf (ops/pallas/flash_attention.py:58): exp(x - m)
# underflows to exactly 0 while m stays finite when a leading block of a
# row is fully masked
_MASK_MIN = -1e30
_TILE = 64                    # the CUDA kernel's query and key tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_entry = None


def segment_ids_from_cu_seqlens(cu, total):
    """[total] int32 segment ids from cumulative offsets (host-side;
    positions >= cu[-1] get -1 = padding)."""
    cu = np.asarray(cu).astype(np.int64)
    seg = np.full((total,), -1, np.int32)
    for i in range(len(cu) - 1):
        seg[int(cu[i]):int(cu[i + 1])] = i
    return seg


def _tpu_block(s):
    """The TPU kernel's block for a packed length (varlen_attention.py:
    318-327): the largest of 512, 256, 128 dividing s, else 0."""
    for b in (512, 256, 128):
        if s % b == 0:
            return b
    return 0


def _key_bounds(tq, tk, d):
    """(bq, bk) such that a causal row r visits keys
    [0, min(tk, ceil((r // bq + 1) * bq / bk) * bk)). Where the TPU
    package runs its kernel these are its blocks; elsewhere one bound
    past both lengths, so every key is visited, as in its dense path."""
    bq, bk = _tpu_block(tq), _tpu_block(tk)
    if bq and bk and d % 64 == 0:
        return bq, bk
    whole = _TILE * max(1, math.ceil(max(tq, tk) / _TILE))
    return whole, whole


def _key_end(tq, tk, d, causal, device):
    """[tq] end of the visited key range of each query row."""
    if not causal:
        return torch.full((tq,), tk, dtype=torch.int64, device=device)
    bq, bk = _key_bounds(tq, tk, d)
    r = torch.arange(tq, device=device)
    end = ((r // bq + 1) * bq + bk - 1) // bk * bk
    return end.clamp(max=tk)


def _varlen_ref(q, k, v, seg_q, seg_k, causal):
    """Plain PyTorch version: dense segment-masked attention in f32.
    q [B, H, Tq, D]; k/v [B, HKV, Tk, D] with HKV dividing H (query head
    h reads KV head h // (H // HKV)). Returns (O in q's dtype,
    LSE [B, H, Tq] f32)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=1) if g > 1 else v.float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    sq = seg_q.long()[:, None, :, None]
    sk = seg_k.long()[:, None, None, :]
    valid = (sq == sk) & (sq >= 0)
    if causal:
        pos_q = torch.arange(tq, device=q.device)
        pos_k = torch.arange(tk, device=q.device)
        valid = valid & (pos_q[:, None] >= pos_k[None, :])
    logits = torch.where(valid, logits, torch.full_like(logits, _MASK_MIN))
    visited = (torch.arange(tk, device=q.device)[None, :]
               < _key_end(tq, tk, d, causal, q.device)[:, None])
    logits = logits.masked_fill(~visited, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
    return o, lse


def _launch(q, k, v, seg_q, seg_k, causal):
    global _entry, launches
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("varlen attention kernel takes q, k, v of one "
                        "dtype, float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("varlen attention kernel: q [B, H, Tq, D], k and "
                         "v [B, HKV, Tk, D]")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"varlen attention kernel: k {tuple(k.shape)} "
                         f"does not fit q {tuple(q.shape)} (HKV must "
                         f"divide H)")
    if d not in (64, 128):
        raise ValueError(f"varlen attention kernel: head_dim {d} not in "
                         f"(64, 128)")
    if tuple(seg_q.shape) != (b, tq) or tuple(seg_k.shape) != (b, tk) \
            or seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError("varlen attention kernel: segment ids must be "
                         "int32 [B, Tq] and [B, Tk]")
    for t in (k, v, seg_q, seg_k):
        if t.device != q.device:
            raise ValueError("varlen attention kernel: all inputs on one "
                             "device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg_q, seg_k = seg_q.contiguous(), seg_k.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0 or tq == 0:
        return o, lse
    if tk == 0:
        raise ValueError("varlen attention kernel: no keys")
    bq, bk = _key_bounds(tq, tk, d)
    if _entry is None:
        _entry = _build.entry("pt_varlen_attention_fwd", [
            ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, hkv, tq, tk, d, int(bool(causal)),
                 bq, bk, 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "varlen_attention_fwd")
    launches += 1
    return o, lse


def varlen_flash_attention_packed(q, k, v, seg_q, seg_k, is_causal=False):
    """Packed-sequence attention forward. q [B, H, Tq, D]; k/v
    [B, HKV, Tk, D] (HKV divides H: GQA reads KV head h // (H // HKV));
    seg_q [B, Tq] / seg_k [B, Tk] int32 segment ids (-1 = padding).
    Returns (O [B, H, Tq, D] in q's dtype, LSE [B, H, Tq] f32). A CPU
    tensor takes the plain version, a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return _varlen_ref(q, k, v, seg_q, seg_k, bool(is_causal))
    if q.device.type == "cuda":
        return _launch(q, k, v, seg_q, seg_k, bool(is_causal))
    raise ValueError(f"varlen attention: no path for device {q.device}")
