"""Varlen (packed, segment-id) flash attention: the CUDA kernels
(csrc/varlen_attention.cu, csrc/varlen_attention_bwd.cu), their plain
versions, the gradient and the packed entry points.

Replaces paddle_tpu/ops/pallas/varlen_attention.py: ``_vfa_kernel`` (the
forward), ``_vfa_bwd_dkv_kernel`` and ``_vfa_bwd_dq_kernel`` (the
backward), with the same custom gradient (``_VarlenAttention``, the
counterpart of the ``_varlen_attention`` custom VJP). Raggedness is carried
by segment ids over one packed token axis; -1 marks padding. Causality uses
packed positions: within a segment packed order is sequence order and
cross-segment pairs are masked anyway, so row >= col is per-sequence
causal.

Two entry points:

- ``varlen_flash_attention_packed`` -> (O, LSE), forward only, GQA allowed:
  the serving path's, called under ``inference_mode``.
- ``varlen_flash_attention`` -> O, differentiable, H == HKV: the
  counterpart of the TPU package's ``varlen_flash_attention_packed``, with
  its routing minus ``use_pallas()``. Where both packed lengths are
  divisible by one of the TPU blocks 512/256/128 and D is a multiple of
  64 it runs the kernels (their plain versions on the CPU) under
  ``_VarlenAttention``; elsewhere the dense ``_varlen_ref`` (every key
  visited) under plain autograd, as the TPU package's XLA fallback.

Rows with no valid key (padding) return a finite uniform average of V, as
in the reference (flash_attention.py:26-27). Which keys that average
covers follows the reference's routing: on the kernel route, the keys its
causal loop visits; on the dense route, every key. ``_key_bounds``
computes the block sizes that reproduce both. The kernel route's backward
takes P = 0 exactly on every invalid pair, so such rows, and padding keys,
get no gradient; on the dense route the uniform average is differentiated
and sends dO / Tk to every key's dV, as ``jax.grad`` of the reference's
dense path does.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["varlen_flash_attention_packed", "varlen_flash_attention",
           "segment_ids_from_cu_seqlens"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts):
# the forward, then the two backward kernels
launches = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0

# finite stand-in for -inf (ops/pallas/flash_attention.py:58): exp(x - m)
# underflows to exactly 0 while m stays finite when a leading block of a
# row is fully masked
_MASK_MIN = -1e30
_TILE = 64                    # the CUDA kernels' key tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_entries = {}


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


def _kernel_route(tq, tk, d):
    """Where the TPU package runs its kernels (varlen_attention.py:366-
    372, without its use_pallas() term): both packed lengths divisible by
    one of its blocks, D a multiple of 64."""
    return bool(_tpu_block(tq) and _tpu_block(tk) and d % 64 == 0)


def _key_bounds(tq, tk, d):
    """(bq, bk) such that a causal row r visits keys
    [0, min(tk, ceil((r // bq + 1) * bq / bk) * bk)). Where the TPU
    package runs its kernel these are its blocks; elsewhere one bound
    past both lengths, so every key is visited, as in its dense path."""
    if _kernel_route(tq, tk, d):
        return _tpu_block(tq), _tpu_block(tk)
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


def _varlen_bwd_ref(q, k, v, seg_q, seg_k, o, lse, do, causal):
    """Plain version of the two backward kernels (varlen_attention.py:
    147-304): delta = rowsum(dO * O) in f32 from the rounded O; P =
    where(valid, exp(S * scale - lse), 0); dV = P^T dO with P rounded to
    dO's dtype; dS = P * (dP - delta) * scale; dK = dS^T Q and dQ = dS K
    with dS rounded to Q's (K's) dtype; all sums in f32. One [Tq, Tk] head
    at a time. q, o, do [B, H, Tq, D]; k, v [B, H, Tk, D] (H == HKV);
    lse [B, H, Tq] f32. Returns (dQ, dK, dV) in the inputs' dtypes."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape != v.shape:
        raise ValueError(f"varlen attention backward: q [B, H, Tq, D], k "
                         f"and v [B, H, Tk, D] with H == HKV; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = 1.0 / math.sqrt(d)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    pos_q = torch.arange(tq, device=q.device)
    pos_k = torch.arange(tk, device=q.device)
    for bi in range(b):
        sq, sk = seg_q[bi].long(), seg_k[bi].long()
        valid = (sq[:, None] == sk[None, :]) & (sk[None, :] >= 0)
        if causal:
            valid = valid & (pos_q[:, None] >= pos_k[None, :])
        for hi in range(h):
            qf, kf, vf = q[bi, hi].float(), k[bi, hi].float(), \
                v[bi, hi].float()
            dof = do[bi, hi].float()
            s = (qf @ kf.T) * scale
            p = torch.where(valid, torch.exp(s - lse[bi, hi, :, None]),
                            torch.zeros_like(s))
            dv[bi, hi] = (p.to(do.dtype).float().T @ dof).to(v.dtype)
            ds = p * (dof @ vf.T - delta[bi, hi, :, None]) * scale
            dk[bi, hi] = (ds.to(q.dtype).float().T @ qf).to(k.dtype)
            dq[bi, hi] = (ds.to(k.dtype).float() @ kf).to(q.dtype)
    return dq, dk, dv


def _check(q, k, v, seg_q, seg_k, what, same_heads=False, extra=()):
    """Raise on what the kernels do not take: q, k, v (and ``extra``) of one
    dtype, f32 or bf16, on q's device and contiguous; q [B, H, Tq, D], k
    and v [B, HKV, Tk, D] with HKV dividing H (equal to it where
    ``same_heads``); D 64 or 128; int32 segment ids [B, Tq] and [B, Tk]."""
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v) + tuple(extra)):
        raise TypeError(f"{what}: q, k, v (and dO, O) of one dtype, "
                        f"float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q [B, H, Tq, D], k and v "
                         f"[B, HKV, Tk, D]")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv \
            or (same_heads and hkv != h):
        raise ValueError(f"{what}: k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (HKV must "
                         f"{'equal' if same_heads else 'divide'} H)")
    if d not in (64, 128):
        raise ValueError(f"{what}: head_dim {d} not in (64, 128)")
    if tuple(seg_q.shape) != (b, tq) or tuple(seg_k.shape) != (b, tk) \
            or seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError(f"{what}: segment ids must be int32 [B, Tq] and "
                         f"[B, Tk]")
    for t in (q, k, v, seg_q, seg_k) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _launch(q, k, v, seg_q, seg_k, causal):
    global launches
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg_q, seg_k = seg_q.contiguous(), seg_k.contiguous()
    _check(q, k, v, seg_q, seg_k, "varlen attention kernel")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0 or tq == 0:
        return o, lse
    if tk == 0:
        raise ValueError("varlen attention kernel: no keys")
    if q.dtype == torch.bfloat16:
        q, k, v = (_build.aligned16(t) for t in (q, k, v))
    bq, bk = _key_bounds(tq, tk, d)
    if "fwd" not in _entries:
        _entries["fwd"] = _build.entry("pt_varlen_attention_fwd", [
            ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entries["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(),
                          lse.data_ptr(), b, h, hkv, tq, tk, d,
                          int(bool(causal)), bq, bk, 1.0 / math.sqrt(d),
                          _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "varlen_attention_fwd")
    launches += 1
    return o, lse


def _bwd_entry(name):
    if name not in _entries:
        _entries[name] = _build.entry(
            f"pt_varlen_attention_bwd_{name}",
            [ctypes.c_void_p] * (10 if name == "dkv" else 9)
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return _entries[name]


def _bwd_check(q, k, v, seg_q, seg_k, do, lse, delta, what):
    _check(q, k, v, seg_q, seg_k, what, same_heads=True, extra=(do,))
    b, h, tq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"{what}: dO must have q's shape")
    for t in (lse, delta):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: lse and delta must be contiguous "
                             f"float32 [B, H, Tq] on q's device")


def _bwd_args(q, k, v, seg_q, seg_k, do, lse, delta, causal):
    b, h, tq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            seg_q.data_ptr(), seg_k.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    rest = (b, h, tq, k.shape[2], d, int(bool(causal)), 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], stream)
    return ptrs, rest


def _launch_bwd_dkv(q, k, v, seg_q, seg_k, do, lse, delta, causal):
    """dK, dV from the dK/dV kernel. Every input contiguous, on one
    device: q, do [B, H, Tq, D], k, v [B, H, Tk, D] (D 64 or 128, f32 or
    bf16; bf16 ones 16-byte aligned, as ``_launch_bwd`` makes them), int32
    segment ids [B, Tq] / [B, Tk], lse and delta = rowsum(dO * O) float32
    [B, H, Tq]; B, H, Tq, Tk > 0."""
    global launches_bwd_dkv
    _bwd_check(q, k, v, seg_q, seg_k, do, lse, delta,
               "varlen attention dK/dV kernel")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, rest = _bwd_args(q, k, v, seg_q, seg_k, do, lse, delta, causal)
    err = _bwd_entry("dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check(err, "varlen_attention_bwd_dkv")
    launches_bwd_dkv += 1
    return dk, dv


def _launch_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta, causal):
    """dQ from the dQ kernel; inputs as ``_launch_bwd_dkv``."""
    global launches_bwd_dq
    _bwd_check(q, k, v, seg_q, seg_k, do, lse, delta,
               "varlen attention dQ kernel")
    dq = torch.empty_like(q)
    ptrs, rest = _bwd_args(q, k, v, seg_q, seg_k, do, lse, delta, causal)
    err = _bwd_entry("dq")(*ptrs, dq.data_ptr(), *rest)
    _build.check(err, "varlen_attention_bwd_dq")
    launches_bwd_dq += 1
    return dq


def _launch_bwd(q, k, v, seg_q, seg_k, o, lse, do, causal):
    """delta = rowsum(dO * O) in f32 (a tensor op, as _vfa_backward
    computes it, varlen_attention.py:252-253), then the dK/dV kernel and
    the dQ kernel. Returns (dQ, dK, dV)."""
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    if q.dtype == torch.bfloat16:       # the kernels' 16-byte cp.async
        q, k, v, do = (_build.aligned16(t) for t in (q, k, v, do))
    seg_q, seg_k, lse = seg_q.contiguous(), seg_k.contiguous(), \
        lse.contiguous()
    if o.shape != q.shape:
        raise ValueError("varlen attention backward: O must have q's shape")
    delta = (do.float() * o.float()).sum(-1)
    if 0 in q.shape[:3] or k.shape[2] == 0:      # no block to launch
        return torch.zeros_like(q), torch.zeros_like(k), \
            torch.zeros_like(v)
    dk, dv = _launch_bwd_dkv(q, k, v, seg_q, seg_k, do, lse, delta, causal)
    dq = _launch_bwd_dq(q, k, v, seg_q, seg_k, do, lse, delta, causal)
    return dq, dk, dv


def _on_kernels(q):
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); other devices raise."""
    if q.device.type in ("cuda", "cpu"):
        return q.device.type == "cuda"
    raise ValueError(f"varlen attention: no path for device {q.device}")


def varlen_flash_attention_packed(q, k, v, seg_q, seg_k, is_causal=False):
    """Packed-sequence attention forward. q [B, H, Tq, D]; k/v
    [B, HKV, Tk, D] (HKV divides H: GQA reads KV head h // (H // HKV));
    seg_q [B, Tq] / seg_k [B, Tk] int32 segment ids (-1 = padding).
    Returns (O [B, H, Tq, D] in q's dtype, LSE [B, H, Tq] f32). A CPU
    tensor takes the plain version, a CUDA tensor the kernel. Not
    differentiable: ``varlen_flash_attention`` is."""
    if _on_kernels(q):
        return _launch(q, k, v, seg_q, seg_k, bool(is_causal))
    return _varlen_ref(q, k, v, seg_q, seg_k, bool(is_causal))


def varlen_backward(q, k, v, seg_q, seg_k, o, lse, do, causal=False):
    """(dQ, dK, dV) of packed attention from the forward's O and LSE: the
    two backward kernels on a CUDA tensor, their plain version on a CPU
    one."""
    if _on_kernels(q):
        return _launch_bwd(q, k, v, seg_q, seg_k, o, lse, do, bool(causal))
    return _varlen_bwd_ref(q, k, v, seg_q, seg_k, o, lse, do, bool(causal))


class _VarlenAttention(torch.autograd.Function):
    """The ``_varlen_attention`` custom VJP (varlen_attention.py:311-346):
    the forward saves q, k, v, the segment ids, O and LSE; the backward
    runs the dK/dV and dQ kernels and gives the segment ids no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal):
        if _on_kernels(q):
            # the copies the kernels read are the ones the backward keeps
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = varlen_flash_attention_packed(q, k, v, seg_q, seg_k,
                                               causal)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        dq, dk, dv = varlen_backward(q, k, v, seg_q, seg_k, o, lse, do,
                                     ctx.causal)
        return dq, dk, dv, None, None, None


def varlen_flash_attention(q, k, v, seg_q, seg_k, is_causal=False):
    """Differentiable packed-sequence attention (the TPU package's
    varlen_flash_attention_packed, varlen_attention.py:375-382). q
    [B, H, Tq, D]; k/v [B, H, Tk, D] (no GQA, as there); seg_q [B, Tq] /
    seg_k [B, Tk] int32 segment ids (-1 = padding). Returns O
    [B, H, Tq, D] in q's dtype. The kernel route (``_kernel_route``) runs
    ``_VarlenAttention``: the kernels on a CUDA tensor (D 64 or 128, else
    it raises), their plain versions on a CPU one; other shapes take the
    dense ``_varlen_ref`` under plain autograd on either device."""
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(f"varlen_flash_attention: q [B, H, Tq, D], k and "
                         f"v [B, H, Tk, D] (no GQA); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    causal = bool(is_causal)
    if _kernel_route(q.shape[2], k.shape[2], q.shape[3]):
        return _VarlenAttention.apply(q, k, v, seg_q, seg_k, causal)
    return _varlen_ref(q, k, v, seg_q, seg_k, causal)[0]
