"""Flash attention: the CUDA kernels (csrc/flash_attention_fwd.cu,
csrc/flash_attention_bwd.cu), their plain versions, the gradient and the
public entry points.

Replaces paddle_tpu/ops/pallas/flash_attention.py: ``_fa_kernel`` (forward,
O and LSE), ``_fa_bwd_dkv_kernel`` and ``_fa_bwd_dq_kernel`` (backward),
with the same custom gradient (``_FlashAttention``, the counterpart of the
``_flash_attention`` custom VJP) and the same routing:

- a tensor of a shape the TPU kernels take (``_kernel_ok``: both lengths
  divisible by their min(512, S) block and by 128, head_dim a multiple of
  64, Sq == Sk when causal) runs the kernels on a card and the plain
  versions on the CPU;
- other shapes take the reference's own dense fallback (causal bottom-right
  aligned when Sq != Sk), on either device;
- a generic [B, H, Sq, Sk] mask, and dropout at a shape the kernels do not
  take, take the dense ``_attention_ref``.

Dropout inside the kernels and their plain versions is the keep bit of a
hash of the global (q, k) position (``_hash_keep``), bit for bit the TPU
package's, so forward and backward regenerate the same mask. The hash's
(batch, head) index ``bh`` takes an offset (``bh_offset``, 0 by default):
a rank holding rows r0.. of a batch passes r0 * H, so that its mask is
the one-process mask's rows. The kernels get it folded into the seed
(``kernel_seed``): the hash adds seed + C * bh (mod 2**32), and
C * (bh + off) = C * bh + C * off, so seed + C * off with the kernel's own
bh is the same bit. Key-padding
masks ([B|1, 1, 1, Sk]) stream through the kernels as an additive [B, Sk]
f32 bias clamped to -1e30; a row whose keys are all padded averages V
uniformly (flash_attention.py:26-27).

Public entry points take [B, S, H, D] (``flash_attention_bshd``) or
[B, H, S, D] (``flash_attention_bhsd``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_bhsd", "flash_attention_bshd",
           "forward_with_lse"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts),
# one counter a kernel
launches_fwd = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0
# the multiply-adds x 2 of those launches (never reset): FlopCounterMode
# cannot see a launch through ctypes, so the auto-parallel Engine's
# cost_analysis adds them
launched_flops = 0

DEFAULT_BLOCK_Q = 512          # the TPU kernels' blocks, for the routing
DEFAULT_BLOCK_K = 512
_MASK_MIN = -1e30              # flash_attention.py:58
_M32 = 0xFFFFFFFF
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)         # the CUDA kernels' head dims
_entries = {}


# ---------------------------------------------------------------------------
# dropout keep mask (flash_attention.py:75-101, 296-304), in int64 masked to
# 32 bits: the same bits as the TPU package's uint32 arithmetic
# ---------------------------------------------------------------------------

def _dropout_threshold(dropout_p):
    """keep iff hash >= threshold, P(keep) = 1 - p."""
    return min(int(round(dropout_p * 4294967296.0)), 4294967295)


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_keep(seed, bh, q_idx, k_idx, thresh):
    """Elementwise keep mask of global positions: ``seed`` an int (or int64
    tensor), ``bh``/``q_idx``/``k_idx`` int64 tensors that broadcast.
    Returns bool of the broadcast shape."""
    h = (_mul32(q_idx & _M32, 0x9E3779B1)
         + _mul32(k_idx & _M32, 0x85EBCA77)) & _M32
    h = (h + (seed & _M32) + _mul32(bh & _M32, 0xC2B2AE3D)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h >= thresh


def _full_keep_mask(seed, b, h, sq, sk, dropout_p, device, q_offset=0,
                    k_offset=0, bh_offset=0):
    """[b, h, sq, sk] keep mask, identical to the kernels' tiles."""
    thresh = _dropout_threshold(dropout_p)
    bh = (bh_offset + torch.arange(b * h, dtype=torch.int64,
                                   device=device)).reshape(b, h, 1, 1)
    qi = (q_offset + torch.arange(sq, dtype=torch.int64, device=device)) \
        .reshape(1, 1, sq, 1)
    ki = (k_offset + torch.arange(sk, dtype=torch.int64, device=device)) \
        .reshape(1, 1, 1, sk)
    return _hash_keep(int(seed), bh, qi, ki, thresh)


def seed_from_generator(generator=None) -> int:
    """An int32 dropout seed drawn from ``generator`` (the default CPU
    generator when None): the counterpart of the TPU package's
    ``_key_to_seed``, which folds a jax key."""
    u = int(torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                          generator=generator,
                          device=generator.device if generator is not None
                          else "cpu"))
    return u - 2 ** 32 if u >= 2 ** 31 else u


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _attention_ref(q, k, v, mask, is_causal, dropout_p, generator=None):
    """Dense attention for generic masks (flash_attention.py:108-128).
    q/k/v [B, H, S, D]; mask bool (True = attend) or additive, broadcast
    to [B, H, Sq, Sk]. Dropout draws from ``generator``: the TPU package's
    jax.random bits cannot be reproduced."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[2], k.shape[2]
    if is_causal:
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _logits(q, k, kmask, causal):
    """f32 logits with the key-padding bias, then the causal mask as -inf,
    bottom-right aligned when Sq != Sk (tril(k=sk-sq))."""
    sq, sk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kmask is not None:
        s = s + kmask[:, None, None, :].float()
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
            .tril(sk - sq)
        s = s.masked_fill(~cm, float("-inf"))
    return s


def _forward_ref(q, k, v, kmask, seed, causal, dropout_p, bh_offset=0):
    """Plain version of the forward kernel: dense O and LSE in f32 (the XLA
    route of ``_forward_with_lse``, flash_attention.py:276-293), with the
    kernel's normalisation by the row sum of exp(s - max): a row whose keys
    are all padded (logits all -1e30, so LSE rounds to -1e30) averages V,
    as the kernel does. Returns (O in q's dtype, LSE [B, H, Sq] f32)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = _logits(q, k, kmask, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(den))[..., 0]
    return _dropout_pv(e / den, v, seed, b, h, sq, sk, dropout_p,
                       q.dtype, bh_offset), lse


def _forward_fallback(q, k, v, kmask, seed, causal, dropout_p,
                      bh_offset=0):
    """The reference's dense route for shapes its kernel does not take
    (flash_attention.py:276-293) as written: probs = exp(s - LSE), so a
    fully padded row sums V where the kernel averages it."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = _logits(q, k, kmask, causal)
    lse = torch.logsumexp(s, dim=-1)
    return _dropout_pv(torch.exp(s - lse[..., None]), v, seed, b, h, sq,
                       sk, dropout_p, q.dtype, bh_offset), lse


def _dropout_pv(probs, v, seed, b, h, sq, sk, dropout_p, dtype,
                bh_offset=0):
    if dropout_p > 0.0:
        keep = _full_keep_mask(seed, b, h, sq, sk, dropout_p, v.device,
                               bh_offset=bh_offset)
        probs = torch.where(keep, probs, torch.zeros_like(probs)) \
            * (1.0 / (1.0 - dropout_p))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(dtype)


def _backward_ref(q, k, v, kmask, seed, o, lse, do, causal, dropout_p,
                  bh_offset=0):
    """Plain version of the backward: the scan of flash_attention.py:
    570-623 over one block of all keys, as dense f32 tensor code. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    p = torch.exp(_logits(q, k, kmask, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    if dropout_p > 0.0:
        inv = 1.0 / (1.0 - dropout_p)
        keep = _full_keep_mask(seed, b, h, sq, sk, dropout_p, q.device,
                               bh_offset=bh_offset)
        zero = torch.zeros_like(p)
        p_used = torch.where(keep, p, zero) * inv
        dp_eff = torch.where(keep, dp, zero) * inv
    else:
        p_used, dp_eff = p, dp
    dv = torch.einsum("bhqk,bhqd->bhkd", p_used, dof)
    ds = p * (dp_eff - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel_ok(q, k, causal):
    """Shapes the TPU kernels take (flash_attention.py:251-263, without
    its use_pallas() term)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[-1]
    return (sq % min(DEFAULT_BLOCK_Q, sq) == 0
            and sk % min(DEFAULT_BLOCK_K, sk) == 0
            and sq % 128 == 0 and sk % 128 == 0 and d % 64 == 0
            and (not causal or sq == sk))


def _entry(name):
    if name not in _entries:
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
            ctypes.c_float
        if name == "pt_flash_attention_fwd":
            args = [p] * 6 + [i] * 6 + [f, i, u, u, f, i, p]
        elif name == "pt_flash_attention_bwd_dkv":
            args = [p] * 9 + [i] * 6 + [f, i, u, u, f, i, p]
        else:
            args = [p] * 8 + [i] * 6 + [f, i, u, u, f, i, p]
        _entries[name] = _build.entry(name, args)
    return _entries[name]


def _check(q, k, v, kmask, causal, extra=()):
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v) + tuple(extra)):
        raise TypeError("flash attention kernels take q, k, v (and dO) of "
                        "one dtype, float32 or bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash attention kernels: q [B, H, Sq, D], k and "
                         f"v [B, H, Sk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels: head_dim "
                         f"{q.shape[-1]} not in {_HEAD_DIMS}")
    if not _kernel_ok(q, k, causal):
        raise ValueError(f"flash attention kernels: shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} "
                         f"causal={causal} is not a kernel shape")
    if kmask is not None and (kmask.dtype != torch.float32
                              or tuple(kmask.shape) != (q.shape[0],
                                                        k.shape[2])):
        raise ValueError("flash attention kernels: the key-padding bias "
                         "must be float32 [B, Sk]")
    for t in (k, v) + tuple(extra) + ((kmask,) if kmask is not None
                                      else ()):
        if t.device != q.device:
            raise ValueError("flash attention kernels: all inputs on one "
                             "device")


def _dropout_args(seed, dropout_p):
    if dropout_p > 0.0:
        return (1, int(seed) & _M32, _dropout_threshold(dropout_p),
                1.0 / (1.0 - dropout_p))
    return 0, 0, 0, 1.0


def kernel_seed(seed, bh_offset):
    """The seed the kernels take for ``seed`` with the hash's (batch,
    head) index offset by ``bh_offset``: the hash adds seed + C * bh
    (mod 2**32), linear in bh, so seed + C * bh_offset with the kernel's
    own bh gives the same bits (an int32, as the seeds drawn here)."""
    u = (int(seed) + _mul32(int(bh_offset) & _M32, 0xC2B2AE3D)) & _M32
    return u - 2 ** 32 if u >= 2 ** 31 else u


def _launch_fwd(q, k, v, kmask, seed, causal, dropout_p):
    global launches_fwd
    _check(q, k, v, kmask, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kmask = kmask.contiguous() if kmask is not None else None
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return o, lse
    if q.dtype == torch.bfloat16:
        q, k, v, kmask = (_build.aligned16(t) for t in (q, k, v, kmask))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("pt_flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kmask.data_ptr() if kmask is not None else None, o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, int(bool(causal)),
        1.0 / math.sqrt(d), *_dropout_args(seed, dropout_p),
        _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "flash_attention_fwd")
    launches_fwd += 1
    _add_flops(2, q, k, causal)
    return o, lse


def _add_flops(products, q, k, causal):
    """``products`` [Sq, Sk] x D matrix products of one launch, halved
    when causal."""
    global launched_flops
    b, h, sq, d = q.shape
    n = 2 * products * b * h * sq * k.shape[2] * d
    launched_flops += n // 2 if causal else n


def _bwd_args(q, k, v, kmask, seed, causal, dropout_p, do, lse, delta):
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            kmask.data_ptr() if kmask is not None else None,
            lse.data_ptr(), delta.data_ptr())
    rest = (b, h, sq, k.shape[2], d, int(bool(causal)), 1.0 / math.sqrt(d)) \
        + _dropout_args(seed, dropout_p) + (_DTYPE_CODE[q.dtype], stream)
    return ptrs, rest


def _launch_bwd_dkv(q, k, v, kmask, seed, do, lse, delta, causal,
                    dropout_p):
    """The dK/dV kernel on contiguous, checked inputs (``_launch_bwd``)."""
    global launches_bwd_dkv
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, rest = _bwd_args(q, k, v, kmask, seed, causal, dropout_p, do,
                           lse, delta)
    err = _entry("pt_flash_attention_bwd_dkv")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check(err, "flash_attention_bwd_dkv")
    launches_bwd_dkv += 1
    _add_flops(4, q, k, causal)       # S, dP, dV, dK
    return dk, dv


def _launch_bwd_dq(q, k, v, kmask, seed, do, lse, delta, causal,
                   dropout_p):
    """The dQ kernel on contiguous, checked inputs (``_launch_bwd``)."""
    global launches_bwd_dq
    dq = torch.empty_like(q)
    ptrs, rest = _bwd_args(q, k, v, kmask, seed, causal, dropout_p, do,
                           lse, delta)
    err = _entry("pt_flash_attention_bwd_dq")(*ptrs, dq.data_ptr(), *rest)
    _build.check(err, "flash_attention_bwd_dq")
    launches_bwd_dq += 1
    _add_flops(3, q, k, causal)       # S, dP, dQ
    return dq


def _bwd_inputs(q, k, v, kmask, o, lse, do, causal):
    """Checked, contiguous backward inputs (bf16 ones on a 16-byte
    boundary, ``_build.aligned16``) and delta = rowsum(dO * O) in f32, a
    tensor op as _pallas_backward computes it (flash_attention.py:466-467)."""
    _check(q, k, v, kmask, causal, extra=(do, o))
    b, h, sq, _ = q.shape
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError("flash attention backward: lse must be float32 "
                         "[B, H, Sq]")
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), \
        do.contiguous()
    kmask = kmask.contiguous() if kmask is not None else None
    lse = lse.contiguous()
    if q.dtype == torch.bfloat16:
        q, k, v, do, kmask, lse = (_build.aligned16(t)
                                   for t in (q, k, v, do, kmask, lse))
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, kmask, lse, do, delta


def _launch_bwd(q, k, v, kmask, seed, o, lse, do, causal, dropout_p):
    """The dK/dV kernel, then the dQ kernel."""
    q, k, v, kmask, lse, do, delta = _bwd_inputs(q, k, v, kmask, o, lse,
                                                 do, causal)
    if q.shape[0] == 0 or q.shape[1] == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dk, dv = _launch_bwd_dkv(q, k, v, kmask, seed, do, lse, delta, causal,
                             dropout_p)
    dq = _launch_bwd_dq(q, k, v, kmask, seed, do, lse, delta, causal,
                        dropout_p)
    return dq, dk, dv


def _on_kernels(q, k, causal):
    """True where the kernels run: a CUDA tensor of a kernel shape."""
    if q.device.type == "cuda":
        return _kernel_ok(q, k, causal)
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash attention: no path for device {q.device}")


def forward_with_lse(q, k, v, kmask=None, seed=0, causal=False,
                     dropout_p=0.0, bh_offset=0):
    """(O, LSE [B, H, Sq] f32) of [B, H, S, D] inputs
    (flash_attention.py:266-293): at a kernel shape, the kernel on a CUDA
    tensor and its plain version on the CPU; at other shapes the
    reference's dense fallback."""
    if _on_kernels(q, k, causal):
        return _launch_fwd(q, k, v, kmask, kernel_seed(seed, bh_offset),
                           causal, dropout_p)
    if _kernel_ok(q, k, causal):
        return _forward_ref(q, k, v, kmask, seed, causal, dropout_p,
                            bh_offset)
    return _forward_fallback(q, k, v, kmask, seed, causal, dropout_p,
                             bh_offset)


def backward(q, k, v, kmask, seed, o, lse, do, causal=False,
             dropout_p=0.0, bh_offset=0):
    """(dQ, dK, dV): the two backward kernels on a CUDA tensor of a kernel
    shape, else the plain version (flash_attention.py:558-623)."""
    if _on_kernels(q, k, causal):
        return _launch_bwd(q, k, v, kmask, kernel_seed(seed, bh_offset), o,
                           lse, do, causal, dropout_p)
    return _backward_ref(q, k, v, kmask, seed, o, lse, do, causal,
                         dropout_p, bh_offset)


class _FlashAttention(torch.autograd.Function):
    """The ``_flash_attention`` custom VJP (flash_attention.py:547-626):
    the forward saves q, k, v, O, LSE, the key-padding bias and the seed;
    the backward returns no gradient for the bias, the seed and the bh
    offset."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, seed, causal, dropout_p, bh_offset=0):
        if _on_kernels(q, k, causal):
            # the copies the kernels read are the ones the backward keeps
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = forward_with_lse(q, k, v, kmask, seed, causal, dropout_p,
                                  bh_offset)
        ctx.save_for_backward(q, k, v, o, lse, kmask)
        ctx.seed, ctx.causal, ctx.dropout_p = seed, causal, dropout_p
        ctx.bh_offset = bh_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kmask = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, kmask, ctx.seed, o, lse, do,
                              ctx.causal, ctx.dropout_p, ctx.bh_offset)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# public entry points (flash_attention.py:633-692)
# ---------------------------------------------------------------------------

def _as_key_padding_mask(mask, b, sk):
    """Masks of the [B|1, 1, 1, Sk] form as an additive [B, Sk] f32 bias
    clamped to -1e30; None where the mask needs the generic fallback (2-D
    masks included: a [Sq, Sk] mask is per query)."""
    m = mask
    if not (m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1
            and m.shape[3] == sk and m.shape[0] in (1, b)):
        return None
    m = m.reshape(m.shape[0], sk).expand(b, sk)
    if m.dtype == torch.bool:
        return torch.where(m, 0.0, _MASK_MIN).float().contiguous()
    return torch.clamp(m.float(), min=_MASK_MIN).contiguous()


def flash_attention_bhsd(q, k, v, mask=None, is_causal=False,
                         dropout_p=0.0, generator=None, bh_offset=0):
    """[B, H, S, D] layout. ``dropout_p > 0`` draws its int32 seed from
    ``generator`` (the default generator when None); ``bh_offset`` is
    added to the dropout hash's (batch, head) index. DTensor inputs run
    on their local shards (``_dtensor_attention``)."""
    if _is_dtensor(q, k, v, mask):
        return _dtensor_attention(q, k, v, mask, is_causal, dropout_p,
                                  generator)
    b, sk = q.shape[0], k.shape[2]
    causal = bool(is_causal)
    kmask = _as_key_padding_mask(mask, b, sk) if mask is not None else None
    if mask is not None and kmask is None:
        # generic [B, H, Sq, Sk] masks: materialized-attention fallback
        return _attention_ref(q, k, v, mask, causal, dropout_p, generator)
    if dropout_p > 0.0 and not _kernel_ok(q, k, causal):
        # unaligned shapes: plain autodiff through the dense reference
        return _attention_ref(q, k, v, mask, causal, dropout_p, generator)
    seed = seed_from_generator(generator) if dropout_p > 0.0 else 0
    return _FlashAttention.apply(q, k, v, kmask, seed, causal,
                                 float(dropout_p), int(bh_offset))


# ---------------------------------------------------------------------------
# DTensor inputs (auto-parallel)
# ---------------------------------------------------------------------------

def _is_dtensor(*ts):
    from ...core.tensor import dtensor_class

    dt = dtensor_class()
    return dt is not None and any(isinstance(t, dt) for t in ts)


def local_form(placements, dropout_p):
    """The placements attention runs under on local shards: each mesh
    dimension's Shard(0) (batch) kept, Shard(1) (heads) kept without
    dropout, everything else replicated. Attention is independent over
    batch and heads, so each rank runs the kernels on its own shard. With
    dropout a head shard is gathered: the hash's index of a (row, head)
    pair is not an offset of the local one there."""
    from torch.distributed.tensor import Replicate

    return tuple(p if p.is_shard(0) or (p.is_shard(1) and dropout_p == 0.0)
                 else Replicate() for p in placements)


def _dtensor_attention(q, k, v, mask, is_causal, dropout_p, generator):
    """Attention of [B, H, S, D] DTensors on this rank's shards: q, k, v
    redistributed to ``local_form`` of q's placements (a plain tensor is
    taken as replicated), the mask sharded as q on the dims it spans, the
    kernels (or their plain versions) run on the local shards with the
    shard's batch offset in the dropout hash, and the output a DTensor of
    the same placements, through the gradient too."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    lead = next(t for t in (q, k, v) if isinstance(t, DTensor))
    mesh = lead.device_mesh
    form = local_form(lead.placements if isinstance(q, DTensor)
                      else [Replicate()] * mesh.ndim, dropout_p)

    def to_form(t, pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pls)

    q, k, v = (to_form(t, form) for t in (q, k, v))
    local_mask = None
    if mask is not None:
        mform = tuple(p if p.is_shard() and mask.dim() == 4
                      and mask.shape[p.dim] == q.shape[p.dim]
                      else Replicate() for p in form)
        local_mask = to_form(mask, mform).to_local()
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, form)
    heads = q.shape[1]
    out = flash_attention_bhsd(q.to_local(), k.to_local(), v.to_local(),
                               local_mask, is_causal, dropout_p, generator,
                               bh_offset=offset[0] * heads)
    return DTensor.from_local(out.contiguous(), mesh, form, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def flash_attention_bshd(q, k, v, mask=None, is_causal=False,
                         dropout_p=0.0, generator=None):
    """Reference layout [B, S, H, D]: swapped to [B, H, S, D] as the TPU
    package does (the kernels' wrappers then copy to contiguous)."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), mask, is_causal,
                               dropout_p, generator)
    return out.transpose(1, 2)
