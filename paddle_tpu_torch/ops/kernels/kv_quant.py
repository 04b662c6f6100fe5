"""Quantize-on-append of the int8 cache-KV path: the CUDA kernel
(csrc/kv_quant.cu) and its plain version.

Replaces ``q8`` and the four page scatters of the dynamic int8 route of
paddle_tpu/incubate/nn/functional/__init__.py::block_multihead_attention
(:687-704), which the TPU package writes as jnp for XLA to fuse (no Pallas
kernel). For each written token t and kv head h, of K and of V: the scale
s = max(max_d |x| * (1/127), 1e-8) in f32 and the codes
clip(round_half_even(x / s), -127, 127) as int8 go to slot[t] of page[t]
in one layer of the stacked int8 pools [L, num_blocks, HKV, bs, D] and f32
scale pools [L, num_blocks, HKV, bs], in place. The reference's
``max / 127.0`` is a division by a constant, which XLA rewrites as a
multiply by the constant's f32 reciprocal; ``x / s`` stays a division. The
kernel and the plain version compute exactly that, so both give the
reference's codes and scales bit for bit. K and V are done in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["kv_quant"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # pt::kFloat32, kBFloat16
# f32(1 / 127): what XLA multiplies by for the reference's `max / 127.0`
INV127 = float(np.float32(1.0) / np.float32(127.0))


def _quant_ref(x):
    """(codes int8 [..., D], scales f32 [...]) of x [..., D]. Every
    division is tensor by tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead."""
    xf = x.float()
    m = xf.abs().amax(dim=-1)
    s = (m * torch.full_like(m, INV127)).clamp_min(1e-8)
    codes = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return codes, s


def _kv_quant_ref(k, v, key_cache, value_cache, k_scales, v_scales,
                  layer_idx, page, slot):
    """Plain PyTorch version: quantize k and v [T, HKV, D] and scatter the
    codes and scales into layer ``layer_idx`` of the pools, in place."""
    for x, pool, scales in ((k, key_cache, k_scales),
                            (v, value_cache, v_scales)):
        codes, s = _quant_ref(x)
        # [pages, HKV, bs, ...] viewed as [pages, bs, HKV, ...]
        pool[layer_idx].transpose(1, 2)[page, slot] = codes
        scales[layer_idx].transpose(1, 2)[page, slot] = s


def _check(k, v, key_cache, value_cache, k_scales, v_scales, layer_idx,
           page, slot):
    if k.dim() != 3 or v.shape != k.shape or key_cache.dim() != 5 \
            or value_cache.shape != key_cache.shape:
        raise ValueError("kv_quant: k, v [T, HKV, D] and stacked caches "
                         "[L, num_blocks, HKV, block_size, D] of one shape")
    T, HKV, D = k.shape
    L, nb, hkv, bs, d = key_cache.shape
    if (hkv, d) != (HKV, D):
        raise ValueError(f"kv_quant: k's [HKV, D] = [{HKV}, {D}] must match "
                         f"the caches' [{hkv}, {d}]")
    if k_scales.shape != (L, nb, hkv, bs) \
            or v_scales.shape != k_scales.shape:
        raise ValueError("kv_quant: scale pools [L, num_blocks, HKV, "
                         "block_size]")
    if key_cache.dtype is not torch.int8 \
            or value_cache.dtype is not torch.int8 \
            or k_scales.dtype is not torch.float32 \
            or v_scales.dtype is not torch.float32:
        raise TypeError("kv_quant: int8 caches and float32 scale pools")
    if not 0 <= layer_idx < L:
        raise ValueError(f"kv_quant: layer_idx {layer_idx} not in [0, {L})")
    if page.shape != (T,) or slot.shape != (T,) \
            or page.dtype is not torch.int64 or slot.dtype is not torch.int64:
        raise ValueError("kv_quant: page and slot [T] int64")
    dev = k.device
    if any(t.device != dev for t in (v, key_cache, value_cache, k_scales,
                                     v_scales, page, slot)):
        raise ValueError("kv_quant: every input on k's device")


def _rows(x):
    """x [T, HKV, D] with each token's HKV * D elements contiguous (a view
    of the packed qkv is), and its token stride in elements."""
    T, HKV, D = x.shape
    if x.stride(2) != 1 or x.stride(1) != D or x.stride(0) < HKV * D:
        x = x.contiguous()
    return x, x.stride(0)


def _launch(k, v, key_cache, value_cache, k_scales, v_scales, layer_idx,
            page, slot):
    global launches
    if k.dtype not in _DTYPES or v.dtype is not k.dtype:
        raise TypeError(f"kv_quant kernel takes float32 or bfloat16 k and v "
                        f"of one dtype, not {k.dtype}, {v.dtype}")
    for t in (key_cache, value_cache, k_scales, v_scales):
        if not t.is_contiguous():
            raise ValueError("kv_quant kernel: the pools must be contiguous")
    T, HKV, D = k.shape
    if T == 0:
        return
    k, ks_ = _rows(k)
    v, vs_ = _rows(v)
    page, slot = page.contiguous(), slot.contiguous()
    bs = key_cache.shape[3]
    err = _build.py_module().kv_quant(
        k.data_ptr(), v.data_ptr(), ks_, vs_, page.data_ptr(),
        slot.data_ptr(), key_cache[layer_idx].data_ptr(),
        value_cache[layer_idx].data_ptr(), k_scales[layer_idx].data_ptr(),
        v_scales[layer_idx].data_ptr(), T, HKV, D, bs, _DTYPES[k.dtype],
        torch._C._cuda_getCurrentRawStream(k.get_device()))
    _build.check(err, "kv_quant")
    launches += 1


def kv_quant(k, v, key_cache, value_cache, k_scales, v_scales, layer_idx,
             page, slot):
    """Quantize k and v [T, HKV, D] (float32 or bfloat16; each token's row
    contiguous, as a view of the packed qkv is) into layer ``layer_idx`` of
    the stacked int8 pools [L, num_blocks, HKV, bs, D] and f32 scale pools
    [L, num_blocks, HKV, bs] at page[t], slot[t] (int64 [T]), in place. A
    CPU tensor takes the plain version, a CUDA tensor the kernel."""
    _check(k, v, key_cache, value_cache, k_scales, v_scales, layer_idx,
           page, slot)
    if k.is_cuda:
        return _launch(k, v, key_cache, value_cache, k_scales, v_scales,
                       layer_idx, page, slot)
    if k.device.type == "cpu":
        return _kv_quant_ref(k, v, key_cache, value_cache, k_scales,
                             v_scales, layer_idx, page, slot)
    raise ValueError(f"kv_quant: no path for device {k.device}")
