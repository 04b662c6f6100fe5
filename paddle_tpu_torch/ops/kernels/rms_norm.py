"""RMSNorm: the CUDA kernel (csrc/rms_norm.cu), its plain version, and its
gradient.

Replaces paddle_tpu/ops/pallas/rms_norm.py::_kernel and ::_kernel_nw. The
kernel is bound by bytes (one read and one write of each row); the source
note in csrc/rms_norm.cu gives the bound and the design. The gradient is
the TPU package's analytic ``_bwd`` (rms_norm.py:88-104) in plain tensor
code, as the TPU package leaves it to XLA: no kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VEC_PER_THREAD = 4
_MAX_THREADS = 1024
_entry = None


def _rms_norm_ref(x, weight, eps):
    """Plain PyTorch version: normalise in f32, multiply by the weight in
    f32 after normalising, cast once (rms_norm.py:22-28)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def _launch(x, weight, eps):
    global _entry, launches
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if weight is not None and (weight.dtype not in _DTYPE_CODE
                               or weight.device != x.device
                               or tuple(weight.shape) != (x.shape[-1],)):
        raise ValueError("rms_norm kernel: weight must be a float32 or "
                         "bfloat16 [h] tensor on x's device")
    if weight is not None and weight.dtype not in (x.dtype, torch.float32):
        # the kernel reads x's dtype or f32; the TPU kernel reads any
        # weight as f32 (rms_norm.py:35), and bf16 -> f32 is exact
        weight = weight.float()
    h = x.shape[-1]
    vec = 16 // x.element_size()
    if h % vec or h // vec > _MAX_THREADS * _MAX_VEC_PER_THREAD:
        raise ValueError(f"rms_norm kernel: h={h} must be a multiple of "
                         f"{vec} and at most "
                         f"{vec * _MAX_THREADS * _MAX_VEC_PER_THREAD}")
    # the kernel's 16-byte loads: an input at an odd offset is copied
    x2 = _build.aligned16(x.contiguous().reshape(-1, h))
    w = _build.aligned16(weight.contiguous()) if weight is not None \
        else None
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    if _entry is None:
        _entry = _build.entry("pt_rms_norm", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(x2.data_ptr(), w.data_ptr() if w is not None else None,
                 y.data_ptr(), x2.shape[0], h, float(eps),
                 _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[w.dtype if w is not None else x.dtype], stream)
    _build.check(err, "rms_norm")
    launches += 1
    return y.reshape(x.shape)


def _forward(x, weight, eps):
    if x.device.type == "cpu":
        return _rms_norm_ref(x, weight, eps)
    if x.device.type == "cuda":
        return _launch(x, weight, eps)
    raise ValueError(f"rms_norm: no path for device {x.device}")


def _rms_norm_bwd(x, weight, eps, g):
    """(gx in x's dtype, gw in the weight's dtype or None): the TPU
    package's _bwd (rms_norm.py:88-104), in f32."""
    xf = x.float()
    gf = g.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    if weight is not None:
        gw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
        gxhat = gf * weight.float()
    else:
        gw = None
        gxhat = gf
    gx = inv * (gxhat - xhat * (gxhat * xhat).mean(dim=-1, keepdim=True))
    return gx.to(x.dtype), gw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx, gw = _rms_norm_bwd(x, weight, ctx.eps, g)
        return gx, (gw if ctx.needs_input_grad[1] else None), None


def rms_norm(x, weight=None, eps: float = 1e-6):
    """rms_norm over the last axis; weight=None is pure normalisation
    (the TPU package's _kernel_nw). A CPU tensor takes the plain version,
    a CUDA tensor the kernel. Differentiable in x and weight: the forward
    is the kernel, the backward plain tensor code."""
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        return _RMSNorm.apply(x, weight, eps)
    return _forward(x, weight, eps)
