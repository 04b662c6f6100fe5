"""Dequantization of the streamed serving decoder's weights: the CUDA kernel
(csrc/weight_dequant.cu) and its plain versions.

Replaces paddle_tpu/inference/weight_stream.py::dequantize (:61) and
::dequantize_int4 (:99), which the TPU package writes as jnp inside the
jitted step for XLA to fuse (no Pallas kernel). int8 per channel: code x
the output channel's f32 scale; int4 grouped: two codes a byte along the
input axis (the even row in the high nibble, biased by +8), x the scale of
the (32-row group, output channel), the padding rows dropped. The product
is one f32 multiply, rounded once to the output dtype, so the kernel and
the plain versions give the reference's bits.

One launch dequantizes a layer's group (up to four Linears, one mode) into
its outputs, each [in, out] float32 or bfloat16: the streaming engine's
workspace slot. The kernel takes output widths that are multiples of 8 and
16-byte aligned, contiguous tensors; other inputs raise. The wrapper is
called through the kernel library's extension module (csrc/pymodule.cu).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["INT4_GROUP", "dequantize", "dequantize_int4", "weight_dequant"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

# rows an int4 scale covers (weight_stream.py:73)
INT4_GROUP = 32
MAX_SEGMENTS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # pt::kFloat32, kBFloat16
_MODES = {torch.int8: 0, torch.uint8: 1}           # int8, packed int4


def dequantize(q, scale, dtype):
    """Plain version, int8 per channel: codes [in, out] as f32 x the f32
    scales [out], rounded once to ``dtype``."""
    return (q.float() * scale).to(dtype)


def dequantize_int4(packed, scale, dtype, in_dim: int,
                    group: int = INT4_GROUP):
    """Plain version, int4 grouped: unpack the nibbles of ``packed`` [in_pad
    // 2, out] (even row high), unbias (- 8), times the group's f32 scale
    (``scale`` [in_pad // group, out]), drop the padding rows past
    ``in_dim``, round once to ``dtype``."""
    hi = (packed >> 4) & 0xF
    lo = packed & 0xF
    nib = torch.stack([hi, lo], dim=1).reshape(-1, packed.shape[1])
    q = nib.float() - 8.0
    s = scale.repeat_interleave(group, dim=0)
    return (q * s)[:in_dim].to(dtype)


def _check(segments, outs):
    """Shapes, dtypes and devices of a group; raises on what no path
    takes."""
    if not 1 <= len(segments) <= MAX_SEGMENTS \
            or len(outs) != len(segments):
        raise ValueError(f"weight_dequant: 1 to {MAX_SEGMENTS} segments, "
                         f"an output each ({len(segments)} and {len(outs)})")
    kind = segments[0][0].dtype
    if kind not in _MODES:
        raise TypeError(f"weight_dequant: int8 codes or packed uint8 int4 "
                        f"codes, not {kind}")
    dev = outs[0].device
    for (q, s, in_dim), o in zip(segments, outs):
        if q.dtype is not kind or s.dtype is not torch.float32:
            raise TypeError("weight_dequant: codes of one mode and float32 "
                            "scales")
        if o.dtype not in _DTYPES or o.dtype is not outs[0].dtype:
            raise TypeError(f"weight_dequant: float32 or bfloat16 outputs "
                            f"of one dtype, not {o.dtype}")
        if q.dim() != 2 or o.shape != (in_dim, q.shape[1]):
            raise ValueError(f"weight_dequant: codes [rows, out] and an "
                             f"output [{in_dim}, out], not "
                             f"{tuple(q.shape)} and {tuple(o.shape)}")
        out = q.shape[1]
        if kind is torch.int8:
            want_rows, want_s = in_dim, (out,)
        else:
            groups = -(-in_dim // INT4_GROUP)
            want_rows, want_s = groups * INT4_GROUP // 2, (groups, out)
        if q.shape[0] != want_rows or tuple(s.shape) != want_s:
            raise ValueError(f"weight_dequant: in_dim {in_dim} needs codes "
                             f"of {want_rows} rows and scales {want_s}, not "
                             f"{tuple(q.shape)} and {tuple(s.shape)}")
        if q.device != dev or s.device != dev or o.device != dev:
            raise ValueError("weight_dequant: every tensor on one device")


def _launch(segments, outs):
    global launches
    for (q, s, _), o in zip(segments, outs):
        for t in (q, s, o):
            if not t.is_contiguous():
                raise ValueError("weight_dequant kernel: contiguous codes, "
                                 "scales and outputs")
            if t.data_ptr() % 16:
                raise ValueError("weight_dequant kernel: every tensor "
                                 "16-byte aligned")
        if q.shape[1] % 8:
            raise ValueError(f"weight_dequant kernel: an output width that "
                             f"is a multiple of 8, not {q.shape[1]}")
    args = []
    for (q, s, in_dim), o in zip(segments, outs):
        args += [q.data_ptr(), s.data_ptr(), o.data_ptr(), in_dim,
                 q.shape[1]]
    args += [None, None, None, 0, 0] * (MAX_SEGMENTS - len(segments))
    err = _build.py_module().weight_dequant(
        _MODES[segments[0][0].dtype], _DTYPES[outs[0].dtype], len(segments),
        *args, torch._C._cuda_getCurrentRawStream(outs[0].get_device()))
    _build.check(err, "weight_dequant")
    launches += 1


def weight_dequant(segments, outs):
    """Dequantize ``segments`` [(codes, scales, in_dim)] (one to four of one
    mode: int8 codes [in, out] with f32 scales [out], or packed uint8 int4
    codes [ceil(in / 32) * 16, out] with f32 scales [ceil(in / 32), out])
    into ``outs`` [in, out] (float32 or bfloat16), in place. A CPU tensor
    takes the plain versions, a CUDA tensor the kernel (one launch)."""
    _check(segments, outs)
    if outs[0].is_cuda:
        return _launch(segments, outs)
    if outs[0].device.type != "cpu":
        raise ValueError(f"weight_dequant: no path for device "
                         f"{outs[0].device}")
    for (q, s, in_dim), o in zip(segments, outs):
        if q.dtype is torch.int8:
            o.copy_(dequantize(q, s, o.dtype))
        else:
            o.copy_(dequantize_int4(q, s, o.dtype, in_dim))
