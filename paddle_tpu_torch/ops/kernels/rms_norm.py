"""RMSNorm: the CUDA kernels (csrc/rms_norm.cu), their plain versions, and
the gradient.

Replaces paddle_tpu/ops/pallas/rms_norm.py::_kernel and ::_kernel_nw, and
the analytic ``_bwd`` (rms_norm.py:88-104) that the TPU package leaves to
XLA to fuse: here the gradient is one kernel launch (plus a small one that
sums the weight gradient's per-block partials). Both are bound by bytes;
the source note in csrc/rms_norm.cu gives the bounds and the design. Any
h, float32 or bfloat16 x, a float32 or bfloat16 weight (read as x's dtype
or as float32: a bfloat16 weight beside float32 x is cast, exactly).

The forward wrapper is on the serving path's hot loop, where the card waits
for the host (33 calls a decode step), so it does the least work a call:
one cached mode word a (h, dtype, weight dtype), the raw stream handle, no
reshapes, and the C entries called through the library's extension module
(``_build.py_module``, csrc/pymodule.cu) rather than ctypes.

The forward is also the registered op ``paddle_tpu_torch::rms_norm``
(``torch.ops.paddle_tpu_torch.rms_norm``): a traced program
(``torch.export``, the deploy artifact of inference/__init__.py) cannot
follow a launch through ``data_ptr()``, so while tracing the wrapper calls
the op, whose CUDA implementation is ``_launch`` and CPU implementation the
plain version. Outside tracing the wrapper launches directly: a call
through the dispatcher costs ~15 us more host time (a trivial op's, on a
CPU host), which a host-bound serving step would pay 33 times.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "kernel_path"]

# kernel launches since the last reset (ops.kernels.reset_launch_counts):
# the forward, and the gradient (one count a call for both of its kernels)
launches = 0
launches_bwd = 0

# bits of the C entries' mode word (csrc/rms_norm.cu, kMode*)
_MODE_BF16, _MODE_WEIGHT_F32, _MODE_VECTOR, _MODE_RESIDENT = 1, 2, 4, 8
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}
# the most units (16-byte vectors, or elements for a ragged h) a row may
# have to stay in registers: 4 a thread at 1024 threads in the forward,
# one a thread at 512 in the gradient; wider rows take two passes
_FWD_RESIDENT_UNITS = 4 * 1024
_BWD_RESIDENT_UNITS = 512
# the gradient's grid: four blocks on each of an H100's 132 SMs (at h =
# 2048 bf16 a block is 256 threads of 59 registers, so all four fit; 264
# blocks ran 0.125 ms a call, 528 0.092, 1056 0.098 on the card,
# tools/torch_rms_norm_probe.py). A constant, so which block sums which
# rows of gw, and so gw's bits, do not depend on the card it runs on.
BWD_BLOCKS = 528

_modes = {}            # (h, x dtype, weight dtype or None, backward) -> mode


def _rms_norm_ref(x, weight, eps):
    """Plain PyTorch version: normalise in f32, multiply by the weight in
    f32 after normalising, cast once (rms_norm.py:22-28)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def kernel_path(h: int, dtype, backward: bool = False):
    """How the kernels take a row of width ``h``: ("vector" or "element",
    "resident" or "two-pass"). Vector units are 16 bytes of ``dtype``
    (where h is a multiple of them), else single elements; a row that has
    at most 4096 units (forward) or 512 (gradient) is held in registers,
    a wider one is read twice, the second time from L2."""
    if dtype not in _ELEMENT_SIZE:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    vec = 16 // _ELEMENT_SIZE[dtype]
    unit, units = ("vector", h // vec) if h % vec == 0 else ("element", h)
    cap = _BWD_RESIDENT_UNITS if backward else _FWD_RESIDENT_UNITS
    return unit, ("resident" if units <= cap else "two-pass")


def _mode(h, dtype, wdtype, backward):
    key = (h, dtype, wdtype, backward)
    mode = _modes.get(key)
    if mode is None:
        unit, rows = kernel_path(h, dtype, backward)
        if wdtype is not None and wdtype not in _ELEMENT_SIZE:
            raise ValueError("rms_norm kernel: weight must be a float32 or "
                             "bfloat16 [h] tensor on x's device")
        mode = ((_MODE_BF16 if dtype == torch.bfloat16 else 0)
                | (_MODE_WEIGHT_F32 if torch.float32 in (dtype, wdtype)
                   else 0)
                | (_MODE_VECTOR if unit == "vector" else 0)
                | (_MODE_RESIDENT if rows == "resident" else 0))
        _modes[key] = mode
    return mode


def _kernel_weight(x, weight):
    """The weight as the kernels read it: x's dtype or f32, contiguous,
    16-byte aligned; refuses one of another shape or device."""
    if weight.shape != x.shape[-1:] or weight.get_device() != \
            x.get_device():
        raise ValueError("rms_norm kernel: weight must be a float32 or "
                         "bfloat16 [h] tensor on x's device")
    if weight.dtype is not x.dtype and weight.dtype is not torch.float32:
        # the TPU kernel reads any weight as f32 (rms_norm.py:35); bf16 ->
        # f32 is exact
        weight = weight.float()
    if not weight.is_contiguous():
        weight = weight.contiguous()
    return _build.aligned16(weight)


def _launch(x, weight, eps):
    global launches
    h = x.shape[-1]
    if weight is None:
        mode = _mode(h, x.dtype, None, False)
        wp = None
    else:
        mode = _mode(h, x.dtype, weight.dtype, False)
        # held until the launch: a cast or copy made here must outlive it
        weight = _kernel_weight(x, weight)
        wp = weight.data_ptr()
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x)
    if not y.numel():
        return y
    if mode & _MODE_VECTOR:
        # the kernel's 16-byte loads: an input at an odd offset is copied
        x = _build.aligned16(x)
    err = _build.py_module().rms_norm(
        x.data_ptr(), wp, y.data_ptr(), x.numel() // h, h, eps, mode,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        _build.check(err, "rms_norm")
    launches += 1
    return y


def _forward(x, weight, eps):
    if x.is_cuda:
        return _launch(x, weight, eps)
    if x.device.type == "cpu":
        return _rms_norm_ref(x, weight, eps)
    raise ValueError(f"rms_norm: no path for device {x.device}")


def _rms_norm_bwd(x, weight, eps, g):
    """(gx in x's dtype, gw in the weight's dtype or None): the TPU
    package's _bwd (rms_norm.py:88-104), in f32. The plain version of the
    gradient kernel."""
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


def _launch_bwd(x, weight, eps, g):
    """The gradient kernel: (gx in x's dtype, gw in the weight's dtype or
    None). x and g may be any views: each is made contiguous and, if at an
    odd offset, copied to a 16-byte boundary (counted)."""
    global launches_bwd
    if g.shape != x.shape or g.dtype is not x.dtype or g.device != x.device:
        raise ValueError("rms_norm gradient kernel: g must have x's shape, "
                         "dtype and device")
    h = x.shape[-1]
    mode = _mode(h, x.dtype, None if weight is None else weight.dtype, True)
    wk = None if weight is None else _kernel_weight(x, weight)
    x, g = x.contiguous(), g.contiguous()
    if mode & _MODE_VECTOR:
        x, g = _build.aligned16(x), _build.aligned16(g)
    gx = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    if rows == 0:
        return gx, (None if weight is None else torch.zeros_like(weight))
    blocks = min(rows, BWD_BLOCKS)
    part = gw = None
    if wk is not None:
        part = torch.empty((blocks, h), dtype=torch.float32, device=x.device)
        gw = torch.empty(h, dtype=wk.dtype, device=x.device)
    err = _build.py_module().rms_norm_bwd(
        x.data_ptr(), g.data_ptr(), None if wk is None else wk.data_ptr(),
        gx.data_ptr(), None if part is None else part.data_ptr(),
        None if gw is None else gw.data_ptr(), rows, h, eps, mode, blocks,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "rms_norm_bwd")
    launches_bwd += 1
    if gw is not None and gw.dtype is not weight.dtype:
        gw = gw.to(weight.dtype)
    return gx, gw


def _backward(x, weight, eps, g):
    if x.is_cuda:
        return _launch_bwd(x, weight, eps, g)
    if x.device.type == "cpu":
        return _rms_norm_bwd(x, weight, eps, g)
    raise ValueError(f"rms_norm: no path for device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx, gw = _backward(x, weight, ctx.eps, g)
        return gx, (gw if ctx.needs_input_grad[1] else None), None


_op = torch.library.custom_op(
    "paddle_tpu_torch::rms_norm", _launch, mutates_args=(),
    device_types="cuda",
    schema="(Tensor x, Tensor? weight, float eps) -> Tensor")
_op.register_kernel("cpu")(_rms_norm_ref)


@_op.register_fake
def _rms_norm_fake(x, weight, eps):
    kernel_path(x.shape[-1], x.dtype)            # refuses what it refuses
    return x.new_empty(x.shape)


def rms_norm(x, weight=None, eps: float = 1e-6):
    """rms_norm over the last axis; weight=None is pure normalisation
    (the TPU package's _kernel_nw). A CPU tensor takes the plain versions,
    a CUDA tensor the kernels. Differentiable in x and weight: the forward
    and the gradient are each a kernel. While tracing, the registered op
    (forward only)."""
    if torch.compiler.is_compiling():
        return torch.ops.paddle_tpu_torch.rms_norm(x, weight, eps)
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        return _RMSNorm.apply(x, weight, eps)
    return _forward(x, weight, eps)
