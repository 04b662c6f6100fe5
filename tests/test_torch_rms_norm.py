"""The port's RMSNorm (paddle_tpu_torch.ops.kernels.rms_norm) against the
JAX reference: paddle_tpu.ops.pallas.rms_norm._rms_norm_ref and
paddle_tpu.nn.functional.rms_norm, on the CPU, where the wrapper takes the
plain version. The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_kernels_gpu.py and chip_smoke.py.

Tolerances: f32 1e-6 relative (the same f32 arithmetic, summed in another
order); bf16 one bf16 ulp, 2**-7 relative (both round the same f32 value,
which may differ in its last bits and so round to the neighbour).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import rms_norm as JR

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.nn import modules as TF
from paddle_tpu_torch.nn.modules import TorchRMSNorm as RMSNorm
from paddle_tpu_torch.ops.kernels import rms_norm as TR

torch.set_num_threads(2)

SHAPES = [(7, 64), (2, 3, 128), (256, 2048), (5, 96)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    return x, w


@pytest.mark.parametrize("with_weight", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_jax(shape, with_weight):
    x, w = _inputs(shape, 0)
    wj = jnp.asarray(w) if with_weight else None
    ref = np.asarray(JR._rms_norm_ref(jnp.asarray(x), wj, 1e-6))
    got = TR.rms_norm(torch.tensor(x),
                      torch.tensor(w) if with_weight else None, 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the public functional of the TPU package, which wraps _rms_norm
    args = [paddle.to_tensor(x)] + ([paddle.to_tensor(w)]
                                    if with_weight else [])
    pub = paddle.nn.functional.rms_norm(*args, epsilon=1e-6).numpy()
    np.testing.assert_allclose(got.numpy(), pub, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_weight", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_jax(shape, with_weight):
    x, w = _inputs(shape, 1)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w, jnp.bfloat16) if with_weight else None
    ref = np.asarray(JR._rms_norm_ref(xj, wj, 1e-6).astype(jnp.float32))
    xt = torch.tensor(x).to(torch.bfloat16)
    wt = torch.tensor(w).to(torch.bfloat16) if with_weight else None
    got = TR.rms_norm(xt, wt, 1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    err = np.abs(got.float().numpy() - ref)
    assert np.all(err <= 2.0 ** -7 * np.abs(ref) + 1e-30), err.max()


def test_layer_and_functional_route_to_wrapper():
    x, w = _inputs((4, 64), 2)
    layer = RMSNorm(64, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(w))
    a = layer(torch.tensor(x))
    b = TF.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6)
    ref = JR._rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(a, b)


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    x, w = _inputs((3, 64), 3)
    TR.rms_norm(torch.tensor(x), torch.tensor(w))
    TR.rms_norm(torch.tensor(x))
    assert launch_counts()["rms_norm"] == 0



@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_bf16_x_with_f32_weight_matches_jax(shape):
    """The training path's case: bf16 activations, f32 norm weights."""
    x, w = _inputs(shape, 4)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JR._rms_norm_ref(xj, jnp.asarray(w), 1e-6)
                     .astype(jnp.float32))
    got = TR.rms_norm(torch.tensor(x).to(torch.bfloat16), torch.tensor(w))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert np.all(err <= 2.0 ** -7 * np.abs(ref) + 1e-30), err.max()


@pytest.mark.parametrize("case", ["f32", "f32_no_weight", "bf16_x_f32_w",
                                  "bf16"])
def test_gradients_match_jax_vjp(case):
    """The backward is the TPU package's _bwd (rms_norm.py:88-104): gx in
    x's dtype, gw in the weight's. f32: 1e-5 of the largest magnitude (sums
    in another order); a bf16 gx: one bf16 ulp, 2**-7 relative."""
    import jax

    x, w = _inputs((4, 3, 128), 5)
    g = np.random.RandomState(6).randn(4, 3, 128).astype(np.float32)
    xdt = jnp.bfloat16 if case.startswith("bf16") else jnp.float32
    wdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    xj, gj = jnp.asarray(x, xdt), jnp.asarray(g, xdt)
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    xt = torch.tensor(np.asarray(xj, np.float32)).to(tdt[xdt]) \
        .requires_grad_(True)
    gt = torch.tensor(np.asarray(gj, np.float32)).to(tdt[xdt])
    if case == "f32_no_weight":
        _, vjp = jax.vjp(lambda a: JR.rms_norm(a, None, 1e-6), xj)
        (gxj,) = vjp(gj)
        TR.rms_norm(xt, None, 1e-6).backward(gt)
        pairs = [(xt.grad, gxj)]
    else:
        wj = jnp.asarray(w, wdt)
        _, vjp = jax.vjp(lambda a, b: JR.rms_norm(a, b, 1e-6), xj, wj)
        gxj, gwj = vjp(gj)
        wt = torch.tensor(np.asarray(wj, np.float32)).to(tdt[wdt]) \
            .requires_grad_(True)
        TR.rms_norm(xt, wt, 1e-6).backward(gt)
        assert wt.grad.dtype == wt.dtype
        pairs = [(xt.grad, gxj), (wt.grad, gwj)]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        got = got.float().numpy()
        if case == "bf16" or (case == "bf16_x_f32_w" and got.shape == x.shape):
            tol = 2.0 ** -7 * np.abs(ref) + 1e-6
        else:
            tol = 1e-5 * np.abs(ref).max()
        assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def test_layer_weight_trains():
    layer = RMSNorm(64, device="cpu")
    x = torch.tensor(_inputs((4, 64), 7)[0], requires_grad=True)
    layer(x).square().sum().backward()
    assert layer.weight.grad is not None and x.grad is not None
    assert layer.weight.grad.shape == (64,)


# -- any width, forward and gradient -----------------------------------------
# The kernels take every h the TPU kernel takes (rms_norm.py:45-74 blocks
# rows over the full last dim): a ragged h (37, 100: no 16-byte units in
# bf16) and rows wider than the registers hold (40,000). Here the plain
# versions against the JAX package's rms_norm and its jax.vjp (the TPU
# package's _bwd). Tolerances, element by element, each row held to its own
# RMS (gx has cancellations): f32 1e-5 * (|ref| + row RMS) + 1e-7 (the same
# f32 arithmetic, sums over up to 40,000 terms in other orders); bf16
# 2**-7 * (|ref| + row RMS) + 1e-6 (one bf16 ulp: both round f32 values
# that differ in their last bits). gw per column within
# 1e-4 * sum over rows of |g * xhat| + 1e-6, plus one bf16 ulp
# (2**-7 * |ref|) where the weight, and so gw, is bf16: both round f32 sums
# taken in other orders.

WIDE_CASES = [(3, 37), (1, 100), (6, 100), (2, 40000), (5, 2048)]


def _row_tol(ref, rtol, floor):
    rms = np.sqrt(np.mean(np.square(ref), axis=-1, keepdims=True))
    return rtol * (np.abs(ref) + rms) + floor


@pytest.mark.parametrize("weight", ["same", "f32", None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h", WIDE_CASES)
def test_any_width_forward_and_gradient_match_jax(rows, h, dtype, weight):
    import jax

    rng = np.random.RandomState(rows * 7 + h)
    x = (rng.randn(rows, h) * 3).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    w = rng.randn(h).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    wdt = None if weight is None else (dtype if weight == "same"
                                       else "float32")
    xj, gj = jnp.asarray(x, jdt[dtype]), jnp.asarray(g, jdt[dtype])
    xt = torch.tensor(np.asarray(xj, np.float32)).to(tdt[dtype])
    gt = torch.tensor(np.asarray(gj, np.float32)).to(tdt[dtype])
    if wdt is None:
        yj, vjp = jax.vjp(lambda a: JR.rms_norm(a, None, 1e-6), xj)
        (gxj,) = vjp(gj)
        wt = None
    else:
        wj = jnp.asarray(w, jdt[wdt])
        yj, vjp = jax.vjp(lambda a, b: JR.rms_norm(a, b, 1e-6), xj, wj)
        gxj, gwj = vjp(gj)
        wt = torch.tensor(np.asarray(wj, np.float32)).to(tdt[wdt])
    y = TR.rms_norm(xt, wt, 1e-6)
    gx, gw = TR._rms_norm_bwd(xt, wt, 1e-6, gt)
    assert y.dtype == xt.dtype and gx.dtype == xt.dtype
    rtol, floor = (1e-5, 1e-7) if dtype == "float32" else (2.0 ** -7, 1e-6)
    for got, ref in ((y, yj), (gx, gxj)):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - ref)
        tol = _row_tol(ref, rtol, floor)
        assert np.all(err <= tol), float((err / tol).max())
    if wdt is not None:
        assert gw.dtype == wt.dtype
        xf = np.asarray(xj, np.float32)
        xhat = xf / np.sqrt(np.mean(xf * xf, -1, keepdims=True) + 1e-6)
        scale = np.abs(np.asarray(gj, np.float32) * xhat).sum(0)
        ref = np.asarray(gwj, np.float32)
        tol = 1e-4 * scale + 1e-6 + (2.0 ** -7 * np.abs(ref)
                                     if wdt == "bfloat16" else 0.0)
        err = np.abs(gw.float().numpy() - ref)
        assert np.all(err <= tol), float((err / tol).max())
    else:
        assert gw is None


def test_cpu_gradient_launches_no_kernel():
    reset_launch_counts()
    x, w = _inputs((3, 100), 8)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    TR.rms_norm(xt, wt).square().sum().backward()
    TR.rms_norm(xt).sum().backward()
    counts = launch_counts()
    assert counts["rms_norm"] == 0 and counts["rms_norm_bwd"] == 0
    assert xt.grad is not None and wt.grad is not None


def test_launch_counts_carry_the_gradient_kernel():
    counts = launch_counts()
    assert "rms_norm_bwd" in counts
    TR.launches_bwd = 3
    assert launch_counts()["rms_norm_bwd"] == 3
    reset_launch_counts()
    assert TR.launches_bwd == 0 and launch_counts()["rms_norm_bwd"] == 0


@pytest.mark.parametrize("h,dtype,backward,path", [
    (2048, torch.bfloat16, False, ("vector", "resident")),
    (2048, torch.bfloat16, True, ("vector", "resident")),
    (2048, torch.float32, True, ("vector", "resident")),
    (4096, torch.bfloat16, True, ("vector", "resident")),
    (4096, torch.float32, True, ("vector", "two-pass")),
    (32768, torch.bfloat16, False, ("vector", "resident")),
    (32776, torch.bfloat16, False, ("vector", "two-pass")),
    (16384, torch.float32, False, ("vector", "resident")),
    (16388, torch.float32, False, ("vector", "two-pass")),
    (40000, torch.bfloat16, True, ("vector", "two-pass")),
    (100, torch.bfloat16, False, ("element", "resident")),
    (100, torch.float32, False, ("vector", "resident")),
    (37, torch.float32, True, ("element", "resident")),
    (513, torch.float32, True, ("element", "two-pass")),
    (4097, torch.bfloat16, False, ("element", "two-pass")),
])
def test_kernel_path(h, dtype, backward, path):
    """16-byte units where h is a multiple of them, else elements; rows of
    at most 4096 units (forward) or 512 (gradient) stay in registers."""
    assert TR.kernel_path(h, dtype, backward) == path


def test_kernel_path_refuses_other_dtypes():
    with pytest.raises(TypeError):
        TR.kernel_path(64, torch.float16)
