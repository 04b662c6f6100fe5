"""The port's packed-sequence entry points (paddle_tpu_torch.incubate.nn.
functional: ``flash_attn_unpadded``, ``flash_attn_varlen_qkvpacked``)
against the JAX package's on the CPU, output and q/k/v gradients, on both
of its routes:

- the kernel route (pad to a multiple of 128, segment ids, the varlen
  kernels): the JAX side's Pallas kernels in interpret mode
  (PT_PALLAS_INTERPRET=1 per test, restored afterwards), the port's plain
  versions;
- the per-segment dense route (a ``scale``, live dropout, or
  ``cu_seqlens_q != cu_seqlens_k``), which the JAX package takes
  whatever the kernel setting.

JAX gradients go through its eager autograd (``stop_gradient=False``,
``loss.backward()``, ``.grad``). Tolerances, f32: outputs 1e-5 (TOL),
gradients 1e-4 (GRAD_TOL), absolute and relative: the same f32 arithmetic
with sums in other orders. Dropout bits come from jax.random on one side
and a torch.Generator on the other, so dropout is checked within the port
only. PyTorch runs on one thread in each test (see
tests/test_torch_varlen_attention.py).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JF

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.incubate.nn import functional as TF

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = os.environ.get("PT_PALLAS_INTERPRET")
    threads = torch.get_num_threads()
    os.environ["PT_PALLAS_INTERPRET"] = "1"
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if old is None:
        os.environ.pop("PT_PALLAS_INTERPRET", None)
    else:
        os.environ["PT_PALLAS_INTERPRET"] = old


def _inputs(total, h=2, d=64, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.randn(total, h, d).astype(np.float32)
                    for _ in range(4))
    return q, k, v, cot


def _jax(fn, arrays, cot, *args, **kw):
    """Output and gradients of ``fn`` in the JAX package's eager autograd
    with loss sum(out * cot)."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out, _ = fn(*ts, *args, **kw)
    (out * paddle.to_tensor(cot)).sum().backward()
    return out.numpy(), [t.grad.numpy() for t in ts]


def _port(fn, arrays, cot, *args, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, none = fn(*ts, *args, **kw)
    assert none is None
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(port, ref):
    (op, gp), (oj, gj) = port, ref
    assert op.shape == oj.shape
    np.testing.assert_allclose(op, oj, atol=TOL, rtol=TOL)
    for a, b in zip(gp, gj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("total,lens,causal", [
    (200, [37, 100, 63], True),
    (200, [37, 100, 63], False),
    (300, [17, 150, 90, 43], True),
    (300, [17, 150, 90, 43], False),
])
def test_kernel_route_matches_jax(total, lens, causal):
    """Padded to 256 / 384 with a padding tail inside the packed batch."""
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    assert cu[-1] == total
    assert TF._unpadded_kernel_route(64, cu, cu, None, 0.0, True)
    q, k, v, cot = _inputs(total, seed=total)
    ref = _jax(JF.flash_attn_unpadded, (q, k, v), cot, paddle.to_tensor(cu),
               paddle.to_tensor(cu), causal=causal)
    got = _port(TF.flash_attn_unpadded, (q, k, v), cot, torch.tensor(cu),
                cu.tolist(), causal=causal)
    _close(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_per_segment_route_matches_jax(causal):
    """``scale`` set and cu_seqlens_q != cu_seqlens_k: the per-segment
    route, bottom-right aligned when a segment has fewer queries than
    keys."""
    cq = np.array([0, 20, 70, 100], np.int32)
    ck = np.array([0, 45, 95, 150], np.int32)
    rng = np.random.RandomState(7)
    q = rng.randn(100, 2, 32).astype(np.float32)
    k, v = (rng.randn(150, 2, 32).astype(np.float32) for _ in range(2))
    cot = rng.randn(100, 2, 32).astype(np.float32)
    assert not TF._unpadded_kernel_route(32, cq, ck, 0.1, 0.0, True)
    ref = _jax(JF.flash_attn_unpadded, (q, k, v), cot, paddle.to_tensor(cq),
               paddle.to_tensor(ck), scale=0.1, causal=causal)
    got = _port(TF.flash_attn_unpadded, (q, k, v), cot, cq, ck, scale=0.1,
                causal=causal)
    _close(got, ref)


def test_qkvpacked_matches_jax():
    cu = np.array([0, 60, 130, 200], np.int32)
    rng = np.random.RandomState(3)
    qkv = rng.randn(200, 3, 2, 64).astype(np.float32)
    cot = rng.randn(200, 2, 64).astype(np.float32)
    ref = _jax(JF.flash_attn_varlen_qkvpacked, (qkv,), cot,
               paddle.to_tensor(cu), paddle.to_tensor(cu), causal=True)
    got = _port(TF.flash_attn_varlen_qkvpacked, (qkv,), cot,
                torch.tensor(cu), torch.tensor(cu), causal=True)
    _close(got, ref)


def test_eval_ignores_dropout():
    """training=False keeps the kernel route and drops nothing."""
    cu = np.array([0, 50, 120], np.int32)
    q, k, v, cot = _inputs(120, seed=4)
    assert TF._unpadded_kernel_route(64, cu, cu, None, 0.5, False)
    ref = _jax(JF.flash_attn_unpadded, (q, k, v), cot, paddle.to_tensor(cu),
               paddle.to_tensor(cu), dropout=0.5, causal=True,
               training=False)
    got = _port(TF.flash_attn_unpadded, (q, k, v), cot, cu, cu,
                dropout=0.5, causal=True, training=False)
    _close(got, ref)
    plain = _port(TF.flash_attn_unpadded, (q, k, v), cot, cu, cu,
                  causal=True)
    np.testing.assert_array_equal(got[0], plain[0])


def test_dropout_takes_per_segment_route_and_repeats_under_a_seed():
    cu = np.array([0, 50, 120], np.int32)
    q, k, v, _ = _inputs(120, seed=5)
    assert not TF._unpadded_kernel_route(64, cu, cu, None, 0.3, True)
    t = [torch.tensor(a) for a in (q, k, v)]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TF.flash_attn_unpadded(*t, cu, cu, dropout=0.3, causal=True,
                                      generator=g)[0]

    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    nodrop = TF.flash_attn_unpadded(*t, cu, cu, causal=True)[0]
    assert not torch.allclose(a, nodrop)
    # dropout scales by 1 / (1 - p): with every bit kept it is the
    # per-segment route without dropout
    keep = TF.flash_attn_unpadded(*t, cu, cu, scale=64 ** -0.5,
                                  causal=True)[0]
    np.testing.assert_allclose(keep.numpy(), nodrop.numpy(), atol=TOL,
                               rtol=TOL)


def test_cpu_path_launches_no_kernel():
    cu = np.array([0, 100, 200], np.int32)
    q, k, v, cot = _inputs(200, seed=6)
    reset_launch_counts()
    _port(TF.flash_attn_unpadded, (q, k, v), cot, cu, cu, causal=True)
    assert all(n == 0 for n in launch_counts().values())
