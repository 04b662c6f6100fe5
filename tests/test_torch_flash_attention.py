"""The port's flash attention (paddle_tpu_torch.ops.kernels.flash_attention)
against the JAX package on the CPU: the Pallas kernels ``_pallas_forward``
and ``_pallas_backward`` run in interpret mode (PT_PALLAS_INTERPRET=1 per
test, restored afterwards), the dense fallback routes, and the public entry
points. On the CPU the port's wrappers take their plain versions; the CUDA
kernels are held against those on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.

Tolerances, f32: O and LSE 1e-5 (the same f32 arithmetic, summed in
another order: online softmax against a dense softmax); dQ, dK, dV 1e-4 of
the largest magnitude (blockwise against dense sums). On the dense fallback
routes O is held element by element to 1e-5 * (|ref| + the RMS of ref's
row over D) + 1e-6, the form of the card checks: a fully padded row there
sums V over hundreds of keys, so an element that cancels to near zero
carries the f32 rounding of the row's scale. The dropout keep mask is an
integer function and must match bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JF

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.kernels import flash_attention as FA

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    # the JAX side's Pallas kernels in interpret mode, restored after;
    # and one PyTorch thread while the test runs, restored after: in a fresh
    # process with two or more threads, the first float exp after MKL's
    # first GEMM sometimes computes one thread's share with a low-accuracy
    # exp (relative error up to 1.5e-4), which moves the plain versions'
    # softmax and LSE past the tolerance; see test_torch_varlen_attention.py
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


def _inputs(b, h, sq, d, sk=None, seed=0, bias=False):
    rng = np.random.RandomState(seed)
    sk = sk or sq
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    kmask = None
    if bias:
        kmask = np.zeros((b, sk), np.float32)
        kmask[0, sk // 3:] = -1e30        # padding past a third of the keys
        kmask[-1] = -1e30                 # a sequence with every key padded
    return q, k, v, do, kmask


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


def _port_grads(q, k, v, kmask, seed, causal, p, do):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    kmt = None if kmask is None else torch.tensor(kmask)
    o = FA._FlashAttention.apply(qt, kt, vt, kmt, seed, causal, p)
    o.backward(torch.tensor(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _close_to_row_scale(got, ref, tol=TOL, floor=1e-6):
    """|got - ref| <= tol * (|ref| + the RMS of ref's row over the last
    axis) + floor, element by element."""
    ref = np.asarray(ref)
    rms = np.sqrt(np.square(ref).mean(-1, keepdims=True))
    assert np.all(np.abs(got - ref) <= tol * (np.abs(ref) + rms) + floor)


def _close_grads(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0
        assert float(np.abs(g - r).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("variant", ["plain", "bias", "dropout"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 1024])
def test_matches_pallas_kernels_interpret(s, causal, variant):
    """S = 1024 gives two 512-blocks, so the causal bounds are crossed."""
    q, k, v, do, kmask = _inputs(2, 2, s, 64, seed=s,
                                 bias=variant == "bias")
    p = 0.2 if variant == "dropout" else 0.0
    seed = -123457 if p else 0
    blk = min(512, s)
    qj, kj, vj, dj, kmj = _j(q, k, v, do, kmask)
    sj = jnp.asarray([seed], jnp.int32)
    oj, lj = JF._pallas_forward(qj, kj, vj, kmj, sj, causal, p, blk, blk)
    gj = JF._pallas_backward(qj, kj, vj, kmj, sj, oj, lj, dj, causal, p,
                             blk, blk)
    ot, lt = FA.forward_with_lse(*_t(q, k, v, kmask), seed, causal, p)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                               rtol=TOL)
    o2, gt = _port_grads(q, k, v, kmask, seed, causal, p, do)
    np.testing.assert_array_equal(o2, ot.numpy())
    _close_grads(gt, gj)
    if variant == "bias":
        # every key of the last sequence is padded: its rows average V
        # over keys 0..row (causal) or over all keys
        vl = v[-1]
        cnt = np.arange(1, s + 1)[:, None] if causal else s
        expect = (np.cumsum(vl, axis=1) / cnt if causal
                  else np.broadcast_to(vl.mean(axis=1, keepdims=True),
                                       vl.shape))
        np.testing.assert_allclose(ot.numpy()[-1], expect, atol=1e-4)


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5, 0.9])
def test_hash_keep_mask_bit_for_bit(p):
    b, h, sq, sk = 2, 3, 96, 160
    for seed in (0, 7, -1, 2 ** 31 - 1, -2 ** 31, 123456789):
        ref = np.asarray(JF._full_keep_mask(
            jnp.asarray([seed], jnp.int32), b, h, sq, sk, p,
            q_offset=512, k_offset=1024))
        got = FA._full_keep_mask(seed, b, h, sq, sk, p, "cpu",
                                 q_offset=512, k_offset=1024).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.mean() < 1
    # positions near 2**31 and every bh: the int64 arithmetic masked to 32
    # bits wraps as the TPU package's uint32 arithmetic does
    qi = np.array([0, 1, 2 ** 31 - 1, 2 ** 30 + 7], np.int32)[:, None]
    ki = np.array([3, 2 ** 31 - 2, 65535, 65536], np.int32)[None, :]
    thresh = JF._dropout_threshold(p)
    for bh in (0, 5, 2 ** 31 - 1):
        ref = np.asarray(JF._hash_keep(
            jnp.uint32(99), jnp.uint32(bh), jnp.asarray(qi),
            jnp.asarray(ki), thresh))
        got = FA._hash_keep(99, torch.tensor(bh), torch.tensor(qi).long(),
                            torch.tensor(ki).long(),
                            FA._dropout_threshold(p)).numpy()
        np.testing.assert_array_equal(got, ref)
    assert FA._dropout_threshold(p) == int(thresh)


@pytest.mark.parametrize("sq,sk,causal,bias", [
    (200, 200, True, False), (200, 200, False, True),
    (128, 256, True, False), (256, 384, True, True)])
def test_fallback_routes_match_reference(sq, sk, causal, bias):
    """Shapes the TPU kernel does not take: the reference's dense route
    (causal bottom-right aligned when Sq != Sk) and its scan backward."""
    q, k, v, do, kmask = _inputs(2, 2, sq, 64, sk=sk, seed=sq + sk,
                                 bias=bias)
    qj, kj, vj, dj, kmj = _j(q, k, v, do, kmask)
    sj = jnp.zeros((1,), jnp.int32)
    assert not JF._pallas_ok(qj, kj, causal, min(512, sq), min(512, sk))
    assert not FA._kernel_ok(torch.tensor(q), torch.tensor(k), causal)
    oj, lj = JF._forward_with_lse(qj, kj, vj, kmj, sj, causal, 0.0)
    ot, lt = FA.forward_with_lse(*_t(q, k, v, kmask), 0, causal, 0.0)
    _close_to_row_scale(ot.numpy(), oj)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                               rtol=TOL)

    def f(a, b_, c):
        return JF._flash_attention(a, b_, c, kmj, sj, causal, 0.0)
    _, vjp = jax.vjp(f, qj, kj, vj)
    gj = vjp(dj)
    _, gt = _port_grads(q, k, v, kmask, 0, causal, 0.0, do)
    _close_grads(gt, gj)


@pytest.mark.parametrize("mask_kind", ["none", "bool_padding",
                                       "float_padding", "generic"])
@pytest.mark.parametrize("causal", [True, False])
def test_public_entry_points_match(mask_kind, causal):
    b, s, h, d = 2, 256, 2, 64
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    mask = None
    if mask_kind == "bool_padding":
        mask = np.ones((b, 1, 1, s), bool)
        mask[1, ..., 200:] = False
    elif mask_kind == "float_padding":
        mask = np.zeros((1, 1, 1, s), np.float32)
        mask[..., 17:40] = -np.inf
    elif mask_kind == "generic":
        mask = rng.rand(b, h, s, s) > 0.3
        mask[..., 0] = True
    oj = JF.flash_attention_bshd(*_j(q, k, v, mask), is_causal=causal)
    ot = FA.flash_attention_bshd(*_t(q, k, v, mask), is_causal=causal)
    assert ot.shape == (b, s, h, d)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL,
                               rtol=TOL)


def test_dropout_entry_point_draws_its_seed_from_the_generator():
    q = torch.randn(1, 256, 2, 64)
    a = FA.flash_attention_bshd(q, q, q, dropout_p=0.3,
                                generator=torch.Generator().manual_seed(5))
    b = FA.flash_attention_bshd(q, q, q, dropout_p=0.3,
                                generator=torch.Generator().manual_seed(5))
    c = FA.flash_attention_bshd(q, q, q, dropout_p=0.3,
                                generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    seed = FA.seed_from_generator(torch.Generator().manual_seed(5))
    assert -2 ** 31 <= seed < 2 ** 31
    ref = FA._FlashAttention.apply(*(t.transpose(1, 2) for t in (q, q, q)),
                                   None, seed, False, 0.3).transpose(1, 2)
    assert torch.equal(a, ref)


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    q, k, v, do, _ = _inputs(1, 1, 128, 64, seed=9)
    _port_grads(q, k, v, None, 0, True, 0.0, do)
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_bwd_dkv"] == 0
    assert counts["flash_attention_bwd_dq"] == 0
