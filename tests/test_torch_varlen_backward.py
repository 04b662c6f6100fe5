"""The port's varlen flash-attention backward (paddle_tpu_torch.ops.kernels.
varlen_attention: ``_varlen_bwd_ref``, ``_VarlenAttention`` and the
differentiable entry ``varlen_flash_attention``) against the JAX package
on the CPU: the Pallas backward ``_vfa_backward`` run in interpret mode
(PT_PALLAS_INTERPRET=1, per test, restored afterwards) and ``jax.grad`` of
the reference's dense route. On the CPU the port's wrappers take their
plain versions; the CUDA kernels are held against those on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.

Tolerances, f32: dQ, dK, dV within 1e-4 (GRAD_TOL) absolute and relative
(the same f32 arithmetic, blockwise against dense sums); O 1e-5 (TOL). In
bf16, both sides round P to dO's dtype and dS to Q's before their
products and round the results to bf16; their f32 sums run in other
orders, which can move a rounding to its neighbour: 2**-6 * (|ref| + the
RMS of ref's row) + 1e-5 element by element, as on the card.

Each test runs PyTorch on one intra-op thread, restored afterwards (see
tests/test_torch_varlen_attention.py: the first float exp after MKL's
first GEMM on two or more threads can run at low accuracy).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import varlen_attention as JV

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.kernels import varlen_attention as TV
from paddle_tpu_torch.utils.convert import tensor_from_numpy

TOL = 1e-5
GRAD_TOL = 1e-4
BF16_RTOL, BF16_FLOOR = 2.0 ** -6, 1e-5


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


def _case(lens, total, h=2, d=64, seed=0, relabel=True):
    """q, k, v, dO [1, h, total, d] f32, and segment ids [1, total] for
    queries and keys. With ``relabel`` query segment 1 finds no key (its
    keys carry another id), besides the padding tail past sum(lens)."""
    rng = np.random.RandomState(seed)
    cu = np.concatenate([[0], np.cumsum(lens)])
    seg = TV.segment_ids_from_cu_seqlens(cu, total)[None]
    segk = seg.copy()
    if relabel:
        segk[segk == 1] = 9
    q, k, v, do = (rng.randn(1, h, total, d).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, seg, segk


def _worst_of_tol(got, ref, rtol, floor):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt(np.square(ref).mean(-1, keepdims=True))
    return float((np.abs(got - ref) / (rtol * (np.abs(ref) + rms)
                                       + floor)).max())


def _jax_kernel_route(q, k, v, do, seg, segk, causal, dtype=jnp.float32):
    """O, LSE from the Pallas forward and (dQ, dK, dV) from the Pallas
    backward, both in interpret mode at the reference's own blocks."""
    blk = JV._vfa_block(q.shape[2])
    qj, kj, vj, doj = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    sj, skj = jnp.asarray(seg), jnp.asarray(segk)
    o, lse = JV._vfa_forward(qj, kj, vj, sj, skj, causal, blk, blk)
    grads = JV._vfa_backward(qj, kj, vj, sj, skj, o, lse, doj, causal,
                             blk, blk)
    return o, lse, grads


@pytest.mark.parametrize("total", [256, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_pallas_interpret(causal, total):
    """The plain backward and the autograd Function against
    ``_vfa_backward``: a padding tail, and a query segment whose keys all
    carry another id (no valid key: zero dQ, and its keys zero dK/dV)."""
    lens = [37, 100, 64] if total == 256 else [17, 200, 30, 5]
    q, k, v, do, seg, segk = _case(lens, total)
    oj, lj, gj = _jax_kernel_route(q, k, v, do, seg, segk, causal)
    gj = [np.asarray(g) for g in gj]

    plain = TV._varlen_bwd_ref(*(torch.tensor(a) for a in (q, k, v)),
                               torch.tensor(seg), torch.tensor(segk),
                               tensor_from_numpy(oj), tensor_from_numpy(lj),
                               torch.tensor(do), causal)
    for got, want in zip(plain, gj):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = TV._VarlenAttention.apply(qt, kt, vt, torch.tensor(seg),
                                  torch.tensor(segk), causal)
    o.backward(torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(oj),
                               atol=TOL, rtol=TOL)
    for t, want in zip((qt, kt, vt), gj):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    dead_q = (seg[0] < 0) | (seg[0] == 1)
    dead_k = (segk[0] < 0) | (segk[0] == 9)
    assert dead_q.sum() > 0 and dead_k.sum() > 0
    assert (qt.grad.numpy()[:, :, dead_q] == 0).all()
    assert (kt.grad.numpy()[:, :, dead_k] == 0).all()
    assert (vt.grad.numpy()[:, :, dead_k] == 0).all()
    assert (gj[0][:, :, dead_q] == 0).all()       # the reference agrees


@pytest.mark.parametrize("causal", [True, False])
def test_backward_bf16_matches_pallas_interpret(causal):
    q, k, v, do, seg, segk = _case([37, 100, 64], 256, seed=5)
    oj, lj, gj = _jax_kernel_route(q, k, v, do, seg, segk, causal,
                                   jnp.bfloat16)
    bf = [tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)))
          for a in (q, k, v, do)]
    got = TV._varlen_bwd_ref(bf[0], bf[1], bf[2], torch.tensor(seg),
                             torch.tensor(segk), tensor_from_numpy(oj),
                             tensor_from_numpy(lj), bf[3], causal)
    for g, want in zip(got, gj):
        assert g.dtype == torch.bfloat16
        ref = np.asarray(want.astype(jnp.float32))
        assert _worst_of_tol(g.float().numpy(), ref, BF16_RTOL,
                             BF16_FLOOR) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_dense_route_matches_jax_grad(causal):
    """At T=200 (no TPU block divides it) both packages take the dense
    route under plain autodiff. The cotangent is non-zero on padding rows:
    their uniform average of V sends dO / T to every key's dV."""
    q, k, v, do, seg, _ = _case([37, 100, 40], 200, seed=1, relabel=False)
    assert (seg < 0).sum() == 23

    def loss(q, k, v):
        o = JV.varlen_flash_attention_packed(q, k, v, jnp.asarray(seg),
                                             jnp.asarray(seg), causal)
        return (o * jnp.asarray(do)).sum()

    oj = JV.varlen_flash_attention_packed(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(seg),
        jnp.asarray(seg), causal)
    gj = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = TV.varlen_flash_attention(qt, kt, vt, torch.tensor(seg),
                                  torch.tensor(seg), is_causal=causal)
    o.backward(torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(oj),
                               atol=TOL, rtol=TOL)
    for t, want in zip((qt, kt, vt), gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    # the padding rows' share: dO summed over them, over T, on every key
    pad = seg[0] < 0
    share = do[0][:, pad].sum(axis=1) / 200.0            # [H, D]
    live_free = vt.grad.numpy()[0][:, pad]               # padding keys
    np.testing.assert_allclose(live_free,
                               np.broadcast_to(share[:, None, :],
                                               live_free.shape),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_padding_keys_get_zero_gradient():
    """The port's side of tests/test_varlen_attention.py::
    test_varlen_padding_tokens_isolated: padding keys get exactly zero
    dK and dV, and wild values in the padding move no live output."""
    q, k, v, _, seg, _ = _case([50, 40], 128, seed=2, relabel=False)
    n = 90
    segt = torch.tensor(seg)
    kt = torch.tensor(k, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    o = TV.varlen_flash_attention(torch.tensor(q), kt, vt, segt, segt,
                                  is_causal=True)
    (o[:, :, :n] ** 2).sum().backward()
    assert (kt.grad[:, :, n:] == 0).all() and (vt.grad[:, :, n:] == 0).all()
    assert kt.grad[:, :, :n].abs().max() > 0
    q2, k2, v2 = q.copy(), k.copy(), v.copy()
    q2[:, :, n:], k2[:, :, n:], v2[:, :, n:] = 99.0, -77.0, 55.0
    o2 = TV.varlen_flash_attention(*(torch.tensor(a) for a in (q2, k2, v2)),
                                   segt, segt, is_causal=True)
    np.testing.assert_allclose(o2[:, :, :n].numpy(),
                               o[:, :, :n].detach().numpy(), atol=TOL,
                               rtol=TOL)


def test_routes_and_cpu_launches_no_kernel():
    reset_launch_counts()
    assert TV._kernel_route(256, 256, 64) and TV._kernel_route(384, 384, 128)
    assert not TV._kernel_route(200, 200, 64)
    assert not TV._kernel_route(256, 256, 96)
    q, k, v, do, seg, _ = _case([60, 40], 128, relabel=False)
    qt = torch.tensor(q, requires_grad=True)
    o = TV.varlen_flash_attention(qt, torch.tensor(k), torch.tensor(v),
                                  torch.tensor(seg), torch.tensor(seg), True)
    o.backward(torch.tensor(do))
    assert all(n == 0 for n in launch_counts().values())


def test_gqa_raises_on_the_differentiable_entry():
    """H != HKV: the TPU kernels reshape k and v to [B*H, T, D] and its
    dense route's einsum needs equal heads, so neither takes it."""
    q = torch.zeros(1, 4, 128, 64)
    kv = torch.zeros(1, 2, 128, 64)
    seg = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="no GQA"):
        TV.varlen_flash_attention(q, kv, kv, seg, seg)
    with pytest.raises(ValueError, match="H == HKV"):
        TV._varlen_bwd_ref(q, kv, kv, seg, seg, q, torch.zeros(1, 4, 128),
                           q, False)


@pytest.mark.gpu
def test_gqa_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    dev = torch.device("cuda")
    q = torch.zeros(1, 4, 128, 64, device=dev)
    kv = torch.zeros(1, 2, 128, 64, device=dev)
    seg = torch.zeros(1, 128, dtype=torch.int32, device=dev)
    lse = torch.zeros(1, 4, 128, device=dev)
    with pytest.raises(ValueError, match="equal"):
        TV._launch_bwd(q, kv, kv, seg, seg, q, lse, q, True)
    with pytest.raises(ValueError):
        TV.varlen_flash_attention(q, kv, kv, seg, seg)
