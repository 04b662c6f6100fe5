"""The port's varlen flash-attention forward (paddle_tpu_torch.ops.kernels.
varlen_attention) against the JAX reference on the CPU: the Pallas kernel
``_vfa_forward`` run in interpret mode (PT_PALLAS_INTERPRET=1, O and LSE)
and the dense ``_varlen_ref``. On the CPU the port's wrapper takes its
plain version; the CUDA kernel is held against that on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.

Tolerance 1e-5 in f32: the same f32 arithmetic with sums in another order
(the online softmax against a dense softmax). Rows with no valid key
(padding) must agree with the kernel too: a finite uniform average of V
over the keys the TPU kernel visits.

Each test runs PyTorch on one intra-op thread, restored afterwards. In a
fresh process with two or more threads, the first float exp after MKL's
first GEMM sometimes computes one OpenMP thread's share with a
low-accuracy exp: relative error up to 1.5e-4 (median 4.8e-5) over that
thread's rows, while every later exp in the process agrees bit for bit
with MKL VML's high-accuracy exp. The plain version's LSE then moved by
4.9e-5 on one head and failed this comparison when its first case was the
first exp of a test worker (the worker's earlier files ran only JAX). In
separate processes under load: 3-5 of 30 such first calls on two threads,
none on one thread, and none once any exp has run before.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import varlen_attention as JV

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.kernels import varlen_attention as TV

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    # per-test env set, as tests/test_varlen_attention.py does, and one
    # PyTorch thread (see the module docstring); both restored
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


def _case(lens, total, h=2, hkv=2, d=64, seed=0):
    rng = np.random.RandomState(seed)
    cu = np.concatenate([[0], np.cumsum(lens)])
    seg = TV.segment_ids_from_cu_seqlens(cu, total)
    q = rng.randn(1, h, total, d).astype(np.float32)
    k = rng.randn(1, hkv, total, d).astype(np.float32)
    v = rng.randn(1, hkv, total, d).astype(np.float32)
    return q, k, v, seg[None]


def _port(q, k, v, segq, segk, causal):
    o, lse = TV.varlen_flash_attention_packed(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(segq), torch.tensor(segk), is_causal=causal)
    return o.numpy(), lse.numpy()


def _rep(a, g):
    return np.repeat(a, g, axis=1)


@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("total", [256, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernel_interpret(causal, total, gqa):
    lens = [37, 100, 64] if total == 256 else [17, 200, 30, 5]
    q, k, v, seg = _case(lens, total, h=2, hkv=2 // gqa)
    blk = JV._vfa_block(total)
    oj, lj = JV._vfa_forward(jnp.asarray(q), jnp.asarray(_rep(k, gqa)),
                             jnp.asarray(_rep(v, gqa)), jnp.asarray(seg),
                             jnp.asarray(seg), causal, blk, blk)
    ot, lt = _port(q, k, v, seg, seg, causal)
    assert (seg < 0).any()                     # a padding tail
    np.testing.assert_allclose(ot, np.asarray(oj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lt, np.asarray(lj), atol=TOL, rtol=TOL)
    assert np.isfinite(ot).all()


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_match_kernel(causal):
    """Query segment 1 finds no key (its keys are relabelled): its rows,
    like the padding rows, average V uniformly as the kernel does."""
    q, k, v, seg = _case([60, 70, 100], 256, seed=3)
    segk = seg.copy()
    segk[segk == 1] = 9
    oj, lj = JV._vfa_forward(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(seg),
                             jnp.asarray(segk), causal, 256, 256)
    ot, lt = _port(q, k, v, seg, segk, causal)
    rows = seg[0] == 1
    assert rows.sum() == 70
    np.testing.assert_allclose(ot, np.asarray(oj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lt, np.asarray(lj), atol=TOL, rtol=TOL)
    # one 256-key block: the kernel visits every key, causal or not
    got = ot[0][:, rows]                                  # [H, 70, D]
    expect = v[0].mean(axis=1)[:, None, :]                # [H, 1, D]
    np.testing.assert_allclose(got, np.broadcast_to(expect, got.shape),
                               atol=TOL)


@pytest.mark.parametrize("total", [256, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_dense_reference(causal, total):
    """Against _varlen_ref on the rows with a valid key; at an unaligned
    length (200, no TPU block) the reference's own route is the dense
    path, so every row, padding included, must agree."""
    q, k, v, seg = _case([37, 100, 40], total, seed=1)
    oj = np.asarray(JV._varlen_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(seg),
                                   jnp.asarray(seg), causal))
    ot, _ = _port(q, k, v, seg, seg, causal)
    live = seg[0] >= 0
    np.testing.assert_allclose(ot[:, :, live], oj[:, :, live], atol=TOL,
                               rtol=TOL)
    if total == 200 or not causal:
        np.testing.assert_allclose(ot, oj, atol=TOL, rtol=TOL)
    routed = np.asarray(JV.varlen_flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), is_causal=causal))
    np.testing.assert_allclose(ot, routed, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_many_short_documents_and_padding_in_a_live_block(causal):
    """The layout the CUDA kernel's segment-range tile skip meets most:
    15 documents of 40 tokens in 640 (the TPU block is 128, so a 128-row
    query block spans several documents and most key tiles lie across
    them), and a padding tail of 40 rows inside the last block, beside 88
    live rows. The plain version the card holds the kernel to must equal
    _vfa_kernel here, the padding rows' uniform average over the keys that
    kernel visits included."""
    q, k, v, seg = _case([40] * 15, 640, seed=6)
    blk = JV._vfa_block(640)
    assert blk == 128
    oj, lj = JV._vfa_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(seg), jnp.asarray(seg), causal, blk,
                             blk)
    ot, lt = _port(q, k, v, seg, seg, causal)
    pad = seg[0] < 0
    assert pad.sum() == 40 and not pad[:600].any()
    np.testing.assert_allclose(ot, np.asarray(oj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lt, np.asarray(lj), atol=TOL, rtol=TOL)
    # the padding rows average V over every key the TPU kernel visits: all
    # 640 (its last query block's causal bound is the whole axis)
    expect = v[0].mean(axis=1)[:, None, :]
    got = ot[0][:, pad]
    np.testing.assert_allclose(got, np.broadcast_to(expect, got.shape),
                               atol=TOL)


@pytest.mark.parametrize("total", [10, 128, 130])
def test_segment_ids_from_cu_seqlens(total):
    cu = np.array([0, 3, 3, 9, 10])
    np.testing.assert_array_equal(
        TV.segment_ids_from_cu_seqlens(cu, total),
        JV.segment_ids_from_cu_seqlens(cu, total))


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    q, k, v, seg = _case([5, 9], 16, seed=4)
    _port(q, k, v, seg, seg, True)
    assert launch_counts()["varlen_attention_fwd"] == 0

