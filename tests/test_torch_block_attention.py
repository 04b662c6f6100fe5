"""The port's block_multihead_attention (paddle_tpu_torch.incubate.nn.
functional) against the JAX reference on stacked [L, pool] caches with GQA
and interleaved RoPE, on the CPU in f32: a decode + chunked-prefill step
(the page-gather route) and a fresh-prefill step (the varlen route, JAX's
Pallas kernel in interpret mode). Outputs and both updated caches must
agree to 1e-5: the same f32 arithmetic with sums in another order.

The padding rows stay within one page (fewer than block_size tokens), so
no two tokens write one cache slot and every page is comparable.
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
L, NB, HQ, HKV, BS, D, MB = 2, 24, 4, 2, 8, 64, 6


@pytest.fixture(autouse=True)
def _interpret_mode():
    # one PyTorch thread while the test runs, restored after: in a fresh
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


def _rope(B1, max_seq):
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) * 2.0 / D))
    ang = np.arange(max_seq, dtype=np.float32)[:, None] * inv
    cs = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(
        cs[:, None, None], (2, B1, 1, max_seq, half)))


def _inputs(rows, n_pad, seed):
    """rows: [(n_tokens, start_pos, pages)]; the last batch row is the
    trash row holding n_pad padding tokens."""
    rng = np.random.RandomState(seed)
    B1 = len(rows) + 1
    enc = np.zeros(B1, np.int64)
    dec = np.zeros(B1, np.int64)
    this = np.zeros(B1, np.int64)
    bt = np.zeros((B1, MB), np.int64)
    for i, (n, start, pages) in enumerate(rows):
        dec[i], this[i] = start, n
        bt[i, :len(pages)] = pages
    this[-1] = enc[-1] = n_pad
    cu = np.zeros(B1 + 1, np.int64)
    cu[1:] = np.cumsum(this)
    T = int(cu[-1])
    qkv = rng.randn(T, (HQ + 2 * HKV) * D).astype(np.float32)
    kc = rng.randn(L, NB, HKV, BS, D).astype(np.float32)
    vc = rng.randn(L, NB, HKV, BS, D).astype(np.float32)
    return qkv, kc, vc, enc, dec, this, cu, bt, _rope(B1, MB * BS)


def _run_both(ins, layer, fresh):
    qkv, kc, vc, enc, dec, this, cu, bt, rope = ins
    pt = paddle.to_tensor
    jo = JF.block_multihead_attention(
        pt(qkv), pt(kc), pt(vc), pt(enc), pt(dec), pt(this), None, None,
        pt(cu), None, pt(bt), rope_emb=pt(rope), layer_idx=layer,
        max_seq_len=MB * BS, block_size=BS, fresh_prefill=fresh)
    j_out, _, j_kc, j_vc = [np.asarray(t.numpy()) for t in jo]
    kc_t, vc_t = torch.tensor(kc), torch.tensor(vc)
    t_out, _, t_kc, t_vc = TF.block_multihead_attention(
        torch.tensor(qkv), kc_t, vc_t, torch.tensor(enc),
        torch.tensor(dec), torch.tensor(this), torch.tensor(cu),
        torch.tensor(bt), rope_emb=torch.tensor(rope), layer_idx=layer,
        fresh_prefill=fresh)
    assert t_kc is kc_t and t_vc is vc_t          # updated in place
    return (j_out, j_kc, j_vc), (t_out.numpy(), kc_t.numpy(),
                                 vc_t.numpy())


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_and_chunk_step_matches_jax(layer):
    # row 0 decodes at position 13, row 1 appends 9 tokens at position 20
    # (crossing a page), row 2 decodes at position 0 of a fresh page
    rows = [(1, 13, [3, 4]), (9, 20, [5, 6, 7, 8]), (1, 0, [9])]
    (jo, jk, jv), (to, tk, tv) = _run_both(_inputs(rows, 5, layer), layer,
                                           False)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk, jk, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_fresh_prefill_step_matches_jax(layer):
    # 128 packed tokens (the TPU kernel's block): three prompts from
    # position 0 and a 7-token padding tail in the trash row
    rows = [(40, 0, [3, 4, 5, 6, 7]), (33, 0, [8, 9, 10, 11, 12]),
            (48, 0, [13, 14, 15, 16, 17, 18])]
    reset_launch_counts()
    (jo, jk, jv), (to, tk, tv) = _run_both(_inputs(rows, 7, 10 + layer),
                                           layer, True)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk, jk, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=TOL)
    assert launch_counts()["varlen_attention_fwd"] == 0     # CPU path


def test_swiglu_matches_jax():
    rng = np.random.RandomState(2)
    a = rng.randn(5, 16).astype(np.float32)
    b = rng.randn(5, 16).astype(np.float32)
    ref = JF.swiglu(paddle.to_tensor(a), paddle.to_tensor(b)).numpy()
    got = TF.swiglu(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    ab = np.concatenate([a, b], axis=-1)
    np.testing.assert_allclose(TF.swiglu(torch.tensor(ab)).numpy(), ref,
                               atol=1e-6, rtol=1e-6)


def test_block_attention_refusals():
    # the int8 path is ported (tests/test_torch_kv_int8.py); what stays
    # refused is what the reference refuses (functional/__init__.py:
    # 602-614): the int8 mode without its scale pools, static per-tensor
    # scales, pre_key_cache and explicit masks
    ins = _inputs([(1, 3, [3])], 1, 0)
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    scales = torch.zeros(kc.shape[:-1])
    args = (qkv, kc, vc, enc, dec, this, cu, bt, rope)
    with pytest.raises(ValueError, match="scale pools"):
        TF.block_multihead_attention(*args, layer_idx=0,
                                     use_dynamic_cachekv_quant=True)
    for kw, err in ((dict(cache_k_quant_scales=scales), NotImplementedError),
                    (dict(pre_key_cache=kc), NotImplementedError),
                    (dict(mask=qkv), NotImplementedError),
                    (dict(tgt_mask=qkv), NotImplementedError)):
        with pytest.raises(err):
            TF.block_multihead_attention(*args, layer_idx=0, **kw)
