"""The port's paged attention (the plain version of the paged-attention
kernel, ops/kernels/paged_attention.py, reached through
incubate.nn.functional.block_multihead_attention's decode and
chunked-prefill route) against the JAX reference's non-fresh route
(paddle_tpu/incubate/nn/functional/__init__.py:733-761), on the CPU, with
GQA (4 query heads over 2 kv heads of 16) on stacked [L, pool] caches.

The step mixes a decode row, a chunk crossing a page, a row at position 0,
a row at the last slot of a page, and a padding tail in the trash row that
runs past max_seq (its positions reach 39 against max_seq 32; its page
index clamps, as the reference's gathers do). Live tokens' outputs and
every page but the trash page 0 must agree: in f32 to 1e-5 (the same
arithmetic, sums in another order); in bf16 each element within
2**-6 * (|ref| + the RMS of ref's row) + 1e-5 (both round P to bf16 after
normalising and the output to bf16, from f32 sums taken in other orders).
The trash page and the padding tokens' outputs are not compared: padding
tokens past max_seq write the same trash slots twice, in an order neither
framework fixes.

The per-step metadata (``paged_metadata``, hoisted out of the layers by
the model) must give the same bits as the function's own.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JF

from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.ops.kernels import paged_attention as PA

L, NB, HQ, HKV, BS, D, MB = 2, 20, 4, 2, 8, 16, 4
MAX_SEQ = MB * BS
# (tokens, start position, pages): decode at 13; 9 tokens from 20 (pages
# 2 and 3 of the row); position 0; the last slot (7) of a page
ROWS = [(1, 13, [3, 4]), (9, 20, [5, 6, 7, 8]), (1, 0, [9]), (1, 7, [10])]
N_PAD = MAX_SEQ + 8                   # trash-row positions 0..39


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while the test runs, restored after: in a fresh
    # process with two or more threads, the first float exp after MKL's
    # first GEMM sometimes computes one thread's share with a low-accuracy
    # exp (relative error up to 1.5e-4); see test_torch_varlen_attention.py
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rope(B1):
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) * 2.0 / D))
    ang = np.arange(MAX_SEQ, dtype=np.float32)[:, None] * inv
    cs = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(
        cs[:, None, None], (2, B1, 1, MAX_SEQ, half)))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    B1 = len(ROWS) + 1
    enc = np.zeros(B1, np.int64)
    dec = np.zeros(B1, np.int64)
    this = np.zeros(B1, np.int64)
    bt = np.zeros((B1, MB), np.int64)
    for i, (n, start, pages) in enumerate(ROWS):
        dec[i], this[i] = start, n
        bt[i, :len(pages)] = pages
    this[-1] = enc[-1] = N_PAD
    cu = np.zeros(B1 + 1, np.int64)
    cu[1:] = np.cumsum(this)
    T = int(cu[-1])
    qkv = rng.randn(T, (HQ + 2 * HKV) * D).astype(np.float32)
    kc = rng.randn(L, NB, HKV, BS, D).astype(np.float32)
    vc = rng.randn(L, NB, HKV, BS, D).astype(np.float32)
    return qkv, kc, vc, enc, dec, this, cu, bt, _rope(B1)


def _torch_step(ins, layer, dtype, metadata=False):
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    qkv, kc, vc = qkv.to(dtype), kc.to(dtype), vc.to(dtype)
    md = None
    if metadata:
        md = TF.paged_metadata(qkv.shape[0], enc, dec, cu, bt, BS, rope)
    out, _, kc2, vc2 = TF.block_multihead_attention(
        qkv, kc, vc, enc, dec, this, cu, bt, rope, layer_idx=layer,
        metadata=md)
    assert kc2 is kc and vc2 is vc                  # updated in place
    return out, kc, vc


def _jax_step(ins, layer, dtype):
    qkv, kc, vc, enc, dec, this, cu, bt, rope = ins
    jd = "bfloat16" if dtype == torch.bfloat16 else "float32"
    pt = paddle.to_tensor
    jo = JF.block_multihead_attention(
        pt(qkv).astype(jd), pt(kc).astype(jd), pt(vc).astype(jd), pt(enc),
        pt(dec), pt(this), None, None, pt(cu), None, pt(bt),
        rope_emb=pt(rope), layer_idx=layer, max_seq_len=MAX_SEQ,
        block_size=BS)
    return [torch.tensor(np.asarray(t.astype("float32").numpy()))
            for t in (jo[0], jo[2], jo[3])]


def _worst_of_tol(got, ref, rtol, floor):
    got, ref = got.float(), ref.float()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    return float(((got - ref).abs()
                  / (rtol * (ref.abs() + rms) + floor)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_version_matches_jax_non_fresh_route(layer, dtype):
    ins = _inputs(layer)
    out, kc, vc = _torch_step(ins, layer, dtype)
    j_out, j_kc, j_vc = _jax_step(ins, layer, dtype)
    live = int(ins[6][-2])                  # tokens before the trash row
    assert out.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(out[:live].numpy(), j_out[:live].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(kc[:, 1:].numpy(), j_kc[:, 1:].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(vc[:, 1:].numpy(), j_vc[:, 1:].numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        o = out[:live].float().reshape(live, HQ, D)
        jo = j_out[:live].reshape(live, HQ, D)
        assert _worst_of_tol(o, jo, 2.0 ** -6, 1e-5) <= 1.0
        # the pages hold RoPE'd K and V rounded to bf16 on both sides
        assert _worst_of_tol(kc[:, 1:], j_kc[:, 1:], 2.0 ** -7, 0) <= 1.0
        assert torch.equal(vc[:, 1:].float(), j_vc[:, 1:])


# Serving steps that run the paged route with several tokens a row, at
# block size 8 and 16 blocks a row (max_seq 128): a speculative verify step
# (ServingEngine._spec_step: each row's tip and k = 4 drafts, the step
# padded to a power of two, 32 tokens, by the trash row), and a prefix-cache
# hit (a 20-token suffix after a 96-token cached prefix) beside a decode
# row. (rows [(tokens, start position)], trash-row padding tokens)
SERVING_BS, SERVING_MB = 8, 16
SERVING_SHAPES = {
    "verify": ([(5, 9), (5, 40), (5, 63), (5, 90)], 12),
    "prefix_hit": ([(20, 96), (1, 57)], 0),
}


def _serving_inputs(rows, n_pad, seed):
    rng = np.random.RandomState(seed)
    max_seq = SERVING_BS * SERVING_MB
    B1 = len(rows) + 1
    nb = 1 + len(rows) * SERVING_MB
    enc = np.zeros(B1, np.int64)
    dec = np.zeros(B1, np.int64)
    this = np.zeros(B1, np.int64)
    bt = np.zeros((B1, SERVING_MB), np.int64)
    pages = rng.permutation(nb - 1) + 1
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        bt[i] = pages[i * SERVING_MB:(i + 1) * SERVING_MB]
    this[-1] = enc[-1] = n_pad
    cu = np.zeros(B1 + 1, np.int64)
    cu[1:] = np.cumsum(this)
    T = int(cu[-1])
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) * 2.0 / D))
    ang = np.arange(max_seq, dtype=np.float32)[:, None] * inv
    cs = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    rope = np.ascontiguousarray(np.broadcast_to(
        cs[:, None, None], (2, B1, 1, max_seq, half)))
    qkv = rng.randn(T, (HQ + 2 * HKV) * D).astype(np.float32)
    kc = rng.randn(L, nb, HKV, SERVING_BS, D).astype(np.float32)
    vc = rng.randn(L, nb, HKV, SERVING_BS, D).astype(np.float32)
    return qkv, kc, vc, enc, dec, this, cu, bt, rope


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SERVING_SHAPES))
def test_plain_version_matches_jax_at_serving_shapes(shape, dtype):
    """The verify and prefix-hit steps: the port's route (RoPE, the page
    scatter, then the plain version of the paged kernel) against the JAX
    reference's non-fresh route, live tokens and every page but the trash
    page, to the tolerances of the module docstring."""
    rows, n_pad = SERVING_SHAPES[shape]
    ins = _serving_inputs(rows, n_pad, seed=len(rows))
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    qkv, kc, vc = qkv.to(dtype), kc.to(dtype), vc.to(dtype)
    out, _, kc, vc = TF.block_multihead_attention(
        qkv, kc, vc, enc, dec, this, cu, bt, rope, layer_idx=1)
    jd = "bfloat16" if dtype == torch.bfloat16 else "float32"
    pt = paddle.to_tensor
    a = ins
    jo = JF.block_multihead_attention(
        pt(a[0]).astype(jd), pt(a[1]).astype(jd), pt(a[2]).astype(jd),
        pt(a[3]), pt(a[4]), pt(a[5]), None, None, pt(a[6]), None, pt(a[7]),
        rope_emb=pt(a[8]), layer_idx=1, max_seq_len=SERVING_BS * SERVING_MB,
        block_size=SERVING_BS)
    j_out, j_kc, j_vc = [torch.tensor(np.asarray(t.astype("float32")
                                                 .numpy()))
                         for t in (jo[0], jo[2], jo[3])]
    live = int(a[6][-2])                    # tokens before the trash row
    o = out[:live].float().reshape(live, HQ, D)
    jout = j_out[:live].reshape(live, HQ, D)
    if dtype == torch.float32:
        np.testing.assert_allclose(o.numpy(), jout.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(kc[:, 1:].numpy(), j_kc[:, 1:].numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert _worst_of_tol(o, jout, 2.0 ** -6, 1e-5) <= 1.0
        assert _worst_of_tol(kc[:, 1:], j_kc[:, 1:], 2.0 ** -7, 0) <= 1.0
    assert torch.equal(vc[:, 1:].float(), j_vc[:, 1:].to(vc.dtype).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_hoisted_metadata_gives_the_same_bits(dtype):
    ins = _inputs(3)
    for layer in (0, 1):
        a = _torch_step(ins, layer, dtype, metadata=False)
        b = _torch_step(ins, layer, dtype, metadata=True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_plain_version_is_the_functions_route():
    """The function's decode route is the plain version of the kernel on
    the layer's pools, after RoPE and the page scatter."""
    ins = _inputs(4)
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    md = TF.paged_metadata(qkv.shape[0], enc, dec, cu, bt, BS, rope)
    out, _, kc, vc = TF.block_multihead_attention(
        qkv, kc, vc, enc, dec, this, cu, bt, rope, layer_idx=1,
        metadata=md)
    q = TF._rope(qkv[:, :HQ * D].reshape(-1, HQ, D), md.cos, md.sin)
    ref = PA._paged_attention_ref(q, kc[1], vc[1], md.t2b, md.pos, bt)
    assert torch.equal(out, ref.reshape(out.shape))
    assert PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt) \
        .equal(ref)


def test_model_rope_table_stays_f32_when_cast():
    cfg = TS.PagedServingConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                num_heads=2, block_size=4,
                                max_blocks_per_seq=3)
    m = TS.PagedCausalLM(cfg, device="cpu")
    cpu = torch.device("cpu")
    want = torch.stack(m._rope_table(torch.arange(cfg.max_seq)))
    table = m.rope_cos_sin(cpu)
    assert torch.equal(table, want)
    assert m.rope_cos_sin(cpu) is table                # made once
    m = m.to(dtype=torch.bfloat16)
    assert m.rope_cos_sin(cpu).dtype == torch.float32
    assert torch.equal(m.rope_cos_sin(cpu), want)
    assert m.qkv[0].weight.dtype == torch.bfloat16
    assert not any("rope" in k for k in m.state_dict())


def test_model_refuses_block_tables_wider_than_its_config():
    cfg = TS.PagedServingConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                num_heads=2, block_size=4,
                                max_blocks_per_seq=3, num_blocks=8)
    m = TS.PagedCausalLM(cfg, device="cpu")
    kc = torch.zeros(1, cfg.num_blocks, cfg.num_kv_heads, cfg.block_size,
                     cfg.head_dim)
    z = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        m(torch.zeros(1, dtype=torch.int64), z, z, torch.tensor([1, 0]),
          torch.tensor([0, 1, 1]), torch.zeros(2, 4, dtype=torch.int64),
          kc, kc.clone())


class _Entries:
    """Stand-in for the kernel library's extension module: records each
    call's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def paged_attention(self, *args):
        self.calls.append(("paged_attention",) + args)
        return 0

    def paged_attention_int8(self, *args):
        self.calls.append(("paged_attention_int8",) + args)
        return 0


def test_kernel_call_checks_a_step_once(monkeypatch):
    """The kernel's wrapper validates a step's inputs (caches, scale pools,
    t2b, pos, block tables) once: later calls with the same objects and q
    of the same shape check only layer_idx, and pass each layer's pool
    pointers and the step's sizes; anything else is checked in full, and
    every refusal stands. CPU tensors through the launch path, the library
    replaced by a recorder."""
    entries = _Entries()
    checks = []
    check = PA._check
    monkeypatch.setattr(PA._build, "py_module", lambda: entries)
    monkeypatch.setattr(PA, "_check", lambda *a: checks.append(1) or
                        check(*a))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    monkeypatch.setattr(PA, "_step", None)
    ins = _inputs(5)
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    md = TF.paged_metadata(qkv.shape[0], enc, dec, cu, bt, BS, rope)
    q = qkv[:, :HQ * D].reshape(-1, HQ, D).to(torch.bfloat16).contiguous()
    for layer in (0, 1, 1):
        PA._launch(q.clone(), kc, vc, layer, md.t2b, md.pos, bt)
    assert len(checks) == 1 and len(entries.calls) == 3
    T = q.shape[0]
    layer_bytes = kc.stride(0) * kc.element_size()
    for (name, *args), layer in zip(entries.calls, (0, 1, 1)):
        assert name == "paged_attention"
        assert args[1] == kc.data_ptr() + layer * layer_bytes
        assert args[2] == vc.data_ptr() + layer * layer_bytes
        assert args[4:7] == [md.t2b.data_ptr(), md.pos.data_ptr(),
                             bt.data_ptr()]
        assert args[7:15] == [T, HQ, HKV, D, BS, MB, bt.shape[0], 1]
        assert args[15] == pytest.approx(D ** 0.5) and args[16] == 7
    with pytest.raises(ValueError, match="layer_idx"):   # the thin path's
        PA._launch(q, kc, vc, L, md.t2b, md.pos, bt)
    assert len(checks) == 1
    with pytest.raises(TypeError):                  # q of another dtype
        PA._launch(q.half(), kc, vc, 0, md.t2b, md.pos, bt)
    with pytest.raises(ValueError):                 # another step: checked
        PA._launch(q[:, :, :8].contiguous(), kc, vc, 0, md.t2b, md.pos, bt)
    k8 = torch.zeros(kc.shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale pools"):
        PA._launch(q, k8, k8, 0, md.t2b, md.pos, bt)
    scales = torch.ones(kc.shape[:-1])
    PA._launch(q, k8, k8, 1, md.t2b, md.pos, bt, scales, scales)
    name, *args = entries.calls[-1]
    assert name == "paged_attention_int8" and len(checks) == 5
    assert args[3] == scales.data_ptr() + scales.stride(0) * 4


def test_kernel_call_keeps_no_dropped_pools_alive(monkeypatch):
    """The wrapper remembers a validated step by weak references: once the
    step's pools are dropped and collected, nothing keeps them alive, and
    the next call, with new pools, is checked in full. reset_launch_counts
    forgets the step too. CPU tensors through the launch path, the library
    replaced by a recorder."""
    import gc
    import weakref

    from paddle_tpu_torch.ops.kernels import reset_launch_counts

    entries = _Entries()
    checks = []
    check = PA._check
    monkeypatch.setattr(PA._build, "py_module", lambda: entries)
    monkeypatch.setattr(PA, "_check", lambda *a: checks.append(1) or
                        check(*a))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    monkeypatch.setattr(PA, "_step", None)
    ins = _inputs(6)
    qkv, kc, vc, enc, dec, this, cu, bt, rope = [torch.tensor(a)
                                                 for a in ins]
    md = TF.paged_metadata(qkv.shape[0], enc, dec, cu, bt, BS, rope)
    q = qkv[:, :HQ * D].reshape(-1, HQ, D).to(torch.bfloat16).contiguous()

    def pools():
        return kc.to(torch.bfloat16), vc.to(torch.bfloat16)

    k1, v1 = pools()
    for layer in (0, 1):
        PA._launch(q, k1, v1, layer, md.t2b, md.pos, bt)
    assert len(checks) == 1
    dead = (weakref.ref(k1), weakref.ref(v1))
    del k1, v1
    gc.collect()
    assert dead[0]() is None and dead[1]() is None
    k2, v2 = pools()
    PA._launch(q, k2, v2, 0, md.t2b, md.pos, bt)      # new pools: in full
    PA._launch(q, k2, v2, 1, md.t2b, md.pos, bt)      # the same step
    assert len(checks) == 2 and len(entries.calls) == 4
    assert entries.calls[-1][2] == k2.data_ptr() + k2.stride(0) * 2
    reset_launch_counts()
    assert PA._step is None
    PA._launch(q, k2, v2, 0, md.t2b, md.pos, bt)
    assert len(checks) == 3
