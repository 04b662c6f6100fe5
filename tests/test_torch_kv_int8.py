"""The port's int8 cache-KV path against the JAX reference, on the CPU.

- ``kv_quant``'s plain version against the reference's ``q8`` and its four
  page scatters (incubate/nn/functional/__init__.py:687-704), run through
  the JAX ``block_multihead_attention`` under ``jax.jit`` as the engine
  runs it: codes and scales bit for bit (f32 and bf16 inputs, a tie head,
  a zero head). Under jit XLA turns the reference's ``max / 127.0`` into a
  multiply by the f32 reciprocal, which the port computes; the test checks
  that the data tells the two apart.
- The int8 paged route and the whole 6-tuple of ``block_multihead_attention``
  (decode + chunked, and fresh prefill over the unquantized k/v) against
  the JAX one: pools, codes and scales bit for bit where q and k are the
  same bits on both sides (RoPE off on the JAX side, an identity table on
  the port's); with a real RoPE table the outputs within 1e-5 and the k
  scales within 1e-6 relative (the two frameworks round RoPE's products at
  other places, so k can differ in its last bit).
- The int8 engine's greedy streams against the JAX int8 engine's, with the
  config of tests/test_serving_engine.py::
  test_int8_kv_cache_matches_bf16_generation, and its decode_run windows
  against the JAX engine's decode_run, token for token (both in f32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.ops.kernels import kv_quant as KQ
from paddle_tpu_torch.ops.kernels import paged_attention as PA

L, NB, HQ, HKV, BS, D, MB = 2, 24, 4, 2, 8, 64, 6
TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    # the JAX fresh route's Pallas kernel in interpret mode; one PyTorch
    # thread while the test runs, restored after: in a fresh process with
    # two or more threads, the first float exp after MKL's first GEMM
    # sometimes computes one thread's share with a low-accuracy exp (see
    # test_torch_varlen_attention.py)
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


def _rope(B1, identity=False):
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) * 2.0 / D))
    ang = np.arange(MB * BS, dtype=np.float32)[:, None] * inv
    cs = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    if identity:                       # cos 1, sin 0: q and k unrotated
        cs = np.stack([np.ones_like(ang), np.zeros_like(ang)])
    return np.ascontiguousarray(np.broadcast_to(
        cs[:, None, None], (2, B1, 1, MB * BS, half)))


def _inputs(rows, n_pad, seed, dtype=np.float32):
    """rows: [(n_tokens, start_pos, pages)]; the last batch row is the
    trash row holding n_pad padding tokens. k and v span magnitudes (a
    scale a token), token 0 has a zero k head and its token 1 a tie head
    (max 127, so s == 1, and values n + 0.5)."""
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
    qkv = rng.randn(T, (HQ + 2 * HKV) * D)
    qkv[:, HQ * D:] *= np.exp(rng.randn(T, 1))       # k and v scales vary
    qkv[0, HQ * D:(HQ + 1) * D] = 0.0
    qkv[1, HQ * D:(HQ + 1) * D] = np.arange(D) % 9 + 0.5
    qkv[1, HQ * D] = 127.0
    qkv = qkv.astype(np.float32)
    if dtype is not np.float32:        # bf16 values, carried as f32
        qkv = np.asarray(jnp.asarray(qkv).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    # earlier steps' int8 pages and scales
    kc = rng.randint(-127, 128, (L, NB, HKV, BS, D)).astype(np.int8)
    vc = rng.randint(-127, 128, (L, NB, HKV, BS, D)).astype(np.int8)
    ks = (rng.rand(L, NB, HKV, BS) * 0.05).astype(np.float32)
    vs = (rng.rand(L, NB, HKV, BS) * 0.05).astype(np.float32)
    return qkv, kc, vc, ks, vs, enc, dec, this, cu, bt


def _jax_bma8(ins, layer, fresh, rope=None, dtype=jnp.float32):
    """The reference's int8 6-tuple under jax.jit (the engine's context)."""
    qkv, kc, vc, ks, vs, enc, dec, this, cu, bt = ins

    def f(*a):
        w = [Tensor(x, stop_gradient=True) for x in a]
        out = JF.block_multihead_attention(
            w[0], w[1], w[2], w[5], w[6], w[7], None, None, w[8], None,
            w[9], cache_k_quant_scales=w[3], cache_v_quant_scales=w[4],
            use_dynamic_cachekv_quant=True,
            rope_emb=w[10] if rope is not None else None, layer_idx=layer,
            max_seq_len=MB * BS, block_size=BS, fresh_prefill=fresh)
        return [o._value for o in out]

    args = [jnp.asarray(qkv).astype(dtype), kc, vc, ks, vs, enc, dec, this,
            cu, bt] + ([rope] if rope is not None else [])
    out = jax.jit(f)(*args)
    return [np.asarray(jnp.asarray(o).astype(jnp.float32))
            if o.dtype == jnp.bfloat16 else np.asarray(o) for o in out]


def _torch_bma8(ins, layer, fresh, rope, dtype=torch.float32):
    qkv, kc, vc, ks, vs, enc, dec, this, cu, bt = ins
    pools = [torch.tensor(a) for a in (kc, vc, ks, vs)]
    out = TF.block_multihead_attention(
        torch.tensor(qkv).to(dtype), pools[0], pools[1], torch.tensor(enc),
        torch.tensor(dec), torch.tensor(this), torch.tensor(cu),
        torch.tensor(bt), torch.tensor(rope), layer_idx=layer,
        fresh_prefill=fresh, cache_k_quant_scales=pools[2],
        cache_v_quant_scales=pools[3], use_dynamic_cachekv_quant=True)
    assert len(out) == 6
    assert all(a is b for a, b in zip(out[2:], pools))    # in place
    return [out[0].float().numpy()] + [p.numpy() for p in pools]


# decode rows, a chunk crossing a page, and a decode at position 0; a
# 5-token padding tail in the trash row (page 0)
_CHUNKED = ([(1, 13, [3, 4]), (9, 20, [5, 6, 7, 8]), (1, 0, [9]),
             (30, 3, [10, 11, 12, 13, 14])], 5)
# 128 packed tokens from position 0 (the TPU kernel's block)
_FRESH = ([(40, 0, [3, 4, 5, 6, 7]), (33, 0, [8, 9, 10, 11, 12]),
           (48, 0, [13, 14, 15, 16, 17, 18])], 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_plain_matches_jax_q8_bit_for_bit(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rows, n_pad = _CHUNKED
    ins = _inputs(rows, n_pad, 1, jdt)
    qkv, kc, vc, ks, vs, enc, dec, this, cu, bt = ins
    j = _jax_bma8(ins, 1, False, dtype=jdt)               # RoPE off
    # the port's kernel entry, plain version, on the same k and v bits
    q = torch.tensor(qkv).to(tdt)
    md = TF.paged_metadata(q.shape[0], torch.tensor(enc), torch.tensor(dec),
                           torch.tensor(cu), torch.tensor(bt), BS,
                           torch.tensor(_rope(len(rows) + 1)))
    k = q[:, HQ * D:(HQ + HKV) * D].reshape(-1, HKV, D)
    v = q[:, (HQ + HKV) * D:].reshape(-1, HKV, D)
    pools = [torch.tensor(a) for a in (kc, vc, ks, vs)]
    reset_launch_counts()
    KQ.kv_quant(k, v, *pools, 1, md.page, md.slot)
    assert launch_counts()["kv_quant"] == 0                  # CPU path
    for got, ref in zip(pools, j[2:]):
        # page 0 takes the padding tokens' writes (several a slot)
        np.testing.assert_array_equal(got.numpy()[:, 1:], ref[:, 1:])
    # the zero head: codes 0 and scale 1e-8; the tie head: s == 1 exactly
    p0, s0 = int(md.page[0]), int(md.slot[0])
    p1, s1 = int(md.page[1]), int(md.slot[1])
    assert pools[2][1, p0, 0, s0] == np.float32(1e-8)
    assert not pools[0][1, p0, 0, s0].any()
    assert pools[2][1, p1, 0, s1] == 1.0
    ties = np.arange(D) % 9 + 0.5
    np.testing.assert_array_equal(pools[0][1, p1, 0, s1, 1:].numpy(),
                                  np.round(ties[1:]).astype(np.int8))
    # the data tells a true division by 127 from the reciprocal multiply
    m = np.abs(np.asarray(k.float())).max(-1)
    live = m > 0
    assert (np.float32(m[live]) / np.float32(127)
            != np.float32(m[live]) * np.float32(KQ.INV127)).any()


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_int8_plain_matches_jax_route(layer):
    """The non-fresh route over int8 pages: the 6-tuple with RoPE off on
    the JAX side and an identity table on the port's, so q, k and v are
    the same bits: pools bit for bit, out within 1e-5."""
    rows, n_pad = _CHUNKED
    ins = _inputs(rows, n_pad, 10 + layer)
    j = _jax_bma8(ins, layer, False)
    t = _torch_bma8(ins, layer, False, _rope(len(rows) + 1, identity=True))
    np.testing.assert_allclose(t[0], j[0], atol=TOL, rtol=TOL)
    for got, ref in zip(t[1:], j[2:]):
        np.testing.assert_array_equal(got[:, 1:], ref[:, 1:])
    # the plain paged version reads the dequantized pages, as the reference
    q = torch.tensor(ins[0][:, :HQ * D].reshape(-1, HQ, D))
    md = TF.paged_metadata(q.shape[0], *[torch.tensor(a) for a in
                                         (ins[5], ins[6], ins[8], ins[9])],
                           BS, torch.tensor(_rope(len(rows) + 1)))
    pools = [torch.tensor(a) for a in t[1:]]
    out = PA.paged_attention(q, pools[0], pools[1], layer, md.t2b, md.pos,
                             torch.tensor(ins[9]), pools[2], pools[3])
    np.testing.assert_allclose(out.reshape(q.shape[0], -1).numpy(), j[0],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fresh", [False, True])
def test_block_attention_int8_six_tuple_matches_jax(fresh):
    """With a real RoPE table: fresh prefill attends over the unquantized
    k/v (varlen route) and writes int8 pages; the chunked step reads them
    back dequantized."""
    rows, n_pad = _FRESH if fresh else _CHUNKED
    ins = _inputs(rows, n_pad, 20 + fresh)
    rope = _rope(len(rows) + 1)
    j = _jax_bma8(ins, 1, fresh, rope=rope)
    t = _torch_bma8(ins, 1, fresh, rope)
    np.testing.assert_allclose(t[0], j[0], atol=TOL, rtol=TOL)
    kc, vc, ks, vs = t[1:]
    # v is not rotated: the same bits in, the same codes and scales out
    np.testing.assert_array_equal(vc[:, 1:], j[3][:, 1:])
    np.testing.assert_array_equal(vs[:, 1:], j[5][:, 1:])
    np.testing.assert_array_equal(kc[:, 1:], j[2][:, 1:])
    np.testing.assert_allclose(ks[:, 1:], j[4][:, 1:], rtol=1e-6, atol=0)
    # layer 0 untouched
    np.testing.assert_array_equal(kc[0], ins[1][0])


_ENGINE_CFG = dict(vocab_size=211, hidden_size=64, num_layers=3,
                   num_heads=4, num_kv_heads=2, ffn_size=128, block_size=8,
                   num_blocks=48, max_batch=3, max_blocks_per_seq=6,
                   token_budget=32)


def _pair(base, seed):
    paddle.seed(seed)
    jm = JS.PagedCausalLM(JS.PagedServingConfig(**base))
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**base),
                          device="cpu").load_paddle_tpu_params(named)
    return jm, tm


def test_int8_engine_greedy_matches_jax_int8_engine():
    jm, tm = _pair(_ENGINE_CFG, 7)
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, 211, n)) for n in (7, 12, 4)]

    def run(eng):
        rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        res = eng.run_to_completion()
        return [res[r] for r in rids]

    jm._serving_shared = None
    ref = run(JS.ServingEngine.from_model(
        jm, JS.PagedServingConfig(**_ENGINE_CFG, cache_quant="int8")))
    cfg8 = TS.PagedServingConfig(**_ENGINE_CFG, cache_quant="int8")
    eng = TS.ServingEngine.from_model(tm, cfg8, device="cpu")
    assert eng._kc.dtype == torch.int8 and eng._vc.dtype == torch.int8
    assert eng._ks.shape == (3, 48, 2, 8) and eng._ks.dtype == torch.float32
    assert run(eng) == ref
    # as the reference's test: the full-precision engine's streams too
    full = TS.ServingEngine.from_model(
        tm, TS.PagedServingConfig(**_ENGINE_CFG), device="cpu")
    assert run(full) == ref
    # the cast copies are keyed by cache_quant, as the reference's
    assert tm._serving_shared[0][1] is None
    assert len(eng._free_pages) == cfg8.num_blocks - 1


def test_int8_decode_run_matches_jax():
    base = dict(vocab_size=131, hidden_size=32, num_layers=2, num_heads=4,
                num_kv_heads=2, ffn_size=64, block_size=8, num_blocks=32,
                max_batch=2, max_blocks_per_seq=6, token_budget=32)
    jm, tm = _pair(base, 11)
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(1, 131, n)) for n in (6, 9)]

    def drive(eng):
        rids = [eng.add_request(p, max_new_tokens=8 + 3 * i)
                for i, p in enumerate(prompts)]
        while any(r.length - r.cached > 1 for r in eng.pending()):
            eng.step()
        order = []
        while eng.pending():
            got = eng.decode_run(4)
            assert got
            order += got
        return [list(eng._requests[r].generated) for r in rids], order

    jm._serving_shared = None
    ref = drive(JS.ServingEngine.from_model(
        jm, JS.PagedServingConfig(**base, cache_quant="int8")))
    eng = TS.ServingEngine.from_model(
        tm, TS.PagedServingConfig(**base, cache_quant="int8"), device="cpu")
    assert drive(eng) == ref
    assert set(eng._window_fns) == {(2, "greedy"), (1, "greedy")}
