"""The port's RoPE-and-append (paddle_tpu_torch.ops.kernels.rope_append) on
the CPU.

- Its plain version, and the wrapper on CPU tensors, against the
  composition ``block_multihead_attention`` ran before it (RoPE of q and k
  in f32 product by product, the cast back to qkv's dtype, then the page
  scatter, or ``kv_quant``'s plain version for int8 pages), written out
  here: q, k, v and every pool byte bit for bit, over f32 and bf16 qkv,
  float and int8 pages, 1, 8 and 37 tokens (the last with padding tokens in
  the trash row, fewer than a page, so no two write one slot), two head
  layouts, and both output layouts.
- One call of the port's ``block_multihead_attention`` against the JAX
  reference's under ``jax.jit`` (the engine's context), float and int8
  pages, paged and fresh-prefill routes: every pool byte (codes and scales)
  bit for bit, with RoPE off on the JAX side and an identity table on the
  port's, so q and k are the same bits on both sides (with a real table
  the two frameworks may round RoPE's products apart in the last bit, see
  tests/test_torch_kv_int8.py).
- The wrapper's refusals, and its kernel call checking a step's inputs
  once (the library replaced by a recorder).
"""
import os

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JF

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.ops.kernels import kv_quant as KQ
from paddle_tpu_torch.ops.kernels import rope_append as RA

L, NB, BS, MB = 2, 64, 8, 6
SHAPES = {"4-2-64": (4, 2, 64), "16-8-128": (16, 8, 128)}
# (tokens, start position) a row, and the trash row's padding tokens
STEPS = {1: ([(1, 13)], 0),
         8: ([(1, 3 + 5 * i) for i in range(8)], 0),
         37: ([(1, 13), (9, 20), (20, 3)], 7)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    # the JAX fresh route's Pallas kernel in interpret mode; one PyTorch
    # thread while the test runs, restored after (see
    # tests/test_torch_varlen_attention.py)
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


def _rope_table(B1, d, identity=False):
    half = d // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) * 2.0 / d))
    ang = np.arange(MB * BS, dtype=np.float32)[:, None] * inv
    cs = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    if identity:                       # cos 1, sin 0: q and k unrotated
        cs = np.stack([np.ones_like(ang), np.zeros_like(ang)])
    return np.ascontiguousarray(np.broadcast_to(
        cs[:, None, None], (2, B1, 1, MB * BS, half)))


def _meta(rows, n_pad):
    """(enc, dec, this, cu, bt) of rows [(tokens, start)], each on pages of
    its own, and the trash row (last, all page 0) holding n_pad tokens."""
    B1 = len(rows) + 1
    enc = np.zeros(B1, np.int64)
    dec = np.zeros(B1, np.int64)
    this = np.zeros(B1, np.int64)
    bt = np.zeros((B1, MB), np.int64)
    free = 1
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        used = -(-(start + n) // BS)
        bt[i, :used] = free + np.arange(used)
        free += used
    this[-1] = enc[-1] = n_pad
    cu = np.zeros(B1 + 1, np.int64)
    cu[1:] = np.cumsum(this)
    return enc, dec, this, cu, bt


def _case(rows, n_pad, shape, dtype, int8, seed, identity=False):
    """qkv, the stacked pools (random earlier contents) and the step's
    PagedMetadata. k and v span magnitudes (a scale a token); token 0's k
    head 0 is zero, the last token's v head 0 a tie head (max 127, so the
    int8 scale is 1, values n + 0.5)."""
    hq, hkv, d = shape
    rng = np.random.RandomState(seed)
    enc, dec, this, cu, bt = _meta(rows, n_pad)
    T = int(cu[-1])
    qkv = rng.randn(T, (hq + 2 * hkv) * d)
    qkv[:, hq * d:] *= np.exp(rng.randn(T, 1))
    qkv[0, hq * d:(hq + 1) * d] = 0.0
    tie = (hq + hkv) * d
    qkv[-1, tie:tie + d] = np.arange(d) % 9 + 0.5
    qkv[-1, tie] = 127.0
    qkv = torch.tensor(qkv, dtype=torch.float32).to(dtype)
    shape5 = (L, NB, hkv, BS, d)
    if int8:
        pools = [torch.tensor(rng.randint(-127, 128, shape5), dtype=torch.int8)
                 for _ in range(2)]
        pools += [torch.tensor(rng.rand(*shape5[:-1]) * 0.05,
                               dtype=torch.float32) for _ in range(2)]
    else:
        pools = [torch.tensor(rng.randn(*shape5), dtype=torch.float32)
                 .to(dtype) for _ in range(2)] + [None, None]
    md = TF.paged_metadata(T, torch.tensor(enc), torch.tensor(dec),
                           torch.tensor(cu), torch.tensor(bt), BS,
                           torch.tensor(_rope_table(len(rows) + 1, d,
                                                    identity)))
    return qkv, pools, md


def _old_composition(qkv, kc, vc, ks, vs, layer, md, heads_first):
    """What block_multihead_attention ran before rope_append, written out:
    RoPE in f32 (interleaved pairs), the cast back, the page scatter or
    kv_quant's plain version."""
    hkv, d = kc.shape[2], kc.shape[-1]
    T = qkv.shape[0]
    hq = qkv.shape[1] // d - 2 * hkv
    q = qkv[:, :hq * d].reshape(T, hq, d)
    k = qkv[:, hq * d:(hq + hkv) * d].reshape(T, hkv, d)
    v = qkv[:, (hq + hkv) * d:].reshape(T, hkv, d)

    def rope(t):
        tf = t.float()
        t1, t2 = tf[..., 0::2], tf[..., 1::2]
        return torch.stack([t1 * md.cos - t2 * md.sin,
                            t2 * md.cos + t1 * md.sin],
                           dim=-1).reshape(t.shape)

    q = rope(q).to(qkv.dtype)
    k = rope(k).to(qkv.dtype)
    if ks is not None:
        KQ._kv_quant_ref(k, v, kc, vc, ks, vs, layer, md.page, md.slot)
    else:
        kc[layer].transpose(1, 2)[md.page, md.slot] = k.to(kc.dtype)
        vc[layer].transpose(1, 2)[md.page, md.slot] = v.to(vc.dtype)
    if heads_first:
        return q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    return q


@pytest.mark.parametrize("layout", ["paged", "heads_first"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("T", sorted(STEPS))
@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_is_the_old_composition(dtype, pages, T, shape,
                                              layout):
    heads_first = layout == "heads_first"
    qkv, pools, md = _case(*STEPS[T], SHAPES[shape], DTYPES[dtype],
                           pages == "int8", seed=T + len(shape))
    assert qkv.shape[0] == T
    ref_pools = [None if p is None else p.clone() for p in pools]
    want = _old_composition(qkv, *ref_pools, 1, md, heads_first)
    reset_launch_counts()
    for fn in (RA._rope_append_ref, RA.rope_append):
        got_pools = [None if p is None else p.clone() for p in pools]
        got = fn(qkv, *got_pools, 1, md, heads_first=heads_first)
        got = got if heads_first else (got,)
        want_t = want if heads_first else (want,)
        assert len(got) == len(want_t)
        for a, b in zip(got, want_t):
            assert a.dtype == qkv.dtype and a.shape == b.shape
            assert a.is_contiguous()
            assert torch.equal(a, b)
        for a, b in zip(got_pools, ref_pools):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    assert launch_counts()["rope_append"] == 0               # CPU path
    # layer 0 untouched; the zero head and the tie head of the int8 pages
    for a, b in zip(got_pools, pools):
        if a is not None:
            assert torch.equal(a[0], b[0])
    if pages == "int8":
        ks, vs = got_pools[2][1], got_pools[3][1]
        p0, s0 = int(md.page[0]), int(md.slot[0])
        p1, s1 = int(md.page[-1]), int(md.slot[-1])
        assert float(ks[p0, 0, s0]) == float(np.float32(1e-8))
        assert not got_pools[0][1, p0, 0, s0].any()
        assert float(vs[p1, 0, s1]) == 1.0


def _jax_bma(qkv, pools, meta, layer, fresh):
    """The reference's call under jax.jit, RoPE off."""
    enc, dec, this, cu, bt = meta
    int8 = pools[2] is not None

    def f(*a):
        w = [Tensor(x, stop_gradient=True) for x in a]
        kw = dict(cache_k_quant_scales=w[8], cache_v_quant_scales=w[9],
                  use_dynamic_cachekv_quant=True) if int8 else {}
        out = JF.block_multihead_attention(
            w[0], w[1], w[2], w[3], w[4], w[5], None, None, w[6], None,
            w[7], rope_emb=None, layer_idx=layer, max_seq_len=MB * BS,
            block_size=BS, fresh_prefill=fresh, **kw)
        return [o._value for o in out]

    args = [qkv.numpy(), pools[0].numpy(), pools[1].numpy(), enc, dec, this,
            cu, bt] + ([pools[2].numpy(), pools[3].numpy()] if int8 else [])
    return [np.asarray(o) for o in jax.jit(f)(*args)]


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("pages", ["float", "int8"])
def test_block_attention_pools_match_jax_under_jit(pages, fresh):
    int8 = pages == "int8"
    d = SHAPES["4-2-64"][2]
    # fresh: 128 packed tokens from position 0 (the TPU kernel's block)
    rows, n_pad = ([(40, 0), (33, 0), (48, 0)], 7) if fresh \
        else STEPS[37]
    qkv, pools, md = _case(rows, n_pad, SHAPES["4-2-64"], torch.float32,
                           int8, seed=30 + fresh, identity=True)
    meta = _meta(rows, n_pad)
    j = _jax_bma(qkv, pools, meta, 1, fresh)
    enc, dec, this, cu, bt = [torch.tensor(a) for a in meta]
    kw = dict(cache_k_quant_scales=pools[2], cache_v_quant_scales=pools[3],
              use_dynamic_cachekv_quant=True) if int8 else {}
    out = TF.block_multihead_attention(
        qkv, pools[0], pools[1], enc, dec, this, cu, bt,
        torch.tensor(_rope_table(len(rows) + 1, d, identity=True)),
        layer_idx=1, fresh_prefill=fresh, **kw)
    assert len(out) == (6 if int8 else 4)
    got = [p for p in pools if p is not None]
    assert all(a is b for a, b in zip(out[2:], got))          # in place
    for a, b in zip(got, j[2:]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(out[0].numpy(), j[0], atol=1e-5, rtol=1e-5)


def _refusal_inputs():
    qkv, pools, md = _case(*STEPS[8], SHAPES["4-2-64"], torch.float32, True,
                           seed=3)
    return qkv, pools, md


_REFUSALS = {
    "qkv_3d": (ValueError, lambda q, p, m: ((q[None],) + tuple(p), 0, m)),
    "qkv_width": (ValueError, lambda q, p, m: ((q[:, :-2],) + tuple(p), 0,
                                               m)),
    "caches_differ": (ValueError, lambda q, p, m: (
        (q, p[0], p[1][:, :, :1]) + tuple(p[2:]), 0, m)),
    "fp16_qkv": (TypeError, lambda q, p, m: ((q.half(),) + tuple(p), 0, m)),
    "pages_not_qkv_dtype": (TypeError, lambda q, p, m: (
        (q, p[0].bfloat16(), p[1].bfloat16(), None, None), 0, m)),
    "int8_without_scales": (ValueError, lambda q, p, m: (
        (q, p[0], p[1], None, None), 0, m)),
    "scales_beside_float_pages": (ValueError, lambda q, p, m: (
        (q, p[0].float(), p[1].float(), p[2], p[3]), 0, m)),
    "scales_shape": (ValueError, lambda q, p, m: (
        (q, p[0], p[1], p[2][:, :3], p[3][:, :3]), 0, m)),
    "layer_past_the_end": (ValueError, lambda q, p, m: ((q,) + tuple(p), L,
                                                        m)),
    "layer_negative": (ValueError, lambda q, p, m: ((q,) + tuple(p), -1, m)),
    "metadata_tokens": (ValueError, lambda q, p, m: (
        (q,) + tuple(p), 0, m._replace(page=m.page[:-1]))),
    "metadata_angles": (ValueError, lambda q, p, m: (
        (q,) + tuple(p), 0, m._replace(cos=m.cos.double()))),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_rope_append_refusals(case):
    err, make = _REFUSALS[case]
    qkv, pools, md = _refusal_inputs()
    args, layer, m = make(qkv, pools, md)
    before = [None if p is None else p.clone() for p in pools]
    with pytest.raises(err):
        RA.rope_append(*args, layer, m)
    for a, b in zip(pools, before):                 # nothing written
        assert a is None or torch.equal(a, b)


class _Entries:
    """Stand-in for the kernel library's extension module: records each
    call's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def rope_append(self, *args):
        self.calls.append(args)
        return 0


def test_kernel_call_checks_a_step_once(monkeypatch):
    """The kernel's wrapper validates a step's inputs (pools, scale pools,
    the metadata's angles, pages and slots) once: later calls with the same
    objects and qkv of the same shape, dtype and strides check only
    layer_idx and pass each layer's pointers; anything else is checked in
    full, every refusal stands, and reset_launch_counts forgets the step.
    CPU tensors through the launch path, the library replaced by a
    recorder."""
    entries = _Entries()
    checks = []
    check = RA._check
    monkeypatch.setattr(RA._build, "py_module", lambda: entries)
    monkeypatch.setattr(RA, "_check", lambda *a: checks.append(1) or
                        check(*a))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 7, raising=False)
    monkeypatch.setattr(RA, "_step", None)
    hq, hkv, d = SHAPES["4-2-64"]
    qkv, pools, md = _case(*STEPS[37], SHAPES["4-2-64"], torch.bfloat16,
                           True, seed=4)
    T = qkv.shape[0]
    before = RA.launches
    for layer in (0, 1, 1):
        q = RA._launch(qkv.clone(), *pools, layer, md, False)
        assert q.shape == (T, hq, d) and q.dtype == torch.bfloat16
    assert len(checks) == 1 and len(entries.calls) == 3
    assert RA.launches == before + 3
    layer_bytes = pools[0].stride(0)
    scale_bytes = pools[2].stride(0) * 4
    for args, layer in zip(entries.calls, (0, 1, 1)):
        assert len(args) == 21
        assert args[1] == qkv.stride(0)
        assert args[2:6] == (md.cos.data_ptr(), md.sin.data_ptr(),
                             md.page.data_ptr(), md.slot.data_ptr())
        assert args[6] == pools[0].data_ptr() + layer * layer_bytes
        assert args[7] == pools[1].data_ptr() + layer * layer_bytes
        assert args[8] == pools[2].data_ptr() + layer * scale_bytes
        assert args[9] == pools[3].data_ptr() + layer * scale_bytes
        assert args[11] is None and args[12] is None
        assert args[13:] == (T, hq, hkv, d, BS, 1, 1, 7)
    with pytest.raises(ValueError, match="layer_idx"):  # the thin path's
        RA._launch(qkv, *pools, L, md, False)
    assert len(checks) == 1
    q, k, v = RA._launch(qkv, *pools, 0, md, True)      # heads first
    assert (q.shape, k.shape, v.shape) == ((hq, T, d), (hkv, T, d),
                                           (hkv, T, d))
    assert entries.calls[-1][11] == k.data_ptr()
    assert entries.calls[-1][12] == v.data_ptr()
    assert len(checks) == 1
    with pytest.raises(TypeError):                      # another qkv
        RA._launch(qkv.half(), *pools, 0, md, False)
    f_pools = [torch.zeros(pools[0].shape, dtype=torch.bfloat16)
               for _ in range(2)]
    RA._launch(qkv, *f_pools, None, None, 1, md, False)   # new pools: full
    args = entries.calls[-1]
    assert len(checks) == 3
    assert args[8] is None and args[9] is None and args[19] == 0
    with pytest.raises(ValueError, match="multiple of 8"):
        c36 = [torch.zeros(2, NB, 1, BS, 36, dtype=torch.bfloat16)
               for _ in range(2)]
        RA._launch(qkv[:, :6 * 36], *c36, None, None, 0,
                   md._replace(cos=md.cos[..., :18].contiguous(),
                               sin=md.sin[..., :18].contiguous()), False)
    reset_launch_counts()
    assert RA._step is None
    RA._launch(qkv, *f_pools, None, None, 1, md, False)
    assert len(checks) == 5
