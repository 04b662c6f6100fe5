"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports only torch and the port, so it runs on a machine without JAX:
    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
Every test skips where there is no CUDA device.

Tolerances: RMSNorm in bf16 one bf16 ulp (2**-7 relative; both round the
same f32 value up to its last bits), in f32 1e-5 relative; its gradient as
stated above RMS_BWD_PAIRS. Attention
outputs and gradients are held element by element (``_worst_of_tol``) to
rtol * (|ref| + the RMS of ref's row over D) + floor, so each row answers
for its own size and not for the tensor's largest value: in bf16 rtol
2**-6, floor 1e-5 (both sides round to bf16, up to 2**-7 |ref|; the
kernels round P, p_used and dS to bf16 before their products, as the TPU
kernels do, the dense plain versions do not), in f32 rtol 1e-4, floor
1e-6. LSE 1e-3 absolute (f32 on both sides; |LSE| ~ 1-9 on live rows).
The paged-attention kernel takes the same tolerances (both sides round P
to the cache dtype after normalising, from f32 sums taken in other
orders). The serving decode window's CUDA graphs are held to the eager run
of the same body bit for bit. The RoPE-and-append kernel: q (k and v heads
first) and every pool byte bit for bit against its plain version, slots it
does not write untouched, a graph's replay equal to the eager call, and an
engine's greedy streams equal to the same engine's through the plain
version. The int8 cache-KV path: kv_quant's codes and scales bit for bit
against its plain version; the int8 paged kernel within
the tolerances above of its plain version and bit for bit equal to the
float kernel over pages of q's dtype holding the same dequantized values.
"""
import collections

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import rms_norm as TR
from paddle_tpu_torch.ops.kernels import varlen_attention as TV

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [2048, 64, 8192])
@pytest.mark.parametrize("rows", [256, 8, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_kernel_matches_plain(rows, h, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + h)
    x = (torch.randn(rows, h, device=cuda_device, generator=gen) * 3) \
        .to(dtype)
    w = torch.randn(h, device=cuda_device, generator=gen).to(dtype)
    before = TR.launches
    for weight in (w, None):
        got = TR.rms_norm(x, weight)
        ref = TR._rms_norm_ref(x, weight, 1e-6)
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert bool(((got.float() - ref.float()).abs()
                     <= rel * ref.float().abs() + 1e-6).all())
    torch.cuda.synchronize()
    assert TR.launches == before + 2


def test_rms_norm_kernel_rejects_what_it_cannot_take(cuda_device):
    """Every width computes (h = 100 is not a multiple of 8: element
    loads); only a dtype other than f32 and bf16 is refused, forward and
    gradient, and a weight of another dtype or shape."""
    x = torch.ones(4, 100, device=cuda_device, dtype=torch.bfloat16)
    y = TR.rms_norm(x)
    torch.cuda.synchronize()
    assert bool((y.float() - 1.0).abs().max() <= 2.0 ** -7)
    half = torch.ones(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        TR.rms_norm(half)
    with pytest.raises(TypeError):
        TR._launch_bwd(half, None, 1e-6, half)
    with pytest.raises(ValueError):
        TR.rms_norm(x, torch.ones(100, device=cuda_device,
                                  dtype=torch.float16))
    with pytest.raises(ValueError):
        TR.rms_norm(x, torch.ones(64, device=cuda_device))


# the gradient kernel's tolerances (element by element, each row of gx held
# to its own RMS: gx has cancellations): gx bf16 2**-7 * (|ref| + row RMS)
# + 1e-6, f32 1e-5 * (|ref| + row RMS) + 1e-7; gw per column within
# 1e-4 * sum over rows of |g * xhat| + 1e-6, plus one bf16 ulp
# (2**-7 * |ref|) for a bf16 gw (both round f32 sums taken in other orders)
RMS_BWD_PAIRS = [(torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.float32, torch.float32)]


def _rms_bwd_worst(x, w, g, gx, gw, eps=1e-6):
    """Worst ratios of the gradient kernel's errors to their tolerances
    (gx, gw) against TR._rms_norm_bwd; at most 1 passes."""
    gxr, gwr = TR._rms_norm_bwd(x, w, eps, g)
    rtol, floor = (2.0 ** -7, 1e-6) if x.dtype == torch.bfloat16 \
        else (1e-5, 1e-7)
    rx = _worst_of_tol(gx, gxr, rtol, floor)
    if w is None:
        return rx, 0.0
    xf = x.float().reshape(-1, x.shape[-1])
    xhat = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    scale = (g.float().reshape(xf.shape) * xhat).abs().sum(0)
    gwr = gwr.float()
    tol = 1e-4 * scale + 1e-6 + (2.0 ** -7 * gwr.abs()
                                 if w.dtype == torch.bfloat16 else 0.0)
    return rx, float(((gw.float() - gwr).abs() / tol).max())


@pytest.mark.parametrize("pair", RMS_BWD_PAIRS,
                         ids=["bf16-bf16", "bf16-f32", "f32-f32"])
@pytest.mark.parametrize("h", [64, 100, 2048, 40000])
@pytest.mark.parametrize("rows", [1, 3, 8, 256, 4097])
def test_rms_norm_bwd_kernel_matches_plain(rows, h, pair, cuda_device):
    """The gradient kernel (and the forward) at every path: vector and
    element units, resident and two-pass rows; row counts below, at and
    above the gradient's grid, and not divisible by it."""
    dtype, wdtype = pair
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 7 + h)
    x = (torch.randn(rows, h, device=cuda_device, generator=gen) * 3) \
        .to(dtype)
    g = torch.randn(rows, h, device=cuda_device, generator=gen).to(dtype)
    w = torch.randn(h, device=cuda_device, generator=gen).to(wdtype)
    for weight in (w, None):
        before = (TR.launches, TR.launches_bwd)
        y = TR.rms_norm(x, weight)
        gx, gw = TR._backward(x, weight, 1e-6, g)
        torch.cuda.synchronize()
        assert (TR.launches, TR.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
        yr = TR._rms_norm_ref(x, weight, 1e-6)
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert bool(((y.float() - yr.float()).abs()
                     <= rel * yr.float().abs() + 1e-6).all())
        assert gx.dtype == dtype and gx.shape == x.shape
        assert (gw is None) == (weight is None)
        if weight is not None:
            assert gw.dtype == wdtype and gw.shape == (h,)
        rx, rw = _rms_bwd_worst(x, weight, g, gx, gw)
        assert rx <= 1.0 and rw <= 1.0, (rx, rw)


def test_rms_norm_bwd_kernel_takes_views_and_repeats(cuda_device):
    """An odd-offset g is copied once to a 16-byte boundary (counted), a
    transposed x is made contiguous; two calls give the same bits, gw
    included; a bf16 weight beside f32 x gets a bf16 gw; autograd runs the
    kernel."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rows, h = 300, 2048
    x = (torch.randn(h, rows, device=cuda_device, generator=gen) * 3) \
        .to(torch.bfloat16).t()
    buf = torch.randn(rows * h + 4, device=cuda_device,
                      generator=gen).to(torch.bfloat16)
    g = buf[4:].view(rows, h)
    assert not x.is_contiguous() and g.data_ptr() % 16 == 8
    w = torch.randn(h, device=cuda_device, generator=gen)
    reset_launch_counts()
    a = TR._launch_bwd(x, w, 1e-5, g)
    assert launch_counts()["aligned16_copies"] == 1
    b = TR._launch_bwd(x.contiguous(), w, 1e-5, g.clone())
    torch.cuda.synchronize()
    assert launch_counts()["rms_norm_bwd"] == 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rx, rw = _rms_bwd_worst(x, w, g, *a, eps=1e-5)
    assert rx <= 1.0 and rw <= 1.0, (rx, rw)
    xf = x.float()
    wb = w.to(torch.bfloat16)
    y = TR.rms_norm(xf, wb, 1e-5)        # the weight is cast to f32 first
    yr = TR._rms_norm_ref(xf, wb, 1e-5)
    assert bool(((y - yr).abs() <= 1e-5 * yr.abs() + 1e-6).all())
    gx, gw = TR._launch_bwd(xf, wb, 1e-5, g.float())
    assert gw.dtype == torch.bfloat16
    rx, rw = _rms_bwd_worst(xf, wb, g.float(), gx, gw, eps=1e-5)
    assert rx <= 1.0 and rw <= 1.0, (rx, rw)
    xl = x.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    reset_launch_counts()
    TR.rms_norm(xl, wl, 1e-5).backward(g)
    torch.cuda.synchronize()
    assert launch_counts()["rms_norm_bwd"] == 1
    assert torch.equal(xl.grad, a[0]) and torch.equal(wl.grad, a[1])


def _tol(dtype):
    """(rtol, floor) of ``_worst_of_tol`` for attention outputs."""
    return (2.0 ** -6, 1e-5) if dtype == torch.bfloat16 else (1e-4, 1e-6)


def _worst_of_tol(got, ref, rtol, floor):
    """Worst ratio of |got - ref| to rtol * (|ref| + the RMS of ref's row
    along the last axis) + floor; at most 1 passes."""
    got, ref = got.float(), ref.float()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    return float(((got - ref).abs()
                  / (rtol * (ref.abs() + rms) + floor)).max())


def _segments(lens, total, device):
    cu = np.concatenate([[0], np.cumsum(lens)])
    return torch.tensor(TV.segment_ids_from_cu_seqlens(cu, total),
                        device=device)[None]


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens,total", [([90, 60, 70], 256),
                                        ([120, 50, 30], 200),
                                        ([17, 200, 30, 5], 384),
                                        ([3], 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_varlen_kernel_matches_plain(lens, total, causal, d, dtype,
                                     cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(total + d)
    seg = _segments(lens, total, cuda_device)
    q, k, v = [torch.randn(1, h, total, d, device=cuda_device,
                           generator=gen).to(dtype) for h in (16, 8, 8)]
    before = TV.launches
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, seg, causal)
    o2, lse2 = TV._varlen_ref(q, k, v, seg, seg, causal)
    torch.cuda.synchronize()
    assert _worst_of_tol(o, o2, *_tol(dtype)) <= 1.0
    assert float((lse - lse2).abs().max()) <= 1e-3
    assert bool(torch.isfinite(o.float()).all())
    assert TV.launches == before + 1


def _short_documents(total, seed):
    """Lengths 40-160 from a seeded generator, the last cut to fill
    ``total``: about 40 documents in 4096 tokens."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(40, 161)))
    lens[-1] -= sum(lens) - total
    return lens


# Layouts for the bf16 kernel's segment-range tile skip: most key tiles
# skipped, documents that straddle the 128-row query blocks, a padding
# tail that shares its 128-row block with live rows (the block goes on to
# every key tile for the padding rows' uniform average), and the serving
# path's 16 query heads over 8 KV heads: (lengths, total, (H, HKV))
_SKIP_LAYOUTS = {
    "40 short documents": (_short_documents(4096, 5), 4096, (4, 2)),
    "straddling 128-row blocks": ([200, 250, 190, 384], 1024, (4, 2)),
    "padding tail in a live block": ([300, 400, 250], 1024, (4, 2)),
    "GQA 16/8, short documents, padding": (_short_documents(900, 6), 1024,
                                           (16, 8)),
}


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(_SKIP_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_varlen_kernel_skip_layouts(layout, causal, d, dtype, cuda_device):
    lens, total, (h, hkv) = _SKIP_LAYOUTS[layout]
    gen = torch.Generator(device=cuda_device).manual_seed(total + d)
    seg = _segments(lens, total, cuda_device)
    q, k, v = [torch.randn(1, n, total, d, device=cuda_device,
                           generator=gen).to(dtype) for n in (h, hkv, hkv)]
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, seg, causal)
    o2, lse2 = TV._varlen_ref(q, k, v, seg, seg, causal)
    torch.cuda.synchronize()
    assert _worst_of_tol(o, o2, *_tol(dtype)) <= 1.0
    assert float((lse - lse2).abs().max()) <= 1e-3
    assert bool(torch.isfinite(o.float()).all())
    dead = seg[0] < 0
    if dead.any():
        # padding rows: the uniform average of V over every visited key,
        # as the plain version takes it
        assert _worst_of_tol(o[:, :, dead], o2[:, :, dead],
                             *_tol(dtype)) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_forward_kernels_repeat_to_the_bit(causal, cuda_device):
    """No block writes another's rows (no atomics): two forward calls on
    the same inputs give the same bits, flash (with a key-padding bias and
    dropout) and varlen (with skipped tiles and a padding tail)."""
    q, k, v, _, kmask = _flash_inputs(2, 4, 1024, 128, torch.bfloat16, True,
                                      cuda_device, 13)
    runs = [FA.forward_with_lse(q, k, v, kmask, 99, causal, 0.1)
            for _ in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    seg = _segments(_short_documents(4000, 7), 4096, cuda_device)
    qv, kv, vv = [torch.randn(1, h, 4096, 128, device=cuda_device,
                              generator=gen).to(torch.bfloat16)
                  for h in (4, 2, 2)]
    runs_v = [TV.varlen_flash_attention_packed(qv, kv, vv, seg, seg, causal)
              for _ in range(2)]
    torch.cuda.synchronize()
    for (a, la), (b_, lb) in (runs, runs_v):
        assert torch.equal(a, b_) and torch.equal(la, lb)


def test_forward_kernels_reject_unaligned_bf16(cuda_device):
    """The bf16 kernels read tiles by 16-byte loads: their C entries refuse
    a tensor that starts 8 bytes into its storage, and the wrappers copy
    such an input once (counted in ``aligned16_copies``) and compute what
    they compute on an aligned copy, bit for bit."""
    import ctypes

    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.kernels import _build

    gen = torch.Generator(device=cuda_device).manual_seed(23)
    buf = torch.randn(2 * 256 * 64 + 4, device=cuda_device,
                      generator=gen).to(torch.bfloat16)
    q = buf[4:].view(1, 2, 256, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 8
    qa = q.clone()
    seg = _segments([100, 156], 256, cuda_device)
    runs = {
        "flash forward": lambda x: FA.forward_with_lse(x, qa, qa, None, 0,
                                                       True, 0.0),
        "varlen forward": lambda x: TV.varlen_flash_attention_packed(
            x, qa, qa, seg, seg, True),
        "rms_norm": lambda x: (TR.rms_norm(x.view(512, 64)),),
    }
    for name, run in runs.items():
        reset_launch_counts()
        got = run(q)
        assert launch_counts()["aligned16_copies"] == 1, name
        ref = run(qa)
        torch.cuda.synchronize()
        assert launch_counts()["aligned16_copies"] == 1, name
        for a, b in zip(got, ref):
            assert torch.equal(a, b), name
    # the backward kernels: an unaligned dO is copied once as well
    o, lse = TV.varlen_flash_attention_packed(qa, qa, qa, seg, seg, True)
    reset_launch_counts()
    got = TV.varlen_backward(qa, qa, qa, seg, seg, o, lse, q, True)
    assert launch_counts()["aligned16_copies"] == 1
    ref = TV.varlen_backward(qa, qa, qa, seg, seg, o, lse, qa, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # the C entries themselves refuse the unaligned pointer
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(qa)
    lse = torch.empty(1, 2, 256, device=cuda_device)
    err = FA._entry("pt_flash_attention_fwd")(
        q.data_ptr(), qa.data_ptr(), qa.data_ptr(), None, o.data_ptr(),
        lse.data_ptr(), 1, 2, 256, 256, 64, 1, 0.125, 0, 0, 0, 1.0, 1,
        stream)
    assert err != 0
    fwd = _build.entry("pt_varlen_attention_fwd", [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fwd(q.data_ptr(), qa.data_ptr(), qa.data_ptr(), seg.data_ptr(),
              seg.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, 2, 2, 256,
              256, 64, 1, 256, 256, 0.125, 1, stream)
    assert err != 0
    for name in ("dkv", "dq"):
        ptrs = [q.data_ptr(), qa.data_ptr(), qa.data_ptr(), qa.data_ptr(),
                seg.data_ptr(), seg.data_ptr(), lse.data_ptr(),
                lse.data_ptr(), o.data_ptr()] \
            + ([o.data_ptr()] if name == "dkv" else [])
        err = TV._bwd_entry(name)(*ptrs, 1, 2, 256, 256, 64, 1, 0.125, 1,
                                  stream)
        assert err != 0, name
    rms = _build.py_module()
    y = torch.empty(512, 64, device=cuda_device, dtype=torch.bfloat16)
    mode = TR._mode(64, torch.bfloat16, None, False)
    assert mode & TR._MODE_VECTOR
    assert rms.rms_norm(q.data_ptr(), None, y.data_ptr(), 512, 64, 1e-6,
                        mode, stream) != 0
    assert rms.rms_norm_bwd(qa.data_ptr(), q.data_ptr(), None, y.data_ptr(),
                            None, None, 512, 64, 1e-6,
                            TR._mode(64, torch.bfloat16, None, True), 8,
                            stream) != 0
    torch.cuda.synchronize()


def test_varlen_kernel_fully_masked_query_segment(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    seg = _segments([60, 70, 100], 256, cuda_device)
    segk = seg.clone()
    segk[segk == 1] = 9
    q, k, v = [torch.randn(1, 4, 256, 128, device=cuda_device,
                           generator=gen) for _ in range(3)]
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, segk, True)
    o2, lse2 = TV._varlen_ref(q, k, v, seg, segk, True)
    torch.cuda.synchronize()
    assert _worst_of_tol(o, o2, *_tol(torch.float32)) <= 1.0
    assert float((lse - lse2).abs().max()) <= 1e-3


@pytest.mark.parametrize("h", [2048, 64])
def test_rms_norm_kernel_f32_weight_with_bf16_x(h, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    x = (torch.randn(37, h, device=cuda_device, generator=gen) * 3) \
        .to(torch.bfloat16)
    w = torch.randn(h, device=cuda_device, generator=gen)
    before = TR.launches
    got = TR.rms_norm(x, w)
    ref = TR._rms_norm_ref(x, w, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - ref.float()).abs()
                 <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())
    assert TR.launches == before + 1


def _flash_inputs(b, h, s, d, dtype, bias, device, seed, sk=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    sk = sk or s
    q, k, v, do = [torch.randn(b, h, n, d, device=device, generator=gen)
                   .to(dtype) for n in (s, sk, sk, s)]
    kmask = None
    if bias:
        kmask = torch.zeros(b, sk, device=device)
        kmask[0, sk // 3:] = -1e30         # padding past a third of the keys
        kmask[-1] = -1e30                  # a sequence with every key padded
    return q, k, v, do, kmask




@pytest.mark.parametrize("s,d,dtype,causal,bias,p,sk", [
    (128, 64, torch.float32, True, False, 0.0, None),
    (128, 128, torch.float32, False, True, 0.0, None),
    (128, 64, torch.bfloat16, False, False, 0.1, None),
    (1024, 128, torch.bfloat16, True, False, 0.0, None),
    (1024, 64, torch.float32, True, True, 0.2, None),
    (1024, 128, torch.bfloat16, False, True, 0.1, None),
    (4096, 128, torch.bfloat16, True, False, 0.0, None),
    (4096, 64, torch.float32, False, False, 0.0, None),
    # Sq != Sk: more keys than queries with a key-padding bias, and more
    # queries than keys
    (256, 128, torch.bfloat16, False, True, 0.0, 384),
    (384, 128, torch.bfloat16, False, False, 0.0, 128),
    (1024, 64, torch.bfloat16, True, False, 0.2, None),
])
def test_flash_kernels_match_plain(s, d, dtype, causal, bias, p, sk,
                                   cuda_device):
    b, h = (2, 2) if s < 4096 else (1, 2)
    q, k, v, do, kmask = _flash_inputs(b, h, s, d, dtype, bias,
                                       cuda_device, s + d, sk)
    seed = -12345 if p > 0 else 0
    n0 = (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq)
    o, lse = FA.forward_with_lse(q, k, v, kmask, seed, causal, p)
    o2, lse2 = FA._forward_ref(q, k, v, kmask, seed, causal, p)
    g = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
    g2 = FA._backward_ref(q, k, v, kmask, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    assert (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    tol = _tol(dtype)
    # the fully padded sequence (the last batch, when there is a bias) is
    # held apart from the live ones: its dV sums every dO row
    parts = [slice(0, b - 1), slice(b - 1, b)] if bias else [slice(0, b)]
    assert bool(torch.isfinite(o.float()).all())
    assert float((lse - lse2).abs().max()) <= 1e-3
    for sl in parts:
        assert _worst_of_tol(o[sl], o2[sl], *tol) <= 1.0
        for got, ref in zip(g, g2):
            assert bool(torch.isfinite(got.float()).all())
            assert _worst_of_tol(got[sl], ref[sl], *tol) <= 1.0


@pytest.mark.parametrize("d,causal,bias,p", [(128, True, False, 0.0),
                                          (64, False, True, 0.1)])
def test_flash_backward_repeats_to_the_bit(d, causal, bias, p, cuda_device):
    """No block writes another's rows (no atomics): two backward calls on
    the same inputs give the same bits."""
    q, k, v, do, kmask = _flash_inputs(2, 4, 1024, d, torch.bfloat16, bias,
                                       cuda_device, 11)
    seed = 777 if p > 0 else 0
    o, lse = FA.forward_with_lse(q, k, v, kmask, seed, causal, p)
    g1 = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
    g2 = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    for a, b_ in zip(g1, g2):
        assert torch.equal(a, b_)


def test_flash_autograd_launches_each_kernel_once(cuda_device):
    q, k, v, do, _ = _flash_inputs(1, 2, 256, 128, torch.bfloat16, False,
                                   cuda_device, 7)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in (q, k, v))                  # [B, S, H, D]
    n0 = (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq)
    out = FA.flash_attention_bshd(q, k, v, is_causal=True)
    out.backward(do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    assert out.shape == q.shape and q.grad.shape == q.shape


def test_flash_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.ones(1, 1, 256, 256, device=cuda_device)
    with pytest.raises(ValueError):
        FA.forward_with_lse(q, q, q)          # head_dim 256: no kernel
    q = torch.ones(1, 1, 256, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        FA.forward_with_lse(q, q, q)
    # the bf16 backward kernels take whole 128-row tiles only: their entry
    # points refuse a length of 192, and the wrapper raises
    q = torch.ones(1, 1, 192, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 192, device=cuda_device)
    for launch in (FA._launch_bwd_dkv, FA._launch_bwd_dq):
        with pytest.raises(RuntimeError):
            launch(q, q, q, None, 0, q, lse, lse, False, 0.0)


# the backward's cases: short ragged totals, one sequence's worth of long
# documents, and the forward's skip layouts (H = HKV: the backward takes no
# GQA)
_BWD_LAYOUTS = [([90, 60, 70], 256), ([17, 200, 30, 5], 384),
                ([700, 1000, 300, 1900], 4096), ([3], 5)] \
    + [(lens, total) for lens, total, _ in _SKIP_LAYOUTS.values()]


def _varlen_bwd_case(lens, total, d, dtype, device, seed, tk=None,
                     lens_k=None):
    """q, k, v, dO with H = 4, the query ids, and key ids in which query
    segment 1 finds no key (its keys carry an id no query has, so the ids
    are not sorted): with ``tk``, Tk = tk keys in documents ``lens_k``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    seg = _segments(lens, total, device)
    tk = tk or total
    segk = _segments(lens_k or lens, tk, device)
    segk[segk == 1] = 10 ** 6
    q, k, v, do = [torch.randn(1, 4, n, d, device=device, generator=gen)
                   .to(dtype) for n in (total, tk, tk, total)]
    return q, k, v, do, seg, segk


def _check_varlen_backward(q, k, v, do, seg, segk, causal, dtype):
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, segk, causal)
    n0 = (TV.launches_bwd_dkv, TV.launches_bwd_dq)
    got = TV.varlen_backward(q, k, v, seg, segk, o, lse, do, causal)
    ref = TV._varlen_bwd_ref(q, k, v, seg, segk, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (TV.launches_bwd_dkv, TV.launches_bwd_dq) == (n0[0] + 1,
                                                         n0[1] + 1)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a.float()).all())
        assert _worst_of_tol(a, b, *_tol(dtype)) <= 1.0
    dead_q = (seg[0] < 0) | (seg[0] == 1)
    dead_k = (segk[0] < 0) | (segk[0] == 10 ** 6)
    assert bool((got[0][:, :, dead_q] == 0).all())
    assert bool((got[1][:, :, dead_k] == 0).all())
    assert bool((got[2][:, :, dead_k] == 0).all())


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens,total", _BWD_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_varlen_backward_kernels_match_plain(lens, total, causal, d, dtype,
                                             cuda_device):
    """dK/dV and dQ against ``_varlen_bwd_ref``. Query segment 1 finds no
    key (its keys carry another id): its rows get exactly zero dQ, and its
    keys and the padding keys exactly zero dK and dV."""
    _check_varlen_backward(*_varlen_bwd_case(lens, total, d, dtype,
                                             cuda_device, total + d),
                           causal, dtype)


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("tq,lens_q,tk,lens_k", [
    (200, [90, 60, 50], 384, [150, 100, 134]),
    (384, [17, 200, 130], 130, [40, 40, 50]),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_varlen_backward_kernels_tq_ne_tk(tq, lens_q, tk, lens_k, d, dtype,
                                          cuda_device):
    """Tq != Tk, not causal: more keys than queries and the other way
    round, each side with its own ragged end."""
    _check_varlen_backward(*_varlen_bwd_case(lens_q, tq, d, dtype,
                                             cuda_device, tq + tk + d,
                                             tk=tk, lens_k=lens_k),
                           False, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_backward_repeats_to_the_bit(causal, cuda_device):
    """No block writes another's rows (no atomics): two backward calls on
    the same inputs give the same bits (skipped tiles, a padding tail)."""
    q, k, v, do, seg, segk = _varlen_bwd_case(
        _short_documents(4000, 8), 4096, 128, torch.bfloat16, cuda_device,
        29)
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, segk, causal)
    g1 = TV.varlen_backward(q, k, v, seg, segk, o, lse, do, causal)
    g2 = TV.varlen_backward(q, k, v, seg, segk, o, lse, do, causal)
    torch.cuda.synchronize()
    for a, b_ in zip(g1, g2):
        assert torch.equal(a, b_)


def test_varlen_autograd_launches_each_kernel_once(cuda_device):
    from paddle_tpu_torch.incubate.nn import functional as IF

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    cu = [0, 100, 250, 300]
    q, k, v = (torch.randn(300, 2, 128, device=cuda_device, generator=gen)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    n0 = (TV.launches, TV.launches_bwd_dkv, TV.launches_bwd_dq)
    out, _ = IF.flash_attn_unpadded(q, k, v, cu, cu, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (TV.launches, TV.launches_bwd_dkv, TV.launches_bwd_dq) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    assert out.shape == q.shape and q.grad.shape == q.shape


def test_varlen_backward_rejects_what_it_cannot_take(cuda_device):
    q = torch.ones(1, 2, 128, 96, device=cuda_device)
    seg = torch.zeros(1, 128, dtype=torch.int32, device=cuda_device)
    lse = torch.zeros(1, 2, 128, device=cuda_device)
    with pytest.raises(ValueError):
        TV._launch_bwd(q, q, q, seg, seg, q, lse, q, True)   # head_dim 96
    q = torch.ones(1, 2, 128, 64, device=cuda_device)
    with pytest.raises(ValueError):
        TV._launch_bwd_dq(q, q, q, seg, seg, q, lse,
                          lse[:, :, :64], True)               # delta shape
    with pytest.raises(TypeError):
        TV._launch_bwd(q.half(), q.half(), q.half(), seg, seg, q.half(),
                       lse, q.half(), True)


# -- paged attention (the serving decode and chunked-prefill steps) ---------

def _paged_case(rows, n_pad, hq, hkv, d, bs, max_blocks, dtype, device,
                seed, layers=2):
    """Stacked random caches, q and the step's metadata for rows
    [(n_tokens, start_pos)], each row on its own pages, and n_pad padding
    tokens in the trash row (block-table row all page 0, positions from 0,
    which run past max_seq when n_pad > max_seq)."""
    g = torch.Generator(device=device).manual_seed(seed)
    B1 = len(rows) + 1
    nb = 1 + len(rows) * max_blocks
    kc = torch.randn(layers, nb, hkv, bs, d, device=device,
                     generator=g).to(dtype)
    vc = torch.randn(layers, nb, hkv, bs, d, device=device,
                     generator=g).to(dtype)
    enc = torch.zeros(B1, dtype=torch.int64)
    dec = torch.zeros(B1, dtype=torch.int64)
    this = torch.zeros(B1, dtype=torch.int64)
    bt = torch.zeros(B1, max_blocks, dtype=torch.int64)
    pages = torch.randperm(nb - 1, generator=torch.Generator()
                           .manual_seed(seed))[:len(rows) * max_blocks] + 1
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        bt[i] = pages[i * max_blocks:(i + 1) * max_blocks]
    this[-1] = enc[-1] = n_pad
    cu = torch.zeros(B1 + 1, dtype=torch.int64)
    cu[1:] = torch.cumsum(this, 0)
    T = int(cu[-1])
    q = torch.randn(T, hq, d, device=device, generator=g).to(dtype)
    rope = torch.zeros(2, B1, 1, max_blocks * bs, d // 2, device=device)
    md = IF.paged_metadata(T, enc.to(device), dec.to(device), cu.to(device),
                           bt.to(device), bs, rope)
    return q, kc, vc, md, bt.to(device)


# (rows [(tokens, start)], padding tokens, block size, blocks a row): decode
# rows up to position 4,095, the same over 512 blocks a row (beyond the 256
# table entries the f32 kernel keeps in shared memory, so it reads the
# table from global memory), a chunked step with a chunk crossing pages
# and padding past max_seq = 256, and chunks deep in a 512-block table
# (rows far longer than the bf16 kernel keeps S for, so it streams K and V)
_PAGED_CASES = {
    "decode": ([(1, 4095), (1, 0), (1, 31), (1, 1000), (1, 2047)], 3, 32,
               128),
    "decode_wide_table": ([(1, 4095), (1, 2100), (1, 7)], 2, 8, 512),
    "chunked": ([(40, 30), (1, 200), (100, 0), (7, 249)], 300, 16, 16),
    "chunked_wide_table": ([(40, 4000), (33, 2000), (1, 4095)], 5, 8, 512),
}


# every width class of the kernel (8 * P lanes a key covering D: P = 4, 8,
# 16 and 32), a D that leaves part of its class's lanes idle (72), and
# every head grouping (G = 3 leaves a block of 4 query heads one short)
@pytest.mark.parametrize("case", sorted(_PAGED_CASES))
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [256, 128, 72, 64, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_matches_plain(case, g, d, dtype,
                                              cuda_device):
    rows, n_pad, bs, mb = _PAGED_CASES[case]
    hkv = 2
    q, kc, vc, md, bt = _paged_case(rows, n_pad, hkv * g, hkv, d, bs, mb,
                                    dtype, cuda_device, seed=d + g)
    before = PA.launches
    for layer in (0, 1):
        got = PA.paged_attention(q, kc, vc, layer, md.t2b, md.pos, bt)
        ref = PA._paged_attention_ref(q, kc[layer], vc[layer], md.t2b,
                                      md.pos, bt)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _worst_of_tol(got, ref, *_tol(dtype)) <= 1.0, layer
    assert PA.launches == before + 2
    again = PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt)
    assert torch.equal(again, got)                     # the same bits


# The bf16 kernel's query tiles (up to 32 consecutive tokens of a row): a row of 1, 5, 31, 32, 33 or 120 tokens of the step at
# depths 0, 31, 32, 96 and max_seq - 1 (= 127: 16-slot pages, 8 a row),
# beside a decode row, a 7-token row, and trash-row padding whose positions
# run past max_seq. D 256 takes 32-key chunks, so its rows past 96 keys
# stream K and V through the ring instead of keeping S whole.
_TILE_MAX_SEQ = 128
_TILE_ROWS = [(n, depth) for n in (1, 5, 31, 32, 33, 120)
              for depth in (0, 31, 32, 96, _TILE_MAX_SEQ - 1)
              if n + depth <= _TILE_MAX_SEQ]


@pytest.mark.parametrize("tokens,depth", _TILE_ROWS)
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [256, 128, 64])
def test_paged_attention_tiles_match_plain(tokens, depth, g, d, cuda_device):
    rows = [(1, 50), (tokens, depth), (7, 3)]
    q, kc, vc, md, bt = _paged_case(rows, _TILE_MAX_SEQ + 20, 2 * g, 2, d,
                                    16, _TILE_MAX_SEQ // 16, torch.bfloat16,
                                    cuda_device, seed=tokens + depth + d + g)
    got = PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt)
    ref = PA._paged_attention_ref(q, kc[1], vc[1], md.t2b, md.pos, bt)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert _worst_of_tol(got, ref, *_tol(torch.bfloat16)) <= 1.0
    k8, v8, ks, vs = _int8_pools(kc, seed=tokens + depth)
    got8 = PA.paged_attention(q, k8, v8, 1, md.t2b, md.pos, bt, ks, vs)
    ref8 = PA._paged_attention_ref(q, k8[1], v8[1], md.t2b, md.pos, bt,
                                   ks[1], vs[1])
    kd = (k8.float() * ks[..., None]).to(torch.bfloat16)
    vd = (v8.float() * vs[..., None]).to(torch.bfloat16)
    deq = PA.paged_attention(q, kd, vd, 1, md.t2b, md.pos, bt)
    torch.cuda.synchronize()
    assert _worst_of_tol(got8, ref8, *_tol(torch.bfloat16)) <= 1.0
    assert torch.equal(got8, deq)


def test_paged_attention_takes_rows_in_any_order(cuda_device):
    """Tokens of a row need not be contiguous: each run of a row's tokens
    is its own tile, and when the runs outnumber the grid's blocks the
    blocks take several tiles each."""
    q, kc, vc, md, bt = _paged_case([(20, 40), (9, 0), (1, 77)], 0, 4, 2,
                                    128, 16, 8, torch.bfloat16, cuda_device,
                                    seed=3)
    perm = torch.randperm(q.shape[0], generator=torch.Generator()
                          .manual_seed(3)).to(cuda_device)
    t2b, pos, qp = md.t2b[perm], md.pos[perm], q[perm].contiguous()
    got = PA.paged_attention(qp, kc, vc, 0, t2b, pos, bt)
    ref = PA._paged_attention_ref(qp, kc[0], vc[0], t2b, pos, bt)
    torch.cuda.synchronize()
    assert _worst_of_tol(got, ref, *_tol(torch.bfloat16)) <= 1.0


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_paged_attention_graph_replay_and_repeats_to_the_bit(pages,
                                                             cuda_device):
    """No atomics and a grid fixed by the shapes: calls repeat to the bit,
    and a call captured in a CUDA graph replays the eager call's bits
    (decode rows and a chunked row, with padding)."""
    q, kc, vc, md, bt = _paged_case([(1, 90), (40, 60), (1, 5)], 9, 4, 2,
                                    128, 32, 6, torch.bfloat16, cuda_device,
                                    seed=8)
    scales = ()
    if pages == "int8":
        k8, v8, ks, vs = _int8_pools(kc, seed=8)
        kc, vc, scales = k8, v8, (ks, vs)
    eager = [PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt, *scales)
             for _ in range(3)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt, *scales)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_attention(q, kc, vc, 1, md.t2b, md.pos, bt, *scales)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for e in eager[1:]:
        assert torch.equal(e, eager[0])
    assert torch.equal(out, eager[0])


def test_paged_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    for d, dtype, err in ((12, torch.bfloat16, ValueError),
                          (264, torch.bfloat16, ValueError),
                          (64, torch.float16, TypeError)):
        q, kc, vc, md, bt = _paged_case([(1, 5)], 1, 2, 2, d, 16, 2,
                                        torch.float32, cuda_device, seed=1)
        with pytest.raises(err):
            PA.paged_attention(q.to(dtype), kc.to(dtype), vc.to(dtype), 0,
                               md.t2b, md.pos, bt)


# -- the serving decode window: CUDA graphs against the eager body -----------

_WINDOW_CFG = dict(vocab_size=512, hidden_size=256, num_layers=2,
                   num_heads=4, num_kv_heads=2, ffn_size=512, block_size=16,
                   num_blocks=64, max_batch=4, max_blocks_per_seq=8,
                   token_budget=64, dtype="bfloat16")
_MODES = {"greedy": [None, None, None],
          "topk": [TS.SamplingParams(0.8, 20, 0.9), None,
                   TS.SamplingParams(1.1, 5, 1.0)],
          "full": [TS.SamplingParams(1.0, 0, 0.95), None,
                   TS.SamplingParams(0.7, 20, 0.8)]}


@pytest.fixture(scope="module")
def window_model():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    cfg = TS.PagedServingConfig(**_WINDOW_CFG)
    return TS.PagedCausalLM(cfg, device="cuda", seed=5), cfg


def _at_decode_tip(model, cfg, sampling, seed=3):
    eng = TS.ServingEngine.from_model(model, cfg, seed=seed, device="cuda")
    rng = np.random.RandomState(11)
    for i, sp in enumerate(sampling):
        eng.add_request(list(rng.randint(1, cfg.vocab_size, 9 + 7 * i)),
                        max_new_tokens=24, sampling=sp)
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    return eng


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_decode_window_graph_replay_equals_eager(mode, window_model):
    model, cfg = window_model
    graph = _at_decode_tip(model, cfg, _MODES[mode])
    eager = _at_decode_tip(model, cfg, _MODES[mode])
    while graph.pending():
        got = graph.decode_run(8)
        assert got == eager._decode_run_eager(8)
    assert not eager.pending()
    assert {k[1] for k in graph._window_fns} == {mode}
    assert all(w.graph is not None for w in graph._window_fns.values())
    assert all(w.graph is None for w in eager._window_fns.values())


def test_decode_window_reuses_its_graph_and_counts_replays(window_model):
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    model, cfg = window_model
    L = cfg.num_layers
    eng = _at_decode_tip(model, cfg, _MODES["topk"])
    reset_launch_counts()
    eng.decode_run(4)                        # capture: one warm-up body
    assert len(eng._window_fns) == 1
    (key, win), = eng._window_fns.items()
    graph = win.graph
    assert launch_counts()["rms_norm"] == 5 * (2 * L + 1)
    assert launch_counts()["paged_attention"] == 5 * L
    assert launch_counts()["rope_append"] == 5 * L
    assert win.graph_launches["rms_norm"] == 2 * L + 1
    assert win.graph_launches["paged_attention"] == L
    assert win.graph_launches["rope_append"] == L
    reset_launch_counts()
    eng.decode_run(4)                        # the same key: replays only
    assert eng._window_fns == {key: win} and win.graph is graph
    counts = launch_counts()
    assert counts["rms_norm"] == 4 * (2 * L + 1)
    assert counts["paged_attention"] == 4 * L
    assert counts["rope_append"] == 4 * L
    assert counts["varlen_attention_fwd"] == 0
    assert counts["aligned16_copies"] == 0


def test_decode_window_capture_leaves_pages_and_buffers(window_model):
    model, cfg = window_model
    eng = _at_decode_tip(model, cfg, _MODES["full"])
    rows = [r for r in eng.pending()]
    win = TS._DecodeWindow(eng, 4, "full")
    B1 = cfg.max_batch + 1
    bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
    for i, r in enumerate(rows):
        eng._ensure_pages(r, r.cached + 4)
        bt[i, :len(r.pages)] = r.pages
    this = np.array([1, 1, 1, 0, 1])
    cu = np.concatenate([[0], np.cumsum(this)])
    dec = np.array([r.cached for r in rows] + [0, 0])
    with torch.inference_mode():
        win.stage(np.array([5, 6, 7, 0]), np.array([0, 0, 0, 0, 1]), dec,
                  this, cu, bt, np.full(B1, 0.9, np.float32),
                  np.zeros(B1, np.int64), np.ones(B1, np.float32),
                  np.arange(B1) + 100)
        torch.cuda.synchronize()
        buf, kc, vc = win.buf.clone(), eng._kc.clone(), eng._vc.clone()
        win.capture(torch.cuda.graph_pool_handle())
    assert win.graph is not None
    assert torch.equal(win.buf, buf)
    # every page but the trash page 0 as it was
    assert torch.equal(eng._kc[:, 1:], kc[:, 1:])
    assert torch.equal(eng._vc[:, 1:], vc[:, 1:])


# -- the int8 cache-KV path: quantize-on-append and int8 paged attention -----

def _kv_quant_case(T, hkv, d, dtype, device, seed, layers=2, nb=40, bs=16):
    """k [T, hkv, d] contiguous and v a strided view of a packed qkv, token
    0's k head 0 all zero, token 1's a tie head (max 127, so the scale is 1,
    and values n + 0.5); distinct (page, slot) per token, none on page 0;
    zeroed int8 pools and f32 scale pools."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(T, 6 * hkv * d, device=device, generator=g) \
        * torch.exp(torch.randn(T, 1, device=device, generator=g) * 2)
    qkv = qkv.to(dtype)
    k = qkv[:, 4 * hkv * d:5 * hkv * d].reshape(T, hkv, d).contiguous()
    v = qkv[:, 5 * hkv * d:].reshape(T, hkv, d)
    k[0, 0] = 0
    if T > 1:
        k[1, 0] = (torch.arange(d, device=device) % 9 + 0.5).to(dtype)
        k[1, 0, 0] = 127
    idx = torch.randperm((nb - 1) * bs, generator=torch.Generator()
                         .manual_seed(seed))[:T].to(device)
    page, slot = 1 + idx // bs, idx % bs
    pools = [torch.zeros(layers, nb, hkv, bs, d, dtype=torch.int8,
                         device=device) for _ in range(2)]
    pools += [torch.zeros(layers, nb, hkv, bs, device=device)
              for _ in range(2)]
    return k, v, pools, page, slot


@pytest.mark.parametrize("hkv", [1, 2, 8])
@pytest.mark.parametrize("d", [256, 128, 72, 64, 32])
@pytest.mark.parametrize("T", [8, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_quant_kernel_matches_plain_bit_for_bit(T, d, hkv, dtype,
                                                   cuda_device):
    from paddle_tpu_torch.ops.kernels import kv_quant as KQ

    k, v, pools, page, slot = _kv_quant_case(T, hkv, d, dtype, cuda_device,
                                             seed=T + d + hkv)
    ref = [p.clone() for p in pools]
    before = KQ.launches
    KQ.kv_quant(k, v, *pools, 1, page, slot)
    KQ._kv_quant_ref(k, v, *ref, 1, page, slot)
    torch.cuda.synchronize()
    assert KQ.launches == before + 1
    for got, want in zip(pools, ref):
        assert torch.equal(got, want)
    assert not pools[0][0].any() and not pools[2][0].any()   # layer 0
    # the zero head and the tie head
    assert float(pools[2][1, page[0], 0, slot[0]]) == float(np.float32(1e-8))
    if T > 1:
        assert float(pools[2][1, page[1], 0, slot[1]]) == 1.0
        ties = (torch.arange(1, d) % 9 + 0.5).double()
        assert torch.equal(pools[0][1, page[1], 0, slot[1], 1:].cpu(),
                           torch.round(ties).to(torch.int8))


def test_kv_quant_kernel_rejects_what_it_cannot_take(cuda_device):
    from paddle_tpu_torch.ops.kernels import kv_quant as KQ

    k, v, pools, page, slot = _kv_quant_case(4, 2, 64, torch.float32,
                                             cuda_device, seed=1)
    with pytest.raises(TypeError):
        KQ.kv_quant(k.half(), v.half(), *pools, 0, page, slot)
    with pytest.raises(TypeError):
        KQ.kv_quant(k, v, pools[0].float(), pools[1].float(), pools[2],
                    pools[3], 0, page, slot)
    with pytest.raises(ValueError):
        KQ.kv_quant(k, v, *pools, 2, page, slot)


def _int8_pools(kc, seed):
    """int8 pools and f32 scale pools beside the float pools kc's shape."""
    g = torch.Generator(device=kc.device).manual_seed(seed)
    codes = [torch.randint(-127, 128, kc.shape, generator=g,
                           device=kc.device, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(kc.shape[:-1], generator=g, device=kc.device)
              * 0.05 for _ in range(2)]
    return codes + scales


# every width class and head grouping of the float kernel, over int8 pages:
# against the plain version, and bit for bit against the kernel over pages
# of q's dtype holding the same dequantized values
@pytest.mark.parametrize("case", sorted(_PAGED_CASES))
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [256, 128, 72, 64, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_int8_kernel_matches_plain(case, g, d, dtype,
                                                   cuda_device):
    rows, n_pad, bs, mb = _PAGED_CASES[case]
    hkv = 2
    q, kc, vc, md, bt = _paged_case(rows, n_pad, hkv * g, hkv, d, bs, mb,
                                    dtype, cuda_device, seed=d + g)
    k8, v8, ks, vs = _int8_pools(kc, seed=d * g)
    before = (PA.launches, PA.launches_int8)
    for layer in (0, 1):
        got = PA.paged_attention(q, k8, v8, layer, md.t2b, md.pos, bt, ks,
                                 vs)
        ref = PA._paged_attention_ref(q, k8[layer], v8[layer], md.t2b,
                                      md.pos, bt, ks[layer], vs[layer])
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _worst_of_tol(got, ref, *_tol(dtype)) <= 1.0, layer
    assert (PA.launches, PA.launches_int8) == (before[0], before[1] + 2)
    kd = (k8.float() * ks[..., None]).to(dtype)
    vd = (v8.float() * vs[..., None]).to(dtype)
    same = PA.paged_attention(q, kd, vd, 1, md.t2b, md.pos, bt)
    assert torch.equal(got, same)


def test_paged_attention_int8_rejects_what_it_cannot_take(cuda_device):
    q, kc, vc, md, bt = _paged_case([(1, 5)], 1, 2, 2, 64, 16, 2,
                                    torch.float32, cuda_device, seed=1)
    k8, v8, ks, vs = _int8_pools(kc, seed=1)
    with pytest.raises(ValueError):                     # scales missing
        PA.paged_attention(q, k8, v8, 0, md.t2b, md.pos, bt)
    with pytest.raises(ValueError):                     # scales on floats
        PA.paged_attention(q, kc, vc, 0, md.t2b, md.pos, bt, ks, vs)
    with pytest.raises(TypeError):
        PA.paged_attention(q.half(), k8, v8, 0, md.t2b, md.pos, bt, ks, vs)


@pytest.fixture(scope="module")
def window_model8():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    cfg = TS.PagedServingConfig(**_WINDOW_CFG, cache_quant="int8")
    return TS.PagedCausalLM(cfg, device="cuda", seed=5), cfg


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_int8_decode_window_graph_replay_equals_eager(mode, window_model8):
    model, cfg = window_model8
    graph = _at_decode_tip(model, cfg, _MODES[mode])
    eager = _at_decode_tip(model, cfg, _MODES[mode])
    assert graph._kc.dtype == torch.int8
    while graph.pending():
        got = graph.decode_run(8)
        assert got == eager._decode_run_eager(8)
    assert not eager.pending()
    assert all(w.graph is not None for w in graph._window_fns.values())
    assert torch.equal(graph._ks[:, 1:], eager._ks[:, 1:])
    assert torch.equal(graph._kc[:, 1:], eager._kc[:, 1:])


def test_int8_decode_window_counts_replays(window_model8):
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    model, cfg = window_model8
    L = cfg.num_layers
    eng = _at_decode_tip(model, cfg, _MODES["topk"])
    eng.decode_run(4)                        # captures
    (key, win), = eng._window_fns.items()
    assert win.graph_launches["paged_attention_int8"] == L
    assert win.graph_launches["rope_append"] == L
    assert win.graph_launches["kv_quant"] == 0
    reset_launch_counts()
    eng.decode_run(4)                        # replays only
    counts = launch_counts()
    assert counts["rms_norm"] == 4 * (2 * L + 1)
    assert counts["paged_attention_int8"] == 4 * L
    assert counts["rope_append"] == 4 * L
    assert counts["kv_quant"] == 0
    assert counts["paged_attention"] == 0
    assert counts["varlen_attention_fwd"] == 0
    assert counts["aligned16_copies"] == 0


def test_int8_decode_window_capture_leaves_pages_and_scales(window_model8):
    model, cfg = window_model8
    eng = _at_decode_tip(model, cfg, _MODES["full"])
    rows = [r for r in eng.pending()]
    win = TS._DecodeWindow(eng, 4, "full")
    B1 = cfg.max_batch + 1
    bt = np.zeros((B1, cfg.max_blocks_per_seq), np.int64)
    for i, r in enumerate(rows):
        eng._ensure_pages(r, r.cached + 4)
        bt[i, :len(r.pages)] = r.pages
    this = np.array([1, 1, 1, 0, 1])
    cu = np.concatenate([[0], np.cumsum(this)])
    dec = np.array([r.cached for r in rows] + [0, 0])
    with torch.inference_mode():
        win.stage(np.array([5, 6, 7, 0]), np.array([0, 0, 0, 0, 1]), dec,
                  this, cu, bt, np.full(B1, 0.9, np.float32),
                  np.zeros(B1, np.int64), np.ones(B1, np.float32),
                  np.arange(B1) + 100)
        torch.cuda.synchronize()
        before = [t.clone() for t in (win.buf, eng._kc, eng._vc, eng._ks,
                                      eng._vs)]
        win.capture(torch.cuda.graph_pool_handle())
    assert win.graph is not None
    assert torch.equal(win.buf, before[0])
    # every page and every scale but the trash page 0's as they were
    for now, was in zip((eng._kc, eng._vc, eng._ks, eng._vs), before[1:]):
        assert torch.equal(now[:, 1:], was[:, 1:])


# -- RoPE and cache append: one kernel a layer ------------------------------

# (rows [(tokens, start position)], trash-row padding tokens): the CPU test's
# steps (tests/test_torch_rope_append.py), then llama_1b's decode (8 rows at
# the serving run's depths), speculative verify (8 rows of 5, padded to 64)
# and 256-token chunked and fresh-prefill steps; no step pads past a page,
# so no two tokens write one slot and every page compares
_ROPE_STEPS = {
    "t1": ([(1, 13)], 0),
    "t8": ([(1, 3 + 5 * i) for i in range(8)], 0),
    "t37": ([(1, 13), (9, 20), (20, 3)], 7),
    "decode": ([(1, 18 + 22 * i) for i in range(8)], 0),
    "verify": ([(5, 96 + 12 * i) for i in range(8)], 24),
    "chunked": ([(120, 64), (100, 90), (1, 170), (35, 0)], 0),
    "fresh": ([(128, 0), (100, 0)], 28),
}
_ROPE_SHAPES = {"4-2-64": (4, 2, 64, 8), "16-8-128": (16, 8, 128, 8),
                "llama_1b": (16, 8, 128, 32)}
_ROPE_CASES = [(step, shape) for step in ("t1", "t8", "t37")
               for shape in ("4-2-64", "16-8-128")] + \
    [(step, "llama_1b") for step in ("decode", "verify", "chunked", "fresh")]


def _rope_case(step, shape, dtype, int8, device, seed, canary=None):
    """qkv [T, (HQ + 2 HKV) D] (k and v span magnitudes; token 0's k head 0
    zero, the last token's v head 0 a tie head), the stacked pools [2, 64,
    HKV, bs, D] (random, or filled with ``canary``), and the step's
    metadata at the real RoPE angles. Each row on pages of its own."""
    rows, n_pad = _ROPE_STEPS[step]
    hq, hkv, d, bs = _ROPE_SHAPES[shape]
    mb, nb = 6, 64
    g = torch.Generator(device=device).manual_seed(seed)
    B1 = len(rows) + 1
    enc = torch.zeros(B1, dtype=torch.int64)
    dec = torch.zeros(B1, dtype=torch.int64)
    this = torch.zeros(B1, dtype=torch.int64)
    bt = torch.zeros(B1, mb, dtype=torch.int64)
    free = 1
    for i, (n, start) in enumerate(rows):
        dec[i], this[i] = start, n
        used = -(-(start + n) // bs)
        bt[i, :used] = free + torch.arange(used)
        free += used
    this[-1] = enc[-1] = n_pad
    cu = torch.zeros(B1 + 1, dtype=torch.int64)
    cu[1:] = torch.cumsum(this, 0)
    T = int(cu[-1])
    qkv = torch.randn(T, (hq + 2 * hkv) * d, device=device, generator=g)
    qkv[:, hq * d:] *= torch.exp(torch.randn(T, 1, device=device,
                                             generator=g))
    qkv[0, hq * d:(hq + 1) * d] = 0
    tie = (hq + hkv) * d
    qkv[-1, tie:tie + d] = torch.arange(d, device=device) % 9 + 0.5
    qkv[-1, tie] = 127
    qkv = qkv.to(dtype)
    half = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32) * 2.0
                             / d))
    ang = torch.arange(mb * bs, dtype=torch.float32)[:, None] * inv
    rope = torch.stack([torch.cos(ang), torch.sin(ang)])[:, None, None] \
        .expand(2, B1, 1, mb * bs, half).to(device)
    md = IF.paged_metadata(T, enc.to(device), dec.to(device), cu.to(device),
                           bt.to(device), bs, rope)
    shape5 = (2, nb, hkv, bs, d)
    if int8:
        pools = [torch.randint(-127, 128, shape5, device=device, generator=g,
                               dtype=torch.int8) for _ in range(2)]
        pools += [torch.rand(shape5[:-1], device=device, generator=g) * 0.05
                  for _ in range(2)]
    else:
        pools = [torch.randn(shape5, device=device, generator=g).to(dtype)
                 for _ in range(2)] + [None, None]
    if canary is not None:
        for p in pools:
            if p is not None:
                p.fill_(canary)
    return qkv, pools, md


def _rope_run(fn, qkv, pools, md, layer, heads_first):
    """fn's outputs (a tuple) and the pools it wrote (copies of ``pools``)."""
    mine = [None if p is None else p.clone() for p in pools]
    out = fn(qkv, *mine, layer, md, heads_first=heads_first)
    return (out if heads_first else (out,)), mine


@pytest.mark.parametrize("layout", ["paged", "heads_first"])
@pytest.mark.parametrize("case", _ROPE_CASES, ids="-".join)
@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_append_kernel_matches_plain_bit_for_bit(dtype, pages, case,
                                                      layout, cuda_device):
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    step, shape = case
    heads_first = layout == "heads_first"
    qkv, pools, md = _rope_case(step, shape, dtype, pages == "int8",
                                cuda_device, seed=len(step) + len(shape))
    before = RA.launches
    got, got_pools = _rope_run(RA.rope_append, qkv, pools, md, 1,
                               heads_first)
    want, want_pools = _rope_run(RA._rope_append_ref, qkv, pools, md, 1,
                                 heads_first)
    torch.cuda.synchronize()
    assert RA.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and a.is_contiguous()
        assert _same_bits(a, b)
    for a, b, was in zip(got_pools, want_pools, pools):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            assert torch.equal(a[0], was[0])            # layer 0 untouched
    if pages == "int8":                 # the zero head and the tie head
        ks, vs = got_pools[2][1], got_pools[3][1]
        assert float(ks[md.page[0], 0, md.slot[0]]) \
            == float(np.float32(1e-8))
        assert float(vs[md.page[-1], 0, md.slot[-1]]) == 1.0


@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_append_leaves_other_slots_untouched(dtype, pages,
                                                  cuda_device):
    """Pools filled with a canary: after the kernel, every (page, head,
    slot) row of the layer that no token writes, and every other layer,
    holds the canary to the bit; the written rows hold the plain
    version's bits (the element route too: qkv 2 elements past a 16-byte
    boundary)."""
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    for offset in (0, 2):
        qkv, pools, md = _rope_case("verify", "llama_1b", dtype,
                                    pages == "int8", cuda_device, seed=5,
                                    canary=3)
        if offset:
            wide = torch.zeros(qkv.shape[0], qkv.shape[1] + offset,
                               dtype=dtype, device=cuda_device)
            wide[:, offset:] = qkv
            qkv = wide[:, offset:]
        got, got_pools = _rope_run(RA.rope_append, qkv, pools, md, 1, False)
        want, want_pools = _rope_run(RA._rope_append_ref, qkv, pools, md, 1,
                                     False)
        torch.cuda.synchronize()
        assert _same_bits(got[0], want[0])
        written = torch.zeros(pools[0].shape[1:4], dtype=torch.bool,
                              device=cuda_device)
        written.transpose(1, 2)[md.page, md.slot] = True     # [nb, hkv, bs]
        for a, b in zip(got_pools, want_pools):
            if a is None:
                continue
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            assert bool((a[0] == 3).all())
            assert bool((a[1][~written] == 3).all())
            assert not bool((a[1][written] == 3).all())


@pytest.mark.parametrize("pages", ["float", "int8"])
def test_rope_append_graph_replay_equals_eager(pages, cuda_device):
    """One capture of the kernel in a CUDA graph, replayed on new qkv and
    new angles copied into its inputs, gives the eager call's q and pools
    to the bit."""
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    qkv, pools, md = _rope_case("decode", "llama_1b", torch.bfloat16,
                                pages == "int8", cuda_device, seed=8)
    new_qkv, _, new_md = _rope_case("t8", "16-8-128", torch.bfloat16,
                                    False, cuda_device, seed=9)
    assert new_qkv.shape == qkv.shape
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        RA.rope_append(qkv, *pools, 1, md)            # warm-up
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q = RA.rope_append(qkv, *pools, 1, md)
    qkv.copy_(new_qkv)
    md.cos.copy_(new_md.cos)
    md.sin.copy_(new_md.sin)
    want, want_pools = _rope_run(RA.rope_append, qkv, pools, md, 1, False)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(q, want[0])
    for a, b in zip(pools, want_pools):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_rope_append_rejects_what_it_cannot_take(cuda_device):
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    qkv, pools, md = _rope_case("t8", "4-2-64", torch.float32, True,
                                cuda_device, seed=1)
    before = RA.launches
    with pytest.raises(TypeError):
        RA.rope_append(qkv.half(), *pools, 0, md)
    with pytest.raises(TypeError):
        RA.rope_append(qkv, pools[0].bfloat16(), pools[1].bfloat16(), None,
                       None, 0, md)
    with pytest.raises(ValueError):
        RA.rope_append(qkv, *pools, 2, md)
    with pytest.raises(ValueError):             # D not a multiple of 8
        c = [torch.zeros(2, 8, 1, 8, 36, dtype=torch.float32,
                         device=cuda_device) for _ in range(2)]
        RA.rope_append(qkv[:, :6 * 36], *c, None, None, 0,
                       md._replace(cos=md.cos[..., :18].contiguous(),
                                   sin=md.sin[..., :18].contiguous()))
    assert RA.launches == before


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_engine_streams_equal_through_plain_rope_append(cache, window_model,
                                                        window_model8):
    """A small engine's greedy streams (eager steps, then window graphs)
    through the kernel equal the same engine's with only rope_append
    patched to its plain version, token for token."""
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    model, cfg = window_model if cache == "bf16" else window_model8

    def streams():
        eng = _at_decode_tip(model, cfg, _MODES["greedy"])
        while eng.pending():
            assert eng.decode_run(8)
        return [list(r.generated) for r in eng._requests.values()]

    def plain(qkv, kc, vc, ks, vs, layer, md, heads_first=False):
        return RA._rope_append_ref(qkv, kc, vc, ks, vs, layer, md,
                                   heads_first=heads_first)

    before = RA.launches
    got = streams()
    assert RA.launches > before
    kernel = RA.rope_append
    RA.rope_append = plain
    try:
        before = RA.launches
        want = streams()
        assert RA.launches == before
    finally:
        RA.rope_append = kernel
    assert got == want and all(len(s) == 24 for s in got)


# -- weight streaming: the dequant kernel and streamed decode windows --------

# (in, out) of llama_1b's four streamed Linears (qkv, proj, gate_up, down),
# and groups with an input width that is not a multiple of 32 (int4 padding
# rows) and output widths that are multiples of 8 only
_DEQUANT_GROUPS = {
    "llama_1b": [(2048, 4096), (2048, 2048), (2048, 11264), (5632, 2048)],
    "odd_in": [(100, 64), (33, 200), (1, 16), (257, 48)],
}


def _dequant_group(shapes, mode, device, seed):
    from paddle_tpu_torch.inference import weight_stream as TW

    g = torch.Generator(device=device).manual_seed(seed)
    segs = []
    for n_in, n_out in shapes:
        w = (torch.randn(n_in, n_out, device=device, generator=g) * 0.05) \
            .to(torch.bfloat16)
        w[:, 3] = 0
        q, s = (TW.quantize_int4_grouped(w) if mode == "int4"
                else TW.quantize_per_channel(w))
        segs.append((torch.from_numpy(q).to(device),
                     torch.from_numpy(s).to(device), n_in))
    return segs


def _plain_dequant(seg, dtype):
    from paddle_tpu_torch.ops.kernels import weight_dequant as WD

    q, s, n_in = seg
    return WD.dequantize(q, s, dtype) if q.dtype == torch.int8 \
        else WD.dequantize_int4(q, s, dtype, n_in)


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("group", sorted(_DEQUANT_GROUPS))
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weight_dequant_kernel_matches_plain_bit_for_bit(dtype, mode, group,
                                                         offset,
                                                         cuda_device):
    """One launch a group, every output bit for bit its plain version's;
    the segments sit in one flat buffer at 16-byte aligned offsets (and,
    with ``offset``, 8 elements past a 512-byte boundary), the bytes between
    them untouched; a second launch repeats the bits."""
    from paddle_tpu_torch.ops.kernels import weight_dequant as WD

    shapes = _DEQUANT_GROUPS[group]
    segs = _dequant_group(shapes, mode, cuda_device, len(group))
    esz = torch.empty((), dtype=dtype).element_size()
    starts, o = [], 0
    for n_in, n_out in shapes:
        o += offset
        starts.append(o)
        o += n_in * n_out + 512 // esz
        o = -(-o // (16 // esz)) * (16 // esz)
    buf = torch.full((o,), 7.0, dtype=dtype, device=cuda_device)
    outs = [buf[s:s + n_in * n_out].view(n_in, n_out)
            for s, (n_in, n_out) in zip(starts, shapes)]
    before = WD.launches
    WD.weight_dequant(segs, outs)
    torch.cuda.synchronize()
    assert WD.launches == before + 1
    for seg, out in zip(segs, outs):
        assert _same_bits(out, _plain_dequant(seg, dtype))
    mask = torch.ones(o, dtype=torch.bool, device=cuda_device)
    for s, (n_in, n_out) in zip(starts, shapes):
        mask[s:s + n_in * n_out] = False
    assert bool((buf[mask] == 7.0).all())
    first = [t.clone() for t in outs]
    WD.weight_dequant(segs, outs)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(outs, first))


def test_weight_dequant_kernel_rejects_what_it_cannot_take(cuda_device):
    from paddle_tpu_torch.ops.kernels import weight_dequant as WD

    (seg,) = _dequant_group([(64, 32)], "int8", cuda_device, 1)
    out = torch.empty(64, 32, dtype=torch.bfloat16, device=cuda_device)
    before = WD.launches
    with pytest.raises(TypeError):
        WD.weight_dequant([seg], [out.half()])
    with pytest.raises(TypeError):
        WD.weight_dequant([(seg[0].short(), seg[1], 64)], [out])
    with pytest.raises(ValueError):             # width not a multiple of 8
        (odd,) = _dequant_group([(64, 12)], "int8", cuda_device, 2)
        WD.weight_dequant([odd], [torch.empty(64, 12, dtype=torch.bfloat16,
                                              device=cuda_device)])
    flat = torch.empty(64 * 32 + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):             # 2 bytes past a boundary
        WD.weight_dequant([seg], [flat[1:].view(64, 32)])
    wide = torch.empty(64, 40, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):             # strided output
        WD.weight_dequant([seg], [wide[:, :32]])
    with pytest.raises(ValueError):             # another device
        WD.weight_dequant([seg], [out.cpu()])
    assert WD.launches == before


@pytest.fixture(scope="module")
def stream_model():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    cfg = TS.PagedServingConfig(**_WINDOW_CFG)
    return TS.PagedCausalLM(cfg, device="cuda", seed=7), cfg


def _stream_engine(model, cfg, ws, sampling, seed=3):
    eng = TS.ServingEngine.from_model(model, cfg, seed=seed, device="cuda",
                                      weight_stream=ws)
    rng = np.random.RandomState(11)
    for i, sp in enumerate(sampling):
        eng.add_request(list(rng.randint(1, cfg.vocab_size, 9 + 7 * i)),
                        max_new_tokens=24, sampling=sp)
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    return eng


@pytest.mark.parametrize("ws", ["int8", "int8-noprefetch", "int4"])
def test_streamed_decode_window_graph_replay_equals_eager(ws, stream_model):
    """A streamed engine's window graphs (the dequant on the side stream
    under prefetch, captured with the fork and the join) against the eager
    runner of the same body, token for token, window after window; a
    replayed step counts the dequant kernel once a layer."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    model, cfg = stream_model
    L = cfg.num_layers
    graph = _stream_engine(model, cfg, ws, _MODES["topk"])
    eager = _stream_engine(model, cfg, ws, _MODES["topk"])
    graph.decode_run(4)                              # captures
    assert eager._decode_run_eager(4) is not None
    (win,) = graph._window_fns.values()
    assert win.graph_launches["weight_dequant"] == L
    reset_launch_counts()
    got = graph.decode_run(4)
    counts = launch_counts()
    assert counts["weight_dequant"] == 4 * L
    assert counts["rms_norm"] == 4 * (2 * L + 1)
    assert counts["paged_attention"] == 4 * L
    assert got == eager._decode_run_eager(4)
    while graph.pending():
        assert graph.decode_run(8) == eager._decode_run_eager(8)
    assert not eager.pending()


def test_streamed_engines_equal_the_plain_engine_over_dequantized(
        stream_model):
    """Prefetch, no prefetch and a plain engine whose weights are the
    dequantized ones give the same tokens through the same route (eager
    steps, then window graphs), int8 and int4; repeated on the same
    engine, the graphs give the same bits again."""
    import copy

    from paddle_tpu_torch.inference import weight_stream as TW

    model, cfg = stream_model
    sampling = _MODES["full"]

    def streams(eng):
        while eng.pending():
            if not eng.decode_run(8):
                eng.step()
        return [list(r.generated) for r in eng._requests.values()]

    for mode in ("int8", "int4"):
        modes = ("int8", "int8-noprefetch") if mode == "int8" else ("int4",)
        outs = [streams(_stream_engine(model, cfg, ws, sampling))
                for ws in modes]
        plain = copy.deepcopy(model)
        with torch.no_grad():
            for kind in TW.STREAM_KINDS:
                for lin in getattr(plain, kind):
                    w = lin.weight.to(torch.bfloat16)
                    if mode == "int4":
                        q, s = TW.quantize_int4_grouped(w)
                        d = TW.dequantize_int4(torch.from_numpy(q).cuda(),
                                               torch.from_numpy(s).cuda(),
                                               torch.bfloat16, w.shape[0])
                    else:
                        q, s = TW.quantize_per_channel(w)
                        d = TW.dequantize(torch.from_numpy(q).cuda(),
                                          torch.from_numpy(s).cuda(),
                                          torch.bfloat16)
                    lin.weight.copy_(d.float())
        ref = streams(_stream_engine(plain, cfg, None, sampling))
        assert all(o == ref for o in outs), mode
        again = _stream_engine(model, cfg, mode, sampling)
        assert streams(again) == outs[0]


def test_dropped_engine_frees_its_pools(window_model):
    """An engine dropped after a step frees its pools and windows: nothing
    (the paged wrapper's remembered step among it) keeps them allocated."""
    import gc

    model, cfg = window_model

    def engine_after_a_window():
        eng = _at_decode_tip(model, cfg, _MODES["greedy"])
        eng.decode_run(4)
        eng.step()
        return eng

    def allocated():
        # without the cuBLAS workspace PyTorch keeps a stream (each
        # capture's side stream adds one)
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    engine_after_a_window()          # what the model caches at first use
    before = allocated()
    eng = engine_after_a_window()
    assert allocated() > before
    del eng
    assert allocated() == before


def test_streamed_full_width_windows_equal_plain_over_dequantized():
    """At llama_1b's widths (4 of its 16 layers), where a layer's dequant
    and its products take tens of microseconds, the prefetched int8
    engine's window graphs give, window after window, the tokens of a plain
    engine over the dequantized weights: a missing wait between the side
    stream and a slot's last reader shows here as wrong tokens."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    cfg = TS.PagedServingConfig.llama_1b(num_layers=4)
    model = TS.PagedCausalLM(cfg, device="cuda", seed=9)
    eng = TS.ServingEngine.from_model(model, cfg, seed=3, device="cuda",
                                      weight_stream="int8")
    plain_model = TS.PagedCausalLM(cfg, device="cuda", seed=9)
    with torch.no_grad():
        for kind in ("qkv", "proj", "gate_up", "down"):
            for li, lin in enumerate(getattr(plain_model, kind)):
                lin.weight.copy_(eng._streamer.dequant_layer(li)[kind].float())
    plain = TS.ServingEngine.from_model(plain_model, cfg, seed=3,
                                        device="cuda")
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(1, cfg.vocab_size, n))
               for n in (20, 33, 41, 17, 25, 60, 12, 30)]
    streams = []
    for e in (eng, plain):
        for p in prompts:
            e.add_request(p, max_new_tokens=64)
        while any(r.length - r.cached > 1 for r in e.pending()):
            e.step()
        windows = []
        while e.pending():
            windows.append(e.decode_run(8))
        streams.append(windows)
    assert streams[0] == streams[1]


# -- the registered ops (the deploy artifact's route) ------------------------

def _op_events(fn):
    """The registered ops of the port a call went through (torch.profiler's
    CPU events: a call through the dispatcher records the op's name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(e.name for e in prof.events()
                  if e.name.startswith("paddle_tpu_torch::"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_registered_rms_norm_op_equals_the_direct_call(dtype, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for rows, h in ((256, 2048), (8, 100)):
        x = torch.randn(rows, h, device=cuda_device, generator=g).to(dtype)
        w = torch.randn(h, device=cuda_device, generator=g).to(dtype)
        before = TR.launches
        direct = TR.rms_norm(x, w)
        via_op = torch.ops.paddle_tpu_torch.rms_norm(x, w, 1e-6)
        torch.cuda.synchronize()
        assert TR.launches == before + 2
        assert torch.equal(direct, via_op)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["decode", "chunked"])
def test_registered_paged_attention_op_equals_the_direct_call(case, dtype,
                                                               cuda_device):
    rows, n_pad, bs, mb = _PAGED_CASES[case]
    q, kc, vc, md, bt = _paged_case(rows, n_pad, 4, 2, 128, bs, mb, dtype,
                                    cuda_device, seed=7)
    before = PA.launches
    for layer in (0, 1):
        direct = PA.paged_attention(q, kc, vc, layer, md.t2b, md.pos, bt)
        via_op = torch.ops.paddle_tpu_torch.paged_attention(
            q, kc, vc, layer, md.t2b, md.pos, bt, None, None)
        torch.cuda.synchronize()
        assert torch.equal(direct, via_op)
    assert PA.launches == before + 4


@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", ["decode", "chunked"])
def test_registered_rope_append_op_equals_the_direct_call(step, dtype, pages,
                                                          cuda_device):
    from paddle_tpu_torch.ops.kernels import rope_append as RA

    qkv, pools, md = _rope_case(step, "llama_1b", dtype, pages == "int8",
                                cuda_device, seed=11)
    before = RA.launches
    for layer in (0, 1):
        (direct,), mine = _rope_run(RA.rope_append, qkv, pools, md, layer,
                                    False)
        theirs = [None if p is None else p.clone() for p in pools]
        via_op = torch.ops.paddle_tpu_torch.rope_append(
            qkv, *theirs, layer, md.cos, md.sin, md.page, md.slot)
        torch.cuda.synchronize()
        assert torch.equal(direct, via_op)
        for a, b in zip(mine, theirs):
            assert (a is None and b is None) or torch.equal(a, b)
    assert RA.launches == before + 4


def test_wrappers_launch_directly_outside_tracing(window_model):
    """An eager step launches every kernel without the dispatcher: the
    launch counts rise and no registered op is called; the same call
    through an op is seen."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    model, cfg = window_model
    eng = _at_decode_tip(model, cfg, _MODES["greedy"])
    reset_launch_counts()
    assert _op_events(lambda: eng.step()) == []
    counts = launch_counts()
    L = cfg.num_layers
    assert (counts["rms_norm"], counts["rope_append"],
            counts["paged_attention"]) == (2 * L + 1, L, L)
    x = torch.ones(4, 256, device="cuda")
    assert _op_events(lambda: torch.ops.paddle_tpu_torch.rms_norm(
        x, None, 1e-6)) == ["paddle_tpu_torch::rms_norm"]


@pytest.fixture(scope="module")
def artifact_on_cpu(tmp_path_factory):
    """window_model's config saved on the CPU (a model on the CPU, bf16
    artifact), to be served on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    cfg = TS.PagedServingConfig(**_WINDOW_CFG)
    model = TS.PagedCausalLM(cfg, device="cpu", seed=5)
    path = str(tmp_path_factory.mktemp("artifact") / "lm")
    TS.save_paged_model(path, model)
    return path, cfg, model


def _artifact_at_decode_tip(path, cfg, sampling, seed=3):
    eng = TS.ServingEngine(path, cfg, device="cuda", seed=seed)
    rng = np.random.RandomState(11)
    for i, sp in enumerate(sampling):
        eng.add_request(list(rng.randint(1, cfg.vocab_size, 9 + 7 * i)),
                        max_new_tokens=24, sampling=sp)
    while any(r.length - r.cached > 1 for r in eng.pending()):
        eng.step()
    return eng


def test_cpu_saved_program_launches_the_kernels_on_the_card(artifact_on_cpu):
    """A program exported on the CPU, moved to the card at load: every step
    (a fresh prefill among them: the artifact has only the paged route)
    launches RMSNorm 2L + 1, rope_append L and paged attention L times and
    no varlen kernel; its logits agree with the live model's on the same
    step within bf16 rounding."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    path, cfg, model = artifact_on_cpu
    eng = TS.ServingEngine(path, cfg, device="cuda")
    assert all(p.is_cuda for p in eng._params)
    live = TS.ServingEngine.from_model(model, cfg, device="cuda")
    L = cfg.num_layers
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in (20, 9)]
    for e in (eng, live):
        for p in prompts:
            e.add_request(p, max_new_tokens=4)
    reset_launch_counts()
    eng.step()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["rms_norm"], counts["rope_append"],
            counts["paged_attention"], counts["varlen_attention_fwd"],
            counts["aligned16_copies"]) == (2 * L + 1, L, L, 0, 0)
    live.step()
    a, b = eng.last_logits[:2].float(), live.last_logits[:2].float()
    assert eng.last_logits.dtype == torch.float32
    assert float((a - b).norm() / b.norm()) < 5e-2
    while eng.pending():
        eng.step()
    assert all(len(r.generated) == 4 for r in eng._requests.values())


@pytest.mark.parametrize("mode", ["greedy", "topk"])
def test_artifact_window_captures_and_replays(mode, artifact_on_cpu):
    """An artifact engine's decode windows capture the program's call in a
    CUDA graph at the fixed token length; a replay launches the three
    kernels as counted and equals the eager runner of the same body."""
    from paddle_tpu_torch import launch_counts, reset_launch_counts

    path, cfg, _ = artifact_on_cpu
    L = cfg.num_layers
    graph = _artifact_at_decode_tip(path, cfg, _MODES[mode])
    eager = _artifact_at_decode_tip(path, cfg, _MODES[mode])
    graph.decode_run(4)                       # captures
    eager._decode_run_eager(4)
    (win,) = graph._window_fns.values()
    assert win.graph is not None
    assert win.tokens.numel() == cfg.token_budget
    while graph.pending():
        captured = {k for k, w in graph._window_fns.items() if w.graph}
        reset_launch_counts()
        got = graph.decode_run(4)
        counts = launch_counts()
        # a window whose graph is new runs its body once more to warm up
        steps = max(collections.Counter(r for r, _ in got).values()) + (
            len(graph._window_fns) > len(captured))
        assert counts["rms_norm"] == steps * (2 * L + 1)
        assert counts["rope_append"] == counts["paged_attention"] \
            == steps * L
        assert counts["varlen_attention_fwd"] == 0
        assert got == eager._decode_run_eager(4)
    assert not eager.pending()


# -- the eager surface (Tensor, F, nn.Layer, AdamW) on the card ---------------
# A small eager Llama at a kernel shape (head_dim 128, S = 128): its loss
# and every gradient on the card within 1e-4 relative and 1e-3 of each
# leaf's largest magnitude of the CPU's (f32, TF32 off: the same f32
# arithmetic, the kernels' online softmax against the dense plain
# versions), as chip_smoke.py's eager parity holds them.

_EAGER_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, max_position_embeddings=512,
                  dtype="float32", recompute=True)


@pytest.fixture
def eager_on(cuda_device):
    """set_device for the eager surface, put back after; TF32 off."""
    import paddle_tpu_torch as paddle

    prev = paddle.get_device()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield paddle.set_device
    torch.backends.cuda.matmul.allow_tf32 = tf32
    paddle.set_device(prev)


def test_eager_llama_loss_and_gradients_on_the_card_match_cpu(eager_on):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import llama as TL

    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 128))
    labels = np.roll(ids, -1, axis=1)
    out = {}
    state = None
    for where in ("gpu:0", "cpu"):
        eager_on(where)
        paddle.seed(5)
        model = TL.LlamaForCausalLM(TL.LlamaConfig(**_EAGER_CFG))
        if state is None:
            state = {k: v._value.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
        else:
            model.set_state_dict(state)
        reset_launch_counts()
        loss = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        out[where] = (float(loss), {n: p.grad._value.detach().cpu()
                                    for n, p in model.named_parameters()},
                      launch_counts())
    (lc, gc, cc), (lp, gp, cp) = out["gpu:0"], out["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for name, g in gp.items():
        assert float((gc[name] - g).abs().max()) <= \
            1e-3 * float(g.abs().max()), name
    # recompute: the forward kernels twice a step, the gradients once
    assert cc["flash_attention_fwd"] == 4 and cc["rms_norm"] == 9
    assert cc["flash_attention_bwd_dkv"] == cc["flash_attention_bwd_dq"] \
        == 2 and cc["rms_norm_bwd"] == 5
    assert cp["flash_attention_fwd"] == 0 and cp["rms_norm"] == 0


def test_eager_amp_step_launch_counts_and_adamw_on_the_card(eager_on):
    """Under auto_cast O1 bf16 a step launches RMSNorm 4L + 1 (f32: it is
    black-listed) and its gradient 2L + 1, the flash forward 2L (bf16: it
    is white-listed) and dK/dV, dQ L times; AdamW updates the f32
    parameters in place on the card; the loss falls."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import llama as TL

    eager_on("gpu:0")
    paddle.seed(1)
    model = TL.LlamaForCausalLM(TL.LlamaConfig(**_EAGER_CFG))
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    ids = paddle.to_tensor(np.random.RandomState(1).randint(0, 512, (2, 256)))
    labels = paddle.to_tensor(np.roll(ids.numpy(), -1, axis=1))
    seen, losses = [], []
    for _ in range(3):
        reset_launch_counts()
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        losses.append(float(loss))
        seen.append(launch_counts())
    L = 2
    for c in seen:
        assert c["rms_norm"] == 4 * L + 1 and c["rms_norm_bwd"] == 2 * L + 1
        assert c["flash_attention_fwd"] == 2 * L
        assert c["flash_attention_bwd_dkv"] == c["flash_attention_bwd_dq"] \
            == L
        assert c["aligned16_copies"] == 0
    assert losses[-1] < losses[0] and np.all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 and p._value.is_cuda
               for p in model.parameters())
    st = opt.state_dict()
    assert st["_step_count"] == 3 and st["param_0.moment1"]._value.is_cuda


def test_eager_functional_launches_kernels_without_plain_fallback(
        eager_on, monkeypatch):
    """A CUDA Tensor of a kernel shape through F.rms_norm and
    F.scaled_dot_product_attention runs the kernels, forward and backward,
    with the plain versions made to raise; a decode step's Sq = 1 takes
    the dense fallback, which launches nothing."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.nn import functional as F

    def refuse(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")
    for mod, name in ((TR, "_rms_norm_ref"), (TR, "_rms_norm_bwd"),
                      (FA, "_forward_ref"), (FA, "_backward_ref")):
        monkeypatch.setattr(mod, name, refuse)
    eager_on("gpu:0")
    x = paddle.to_tensor(np.random.RandomState(2).randn(4, 256)
                         .astype(np.float32), stop_gradient=False)
    w = paddle.to_tensor(np.ones(256, np.float32), stop_gradient=False)
    q, k, v = (paddle.to_tensor(np.random.RandomState(s).randn(
        1, 128, 2, 128).astype(np.float32)).astype("bfloat16")
        for s in (3, 4, 5))
    for t in (q, k, v):
        t.stop_gradient = False
    reset_launch_counts()
    y = F.rms_norm(x, w)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    (y.sum() + o.astype("float32").sum()).backward()
    torch.cuda.synchronize()
    c = launch_counts()
    assert c["rms_norm"] == 1 and c["rms_norm_bwd"] == 1
    assert c["flash_attention_fwd"] == 1
    assert c["flash_attention_bwd_dkv"] == c["flash_attention_bwd_dq"] == 1
    assert o.dtype == torch.bfloat16 and q.grad.shape == [1, 128, 2, 128]
    reset_launch_counts()
    with paddle.no_grad():
        F.scaled_dot_product_attention(q[:, :1], k, v, is_causal=False)
    assert launch_counts()["flash_attention_fwd"] == 0


# -- the flash kernels at head dim 64 with dropout (GPT-2 / BERT-base) -------
# The general instantiations (dropout, a key-padding bias) at the models'
# heads and sequence lengths, a smaller batch: held to the plain versions
# with the bf16 tolerances above; each call launches each kernel once.

@pytest.mark.parametrize("b,s,causal,bias", [
    (4, 512, False, False),           # BERT-base: 12 heads of 64, S = 512
    (4, 512, False, True),            # BERT with a key-padding mask
    (2, 1024, True, False),           # GPT-2: causal, S = 1024
])
def test_flash_kernels_at_head_dim_64_with_dropout(b, s, causal, bias,
                                                   cuda_device):
    q, k, v, do, kmask = _flash_inputs(b, 12, s, 64, torch.bfloat16, bias,
                                       cuda_device, s + b)
    seed, p = -20260101 + s, 0.1
    n0 = (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq)
    o, lse = FA.forward_with_lse(q, k, v, kmask, seed, causal, p)
    o2, lse2 = FA._forward_ref(q, k, v, kmask, seed, causal, p)
    g = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
    g2 = FA._backward_ref(q, k, v, kmask, seed, o, lse, do, causal, p)
    again = FA.backward(q, k, v, kmask, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    assert (FA.launches_fwd, FA.launches_bwd_dkv, FA.launches_bwd_dq) == \
        (n0[0] + 1, n0[1] + 2, n0[2] + 2)
    assert all(torch.equal(a, c) for a, c in zip(g, again))
    assert float((lse - lse2).abs().max()) <= 1e-3
    tol = _tol(torch.bfloat16)
    parts = [slice(0, b - 1), slice(b - 1, b)] if bias else [slice(0, b)]
    for sl in parts:
        assert _worst_of_tol(o[sl], o2[sl], *tol) <= 1.0
        for got, ref in zip(g, g2):
            assert bool(torch.isfinite(got.float()).all())
            assert _worst_of_tol(got[sl], ref[sl], *tol) <= 1.0


def _two_layer(kind):
    """A 2-layer GPT or BERT at the models' widths (12 heads of 64), bf16
    under amp.decorate O2, dropout 0.1, small vocabularies."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import gpt as TG

    paddle.seed(3)
    if kind == "gpt":
        model = TG.GPTForCausalLM(TG.GPTConfig(vocab_size=1024,
                                               num_hidden_layers=2))
    else:
        model = TB.BertForPretraining(TB.BertConfig(vocab_size=1024,
                                                    num_hidden_layers=2))
    return paddle.amp.decorate(model, level="O2", dtype="bfloat16")


@pytest.mark.parametrize("kind,s", [("gpt", 1024), ("bert", 512)])
def test_gpt_bert_train_step_launch_counts_on_the_card(kind, s, eager_on,
                                                       monkeypatch):
    """TrainStep of a 2-layer O2 bf16 model with dropout 0.1: each step
    launches the flash forward, dK/dV and dQ kernels once a layer, every
    one with dropout, with the dense attention made to raise; the losses
    are finite."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import launch_counts, reset_launch_counts
    from paddle_tpu_torch.jit import TrainStep

    def refuse(*a, **k):
        raise AssertionError("the dense attention ran on the model's path")
    for name in ("_attention_ref", "_forward_fallback", "_forward_ref",
                 "_backward_ref"):
        monkeypatch.setattr(FA, name, refuse)
    seen = []
    real = FA._launch_fwd

    def record(q, k, v, kmask, seed, causal, dropout_p):
        seen.append((dropout_p, q.shape[-1], q.dtype, causal))
        return real(q, k, v, kmask, seed, causal, dropout_p)
    monkeypatch.setattr(FA, "_launch_fwd", record)
    eager_on("gpu:0")
    model = _two_layer(kind)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    if kind == "gpt":
        step = TrainStep(model, None, opt)
    else:
        def mlm(outs, labels):
            return paddle.nn.functional.cross_entropy(
                outs[0].reshape([-1, 1024]), labels.reshape([-1]))
        step = TrainStep(model, mlm, opt)
    ids = np.random.RandomState(2).randint(0, 1024, (2, s))
    ids, labels = paddle.to_tensor(ids), paddle.to_tensor(np.roll(ids, -1, 1))
    losses = []
    for _ in range(2):
        reset_launch_counts()
        seen.clear()
        losses.append(float(step(ids, labels)))
        torch.cuda.synchronize()
        c = launch_counts()
        assert c["flash_attention_fwd"] == c["flash_attention_bwd_dkv"] \
            == c["flash_attention_bwd_dq"] == 2
        assert c["aligned16_copies"] == 0
        assert seen == [(0.1, 64, torch.bfloat16, kind == "gpt")] * 2
    assert np.all(np.isfinite(losses))
