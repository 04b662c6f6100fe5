"""The port's conv, pooling and batch norm (paddle_tpu_torch.nn.functional
and their Layers) against the JAX package on the CPU, with
``set_device("cpu")``: the same numpy inputs through both, the forward
compared, and the gradients of sum(out * g) for a fixed cotangent g (the
JAX package's eager autograd, which runs jax.vjp's pullbacks, against
torch autograd).

Tolerances: f32 outputs within 1e-5 relative and 1e-5 absolute (sums in
other orders: lax.conv_general_dilated and reduce_window against
PyTorch's conv and pools); f32 gradients within 1e-5 of each gradient's
largest magnitude. bf16 outputs within 2^-7 (one bf16 rounding at the
values' scale) of the largest magnitude, bf16 gradients within 2^-6 (XLA
may keep f32 between two bf16 ops where PyTorch rounds each). Output
shapes equal. Max pool values are exact (no arithmetic). The running
statistics within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.nn import functional as TF

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD_SHARE = 1e-5
BF16_OUT = 2.0 ** -7
BF16_GRAD = 2.0 ** -6


@pytest.fixture(autouse=True)
def _cpu():
    device = tpaddle.get_device()
    threads = torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tpaddle.set_device(device)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(lib, fn, arrays, cot_seed=99, dtype="float32"):
    """fn(F, *tensors) in ``lib`` ("j" or "t"): the output and the
    gradient of sum(out * g) to every input, as numpy f32."""
    m, F = (jpaddle, JF) if lib == "j" else (tpaddle, TF)
    ins = [m.to_tensor(a, dtype=dtype, stop_gradient=False) for a in arrays]
    out = fn(F, *ins)
    g = m.to_tensor(_rand(*out.shape, seed=cot_seed), dtype=out.dtype)
    (out * g).sum().backward()
    return out.numpy().astype(np.float32), \
        [x.grad.numpy().astype(np.float32) for x in ins]


def _close(got, want, share):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= share * scale


def _check(fn, arrays, dtype="float32"):
    (jo, jg), (to, tg) = (_run(lib, fn, arrays, dtype=dtype)
                          for lib in ("j", "t"))
    assert to.shape == jo.shape
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, **F32)
        for a, b in zip(tg, jg):
            _close(a, b, GRAD_SHARE)
    else:
        _close(to, jo, BF16_OUT)
        for a, b in zip(tg, jg):
            _close(a, b, BF16_GRAD)


# -- conv -------------------------------------------------------------------

CONV2D = [
    dict(padding=0), dict(padding=1), dict(padding=[1, 2]),
    dict(padding=[1, 0, 2, 1]), dict(padding="SAME", stride=2),
    dict(padding="SAME", stride=3, dilation=2), dict(padding="VALID"),
    dict(stride=2, padding=1), dict(dilation=2, padding=2),
    dict(groups=2, padding=1), dict(padding=[0, 1, 1, 0], stride=2,
                                    data_format="NHWC"),
    dict(padding=1, bias=False)]


@pytest.mark.parametrize("kw", CONV2D, ids=[str(k) for k in CONV2D])
def test_conv2d_matches_jax(kw):
    kw = dict(kw)
    bias = kw.pop("bias", True)
    nhwc = kw.get("data_format") == "NHWC"
    x = _rand(2, 9, 11, 4, seed=1) if nhwc else _rand(2, 4, 9, 11, seed=1)
    w = _rand(6, 4 // kw.get("groups", 1), 3, 3, seed=2)
    arrays = [x, w] + ([_rand(6, seed=3)] if bias else [])
    _check(lambda F, *t: F.conv2d(*t[:2], *t[2:], **kw), arrays)


@pytest.mark.parametrize("n,kw", [
    (1, dict(padding=2, stride=2)), (1, dict(padding="SAME", dilation=2)),
    (1, dict(padding=[1, 0], data_format="NLC")),
    (3, dict(padding=1)), (3, dict(padding="SAME", stride=2))])
def test_conv1d_conv3d_match_jax(n, kw):
    last = kw.get("data_format", "").endswith("C")
    sp = (13,) if n == 1 else (5, 6, 7)
    x = _rand(2, *sp, 3, seed=4) if last else _rand(2, 3, *sp, seed=4)
    w = _rand(5, 3, *([3] * n), seed=5)
    name = "conv1d" if n == 1 else "conv3d"
    _check(lambda F, *t: getattr(F, name)(*t, **kw),
           [x, w, _rand(5, seed=6)])


CONV_T = [
    dict(stride=2, padding=1, output_padding=1), dict(stride=1, padding=0),
    dict(stride=2, padding=[1, 0, 2, 1]), dict(stride=3, output_padding=2),
    dict(stride=2, padding=1, groups=2), dict(stride=2, dilation=2,
                                              padding=2),
    dict(stride=2, padding=1, output_padding=1, data_format="NHWC")]


@pytest.mark.parametrize("kw", CONV_T, ids=[str(k) for k in CONV_T])
def test_conv2d_transpose_matches_jax(kw):
    nhwc = kw.get("data_format") == "NHWC"
    x = _rand(2, 5, 6, 4, seed=7) if nhwc else _rand(2, 4, 5, 6, seed=7)
    w = _rand(4, 6 // kw.get("groups", 1), 3, 3, seed=8)
    _check(lambda F, *t: F.conv2d_transpose(*t, **kw),
           [x, w, _rand(6 // kw.get("groups", 1) * kw.get("groups", 1),
                        seed=9)])


@pytest.mark.parametrize("n", [1, 3])
def test_conv1d_conv3d_transpose_match_jax(n):
    sp = (7,) if n == 1 else (3, 4, 5)
    x, w = _rand(2, 3, *sp, seed=10), _rand(3, 2, *([3] * n), seed=11)
    name = "conv1d_transpose" if n == 1 else "conv3d_transpose"
    _check(lambda F, *t: getattr(F, name)(*t, stride=2, padding=1,
                                          output_padding=1), [x, w])


def test_conv_transpose_string_padding_raises_as_jax():
    for m, F in ((jpaddle, JF), (tpaddle, TF)):
        x, w = m.to_tensor(_rand(1, 2, 4, 4)), m.to_tensor(_rand(2, 2, 3, 3))
        with pytest.raises(NotImplementedError):
            F.conv2d_transpose(x, w, padding="SAME")


def test_conv2d_bf16_matches_jax():
    _check(lambda F, *t: F.conv2d(*t, stride=2, padding=1),
           [_rand(2, 4, 9, 9, seed=12), _rand(6, 4, 3, 3, seed=13),
            _rand(6, seed=14)], dtype="bfloat16")


# -- pooling ----------------------------------------------------------------

POOL2D = [
    ("max", dict(kernel_size=3, stride=2, padding=1)),
    ("max", dict(kernel_size=2)),
    ("max", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("max", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("max", dict(kernel_size=2, stride=2, padding=[1, 0, 0, 1])),
    ("max", dict(kernel_size=3, stride=2, padding="SAME")),
    ("max", dict(kernel_size=2, stride=1, padding=1,
                 data_format="NHWC")),
    ("avg", dict(kernel_size=3, stride=2, padding=1)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                 exclusive=False)),
    ("avg", dict(kernel_size=2, stride=2, padding=[1, 0, 0, 1])),
    ("avg", dict(kernel_size=3, stride=2, padding="SAME")),
    ("avg", dict(kernel_size=2, divisor_override=3)),
    ("avg", dict(kernel_size=3, padding=1, divisor_override=5,
                 ceil_mode=True)),
    ("avg", dict(kernel_size=2, stride=1, padding=1, data_format="NHWC"))]


@pytest.mark.parametrize("kind,kw", POOL2D, ids=[f"{k}-{v}" for k, v in
                                                 POOL2D])
def test_pool2d_matches_jax(kind, kw):
    nhwc = kw.get("data_format") == "NHWC"
    x = _rand(2, 7, 8, 3, seed=15) if nhwc else _rand(2, 3, 7, 8, seed=15)
    _check(lambda F, t: getattr(F, f"{kind}_pool2d")(t, **kw), [x])


@pytest.mark.parametrize("kind,n,kw", [
    ("max", 1, dict(kernel_size=3, stride=2, padding=1)),
    ("max", 1, dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("avg", 1, dict(kernel_size=3, stride=2, padding=1)),
    ("avg", 1, dict(kernel_size=3, stride=2, ceil_mode=True,
                    exclusive=False)),
    ("max", 3, dict(kernel_size=2, stride=2, padding=1)),
    ("max", 3, dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("avg", 3, dict(kernel_size=2, stride=2, padding=1)),
    ("avg", 3, dict(kernel_size=3, stride=2, padding="SAME"))])
def test_pool1d_pool3d_match_jax(kind, n, kw):
    sp = (11,) if n == 1 else (5, 6, 7)
    _check(lambda F, t: getattr(F, f"{kind}_pool{n}d")(t, **kw),
           [_rand(2, 3, *sp, seed=16)])


@pytest.mark.parametrize("kind,n,size,out", [
    ("avg", 2, (8, 6), (4, 3)), ("avg", 2, (7, 5), (3, 2)),
    ("avg", 2, (7, 7), 1), ("max", 2, (8, 6), (2, 3)),
    ("max", 2, (7, 5), (3, 4)), ("avg", 1, (10,), 4),
    ("max", 1, (9,), 4), ("avg", 3, (4, 5, 6), (2, 3, 4)),
    ("max", 3, (4, 6, 5), 2)])
def test_adaptive_pools_match_jax(kind, n, size, out):
    _check(lambda F, t: getattr(F, f"adaptive_{kind}_pool{n}d")(t, out),
           [_rand(2, 3, *size, seed=17)])


@pytest.mark.parametrize("kw", [
    dict(kernel_size=2), dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, ceil_mode=True)])
def test_max_pool2d_return_mask_matches_jax(kw):
    x = _rand(2, 3, 7, 8, seed=18)
    res = {}
    for lib in ("j", "t"):
        m, F = (jpaddle, JF) if lib == "j" else (tpaddle, TF)
        t = m.to_tensor(x, stop_gradient=False)
        v, i = F.max_pool2d(t, return_mask=True, **kw)
        (v * m.to_tensor(_rand(*v.shape, seed=19))).sum().backward()
        res[lib] = (v.numpy(), i.numpy(), t.grad.numpy())
    np.testing.assert_array_equal(res["t"][0], res["j"][0])
    np.testing.assert_array_equal(res["t"][1], res["j"][1])
    assert str(res["t"][1].dtype) == "int32"
    np.testing.assert_allclose(res["t"][2], res["j"][2], **F32)


def test_pool_layers_and_bf16_match_jax():
    x = _rand(2, 3, 9, 9, seed=20)
    for name, args in (("MaxPool2D", (3, 2, 1)), ("AvgPool2D", (3, 2, 1)),
                       ("AdaptiveAvgPool2D", ((1, 1),)),
                       ("AdaptiveMaxPool2D", (2,))):
        _check(lambda F, t: getattr((jpaddle if F is JF else tpaddle).nn,
                                    name)(*args)(t), [x])
    _check(lambda F, t: F.avg_pool2d(t, 3, 2, 1, ceil_mode=True), [x],
           dtype="bfloat16")
    _check(lambda F, t: F.max_pool2d(t, 3, 2, 1), [x], dtype="bfloat16")


# -- batch norm -------------------------------------------------------------

def _bn(lib, x, training, dtype="float32", data_format="NCHW",
        stats=None, amp=False, affine=True):
    """F.batch_norm in ``lib`` on x (of ``dtype``): output, gradients to x,
    weight and bias, and the running buffers after the call."""
    m, F = (jpaddle, JF) if lib == "j" else (tpaddle, TF)
    c = x.shape[1 if data_format[1] == "C" or x.ndim <= 2 else -1]
    rm = m.to_tensor(stats[0] if stats else np.zeros(c, np.float32))
    rv = m.to_tensor(stats[1] if stats else np.ones(c, np.float32))
    w = m.to_tensor(np.linspace(0.5, 1.5, c).astype(np.float32),
                    stop_gradient=False) if affine else None
    b = m.to_tensor(np.linspace(-0.2, 0.3, c).astype(np.float32),
                    stop_gradient=False) if affine else None
    t = m.to_tensor(x, dtype=dtype, stop_gradient=False)
    with m.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        out = F.batch_norm(t, rm, rv, w, b, training=training, momentum=0.9,
                           epsilon=1e-5, data_format=data_format)
    g = m.to_tensor(_rand(*x.shape, seed=21), dtype=out.dtype)
    (out * g).sum().backward()
    grads = [t.grad] + ([w.grad, b.grad] if affine else [])
    return (out.numpy().astype(np.float32), str(out.dtype),
            [v.numpy().astype(np.float32) for v in grads],
            rm.numpy(), rv.numpy())


BN = [
    dict(shape=(4, 3, 5, 6), training=True),
    dict(shape=(6, 5), training=True),
    dict(shape=(4, 3, 7), training=True),
    dict(shape=(4, 5, 6, 3), training=True, data_format="NHWC"),
    dict(shape=(4, 3, 5, 6), training=True, affine=False),
    dict(shape=(4, 3, 5, 6), training=False),
    dict(shape=(4, 3, 5, 6), training=True, dtype="bfloat16"),
    dict(shape=(4, 3, 5, 6), training=False, dtype="bfloat16"),
    dict(shape=(4, 3, 5, 6), training=True, dtype="bfloat16", amp=True),
    dict(shape=(4, 3, 5, 6), training=False, dtype="bfloat16", amp=True)]


@pytest.mark.parametrize("case", BN, ids=[str(c) for c in BN])
def test_batch_norm_branches_match_jax(case):
    case = dict(case)
    x = _rand(*case.pop("shape"), seed=22) * 2.0 + 0.5
    c = x.shape[-1] if case.get("data_format") == "NHWC" else \
        x.shape[1 if x.ndim > 2 else -1]
    rng = np.random.RandomState(23)
    stats = (rng.randn(c).astype(np.float32),
             rng.rand(c).astype(np.float32) + 0.5)
    (jo, jd, jg, jm, jv), (to, td, tg, tm, tv) = (
        _bn(lib, x, stats=stats, **case) for lib in ("j", "t"))
    # under auto_cast O1 batch_norm is black-listed: f32 out of bf16 x
    assert td.replace("torch.", "") == str(np.dtype(jd)) == (
        "float32" if case.get("amp") or case.get("dtype") is None
        else "bfloat16")
    if td.endswith("float32"):
        np.testing.assert_allclose(to, jo, **F32)
    else:
        _close(to, jo, BF16_OUT)
    share = GRAD_SHARE if case.get("dtype") is None else BF16_GRAD
    for i, (a, b) in enumerate(zip(tg, jg)):
        if i and td.endswith("bfloat16") and not case["training"]:
            # the weight's and bias's gradients of bf16 inference: sums
            # over the batch of bf16 products, which XLA adds in bf16
            # (the transpose of a broadcast) and PyTorch in f32; the
            # port's held to an f64 sum of the same bf16 products instead
            _close(a, _bn_inference_param_grads(x, stats)[i - 1],
                   BF16_GRAD)
            _close(a, b, 2.0 ** -4)
        else:
            _close(a, b, share)
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)
    if case["training"]:
        assert not np.allclose(tm, stats[0])


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
        .double().numpy()


def _bn_inference_param_grads(x, stats):
    """The weight's and bias's gradients of bf16 inference batch norm in
    f64 from the bf16 values it multiplies (x, the cotangent)."""
    c = x.shape[1]
    w = np.linspace(0.5, 1.5, c).astype(np.float32)
    k = 1.0 / np.sqrt(stats[1].astype(np.float64) + 1e-5)
    xb, g = _bf16(x), _bf16(_rand(*x.shape, seed=21))
    axes = tuple(i for i in range(x.ndim) if i != 1)
    dk = (g * xb).sum(axis=axes)
    doff = g.sum(axis=axes)
    # k = rsqrt(var + eps) * w, off = b - mean * k
    dw = (dk - doff * stats[0]) * k
    del w
    return dw.astype(np.float32), doff.astype(np.float32)


def test_batch_norm_running_stats_follow_paddle_convention():
    """momentum 0.9 on the running value, the unbiased variance."""
    x = _rand(8, 3, 4, 4, seed=24) * 3.0 + 1.0
    _, _, _, rm, rv = _bn("t", x, True, affine=False)
    n = 8 * 4 * 4
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3)) * n / (n - 1)
    np.testing.assert_allclose(rm, 0.1 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rv, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)


def test_batch_norm_layers_and_decorate_match_jax():
    x = _rand(4, 3, 5, 5, seed=25)
    outs = {}
    for m in (jpaddle, tpaddle):
        bn = m.nn.BatchNorm2D(3)
        net = m.nn.Sequential(m.nn.Conv2D(3, 3, 1), bn)
        m.amp.decorate(net, level="O2", dtype="bfloat16")
        dt = {n: str(p.dtype).replace("torch.", "")
              for n, p in net.named_parameters()}
        names = [n for n, _ in net.state_dict().items()]
        y = bn(m.to_tensor(x))
        bn.eval()
        z = bn(m.to_tensor(x))
        outs[m] = (dt, names, y.numpy(), z.numpy(), bn._mean.numpy(),
                   bn._variance.numpy())
    j, t = outs[jpaddle], outs[tpaddle]
    assert t[0] == {k: str(np.dtype(v)) for k, v in j[0].items()}
    assert t[0]["1.weight"] == "float32" and t[0]["0.weight"] == "bfloat16"
    assert t[1] == j[1] and "1._mean" in t[1]
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_allclose(a, b, **F32)


def test_conv_layers_draw_the_reference_bounds():
    tpaddle.seed(0)
    conv = tpaddle.nn.Conv2D(8, 16, 3, groups=2)
    convt = tpaddle.nn.Conv2DTranspose(8, 16, 3)
    bound = 1 / np.sqrt(4 * 9)
    w = conv.weight.numpy()
    assert w.shape == (16, 4, 3, 3) and convt.weight.shape == [8, 16, 3, 3]
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert np.abs(conv.bias.numpy()).max() <= bound
    assert tpaddle.nn.Conv2D(3, 4, 1, bias_attr=False).bias is None


def test_convert_sync_batchnorm_keeps_values_and_runs_plain_alone():
    """Without a world SyncBatchNorm is a plain batch norm (the 2-rank
    world's check is tests/test_torch_sequence_parallel.py's)."""
    net = tpaddle.nn.Sequential(tpaddle.nn.Conv2D(3, 4, 1),
                                tpaddle.nn.BatchNorm2D(4))
    net[1].weight.set_value(np.linspace(0.5, 2.0, 4).astype(np.float32))
    net[1]._mean.set_value(np.arange(4, dtype=np.float32))
    sync = tpaddle.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert type(sync[1]).__name__ == "SyncBatchNorm"
    assert type(sync[0]).__name__ == "Conv2D"
    np.testing.assert_array_equal(sync[1].weight.numpy(),
                                  net[1].weight.numpy())
    np.testing.assert_array_equal(sync[1]._mean.numpy(), np.arange(4))
    x = tpaddle.to_tensor(_rand(2, 4, 5, 5, seed=26))
    plain = tpaddle.nn.BatchNorm2D(4)
    plain.weight.set_value(net[1].weight)
    plain._mean.set_value(net[1]._mean)
    np.testing.assert_array_equal(sync[1](x).numpy(), plain(x).numpy())
