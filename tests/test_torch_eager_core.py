"""The port's eager core (paddle_tpu_torch: Tensor, grad mode and backward,
the op funnel and its AMP cast policy, type promotion, the ops the eager
Llama path reaches, places and the RNG) against the JAX package on the
CPU, with ``set_device("cpu")``.

Tolerances: ops on the same f32 inputs agree to 1e-6 relative and absolute
(the same f32 arithmetic; sums and products in other orders); integer and
boolean outputs, shapes, dtypes and op names exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core import amp_state as JAS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import amp_state as TAS
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.ops import registry

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    # the port on the CPU and one PyTorch thread, both restored after
    device = tpaddle.get_device()
    threads = torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tpaddle.set_device(device)


def _both(arr, **kw):
    return jpaddle.to_tensor(arr, **kw), tpaddle.to_tensor(arr, **kw)


# -- Tensor -------------------------------------------------------------------

def test_tensor_shape_is_a_list_and_dtype_names():
    x = tpaddle.to_tensor(np.zeros((1, 12), np.float32))
    assert x.shape == [1, 12] and isinstance(x.shape, list)
    assert x.ndim == 2 and x.size == 12 and x.dtype == tpaddle.float32
    assert tpaddle.to_tensor([1, 2]).dtype == tpaddle.int64
    assert tpaddle.to_tensor([1.5]).dtype == tpaddle.float32
    assert tpaddle.to_tensor(True).dtype == tpaddle.bool
    b = x.astype("bfloat16")
    assert b.dtype == torch.bfloat16 and b.shape == [1, 12]
    assert b.astype(tpaddle.float32).dtype == torch.float32
    assert x.place == tpaddle.CPUPlace() and x.place.is_cpu_place()
    # numpy: a host copy, bf16 as f32
    assert b.numpy().dtype == np.float32
    assert str(x).startswith("Tensor(shape=[1, 12], dtype=float32")


def test_stop_gradient_backward_and_accumulation():
    w = tpaddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    assert not w.stop_gradient and w.is_leaf and w.grad is None
    c = tpaddle.to_tensor([4.0, 5.0, 6.0])
    assert c.stop_gradient
    (w * c).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), [4.0, 5.0, 6.0])
    assert c.grad is None
    # a second backward accumulates, as Paddle's does
    (w * w).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), [6.0, 9.0, 12.0])
    w.clear_grad(set_to_zero=True)
    np.testing.assert_array_equal(w.grad.numpy(), [0.0, 0.0, 0.0])
    w.clear_grad()
    assert w.grad is None
    # a non-leaf set to stop_gradient stops the gradient from there on
    y = w * 2.0
    assert not y.stop_gradient
    y.stop_gradient = True
    z = y * w
    z.sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), [2.0, 4.0, 6.0])
    with pytest.raises(TypeError):
        tpaddle.to_tensor([1, 2]).stop_gradient = False


def test_no_grad_and_grad_mode():
    w = tpaddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with tpaddle.no_grad():
        assert not tpaddle.is_grad_enabled()
        y = w * 3.0
    assert y.stop_gradient and tpaddle.is_grad_enabled()

    @tpaddle.no_grad()
    def f(t):
        return t * 2.0
    assert f(w).stop_gradient
    with tpaddle.set_grad_enabled(False):
        with tpaddle.enable_grad():
            assert not (w * 1.0).stop_gradient
    (gx,) = tpaddle.grad([(w * w).sum()], [w])
    np.testing.assert_array_equal(gx.numpy(), [2.0, 4.0])
    assert w.grad is None          # grad() leaves .grad alone
    with pytest.raises(RuntimeError, match="scalar"):
        (w * 1.0).backward()


def test_detach_clone_set_value_and_setitem():
    w = tpaddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    d = w.detach()
    assert d.stop_gradient and d._value.data_ptr() == w._value.data_ptr()
    c = w.clone()
    assert not c.stop_gradient and c._value.data_ptr() != w._value.data_ptr()
    w.set_value(np.array([7.0, 8.0, 9.0], np.float64))
    assert w.dtype == torch.float32 and w.is_leaf
    np.testing.assert_array_equal(w.numpy(), [7.0, 8.0, 9.0])
    with pytest.raises(ValueError, match="shape"):
        w.set_value(np.zeros(2))
    v = tpaddle.to_tensor([1.0, 1.0, 1.0], stop_gradient=False)
    u = v * 1.0
    u[1] = w[0] * 2.0
    u.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(w.grad.numpy(), [2.0, 0.0, 0.0])
    assert float(tpaddle.to_tensor(2.5)) == 2.5
    assert int(tpaddle.to_tensor([3])[0]) == 3
    assert [tpaddle.to_tensor([1, 2])[i].item() for i in range(2)] == [1, 2]


def test_parameter_is_a_trainable_leaf():
    p = tpaddle.Parameter(torch.ones(3))
    assert p.is_leaf and p.trainable and not p.stop_gradient and \
        p.persistable
    p.trainable = False
    assert p.stop_gradient
    q = tpaddle.Parameter(torch.ones(2), trainable=False)
    assert q.stop_gradient


# -- type promotion: JAX's, where torch's differs ----------------------------

PROMOTE_CASES = [
    # (x dtype, y: a dtype or a Python scalar)
    ("bfloat16", 0.5), ("bfloat16", 2), ("int64", 0.5), ("int32", 3),
    ("float32", "bfloat16"), ("bfloat16", "float16"), ("int64", "float32"),
    ("int64", "bfloat16"), ("int8", "uint8"), ("bool", "float32"),
]


@pytest.mark.parametrize("xd,y", PROMOTE_CASES)
def test_binary_promotion_matches_jax(xd, y):
    xn = np.arange(1, 5).astype(np.float32)
    jx = jpaddle.to_tensor(xn).astype(xd)
    tx = tpaddle.to_tensor(xn).astype(xd)
    if isinstance(y, str):
        jy, ty = jpaddle.to_tensor(xn).astype(y), tpaddle.to_tensor(xn) \
            .astype(y)
    else:
        jy = ty = y
    jr, tr = jx * jy, tx * ty
    jname = str(np.dtype(jr.dtype))
    # the JAX package runs with 64-bit types off: its int64 is int32
    tname = {"int64": "int32"}.get(str(tr.dtype).replace("torch.", ""),
                                   str(tr.dtype).replace("torch.", ""))
    assert tname == jname, (xd, y)
    np.testing.assert_allclose(tr.numpy().astype(np.float64),
                               np.asarray(jr.numpy(), np.float64), **TOL)


def test_zero_dim_f32_tensor_promotes_bf16_as_jax_does():
    """torch lets a 0-d f32 tensor take a bf16 tensor's dtype; JAX (and so
    the port) promotes to f32."""
    xb = np.array([1.0, 2.0], np.float32)
    jr = jpaddle.to_tensor(xb).astype("bfloat16") * jpaddle.to_tensor(2.0)
    tr = tpaddle.to_tensor(xb).astype("bfloat16") * tpaddle.to_tensor(2.0)
    assert np.dtype(jr.dtype) == np.float32 and tr.dtype == torch.float32
    assert torch.result_type(torch.zeros(2, dtype=torch.bfloat16),
                             torch.tensor(2.0)) == torch.bfloat16
    # reflected operators keep the scalar weak
    assert (1.0 - tpaddle.to_tensor(xb).astype("bfloat16")).dtype == \
        torch.bfloat16
    np.testing.assert_array_equal((3 - tpaddle.to_tensor(xb)).numpy(),
                                  [2.0, 1.0])
    np.testing.assert_array_equal((1 / tpaddle.to_tensor(xb)).numpy(),
                                  [1.0, 0.5])


def test_int_ids_stay_int64():
    ids = tpaddle.to_tensor(np.array([[1, 2], [3, 4]], np.int64))
    assert ids.dtype == torch.int64
    assert (ids + 1).dtype == torch.int64
    assert (ids / 2).dtype == torch.float32
    w = tpaddle.to_tensor(np.eye(5, dtype=np.float32))
    assert tpaddle.nn.functional.embedding(ids, w).shape == [2, 2, 5]


# -- the op funnel ------------------------------------------------------------

AMP_OPS = ["linear", "matmul", "scaled_dot_product_attention", "rms_norm",
           "cross_entropy", "softmax", "sum", "mean", "exp", "add",
           "reshape", "swiglu", "embedding", "fused_rope"]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("custom", [False, True])
def test_amp_cast_policy_matches_jax_op_by_op(level, custom):
    white, black = (["add"], ["linear"]) if custom else (None, None)
    assert TAS.WHITE_LIST == JAS.WHITE_LIST
    assert TAS.BLACK_LIST == JAS.BLACK_LIST
    with jpaddle.amp.auto_cast(level=level, dtype="bfloat16",
                               custom_white_list=white,
                               custom_black_list=black):
        jpol = {op: JAS.cast_policy(op) for op in AMP_OPS}
    with tpaddle.amp.auto_cast(level=level, dtype="bfloat16",
                               custom_white_list=white,
                               custom_black_list=black):
        tpol = {op: TAS.cast_policy(op) for op in AMP_OPS}
    assert TAS.cast_policy("linear") is None       # restored on exit
    for op in AMP_OPS:
        j, t = jpol[op], tpol[op]
        assert (j is None) == (t is None), op
        if j is not None:
            assert str(np.dtype(j)) == str(t).replace("torch.", ""), op


def test_amp_casts_through_the_funnel_and_its_backward():
    x = tpaddle.to_tensor(np.ones((2, 4), np.float32), stop_gradient=False)
    w = tpaddle.to_tensor(np.ones((4, 3), np.float32), stop_gradient=False)
    with tpaddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = tpaddle.nn.functional.linear(x, w)
        z = tpaddle.nn.functional.rms_norm(y)
        s = y + 1.0
    assert y.dtype == torch.bfloat16 and z.dtype == torch.float32
    assert s.dtype == torch.bfloat16           # not listed: no cast
    (z.sum() + s.astype("float32").sum()).backward()
    assert x.grad.dtype == torch.float32 and w.grad.dtype == torch.float32
    assert x.grad.shape == [2, 4]


def test_registry_observers_and_nan_check():
    registry.reset_call_counts()
    seen = []
    dispatch.add_op_observer(lambda name, outs: seen.append(
        (name, [tuple(o.shape) for o in outs])))
    try:
        x = tpaddle.to_tensor([1.0, -1.0])
        tpaddle.exp(x).sum()
    finally:
        dispatch.op_observers.clear()
    assert registry.op_call_counts()["exp"] == 1
    assert registry.op_call_counts()["sum"] == 1
    assert seen == [("exp", [(2,)]), ("sum", [()])]

    @dispatch.defop("twice")
    def twice(a):
        return a * 2
    assert registry.get("twice").differentiable
    np.testing.assert_array_equal(twice(x).numpy(), [2.0, -2.0])

    tpaddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match=r"\[log\]"):
            tpaddle.log(x)
    finally:
        tpaddle.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(tpaddle.log(x).numpy()[1])


# -- the ops of the path, against the JAX package ----------------------------

def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_shape_ops_match_jax():
    a = _rand(2, 3, 4)
    ja, ta = _both(a)
    pairs = [
        (lambda m, t: t.reshape([4, -1]), None),
        (lambda m, t: m.reshape(t, [2, 12]), None),
        (lambda m, t: m.transpose(t, [2, 0, 1]), None),
        (lambda m, t: m.concat([t, t * 2.0], axis=1), None),
        (lambda m, t: m.repeat_interleave(t, 2, axis=2), None),
        (lambda m, t: m.sum(t, axis=[0, 2]), None),
        (lambda m, t: m.mean(t, axis=-1, keepdim=True), None),
        (lambda m, t: m.matmul(t, t, transpose_y=True), None),
        (lambda m, t: m.argmax(t, axis=-1), "int"),
        (lambda m, t: m.all(t > -10.0), "bool"),
        (lambda m, t: t[:1, 1:], None),
    ]
    for fn, kind in pairs:
        j = np.asarray(fn(jpaddle, ja).numpy())
        t = fn(tpaddle, ta)
        assert t.shape == list(j.shape)
        if kind is None:
            np.testing.assert_allclose(t.numpy(), j, **TOL)
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_along_axis_ops_match_jax():
    a = _rand(2, 5, seed=1)
    idx = np.array([[4, 0], [1, 1]], np.int64)
    ja, ta = _both(a)
    ji, ti = _both(idx)
    np.testing.assert_array_equal(
        tpaddle.take_along_axis(ta, ti, axis=1).numpy(),
        jpaddle.take_along_axis(ja, ji, axis=1).numpy())
    for reduce in ("assign", "add"):
        j = jpaddle.put_along_axis(ja, ji, 9.0, axis=1, reduce=reduce)
        t = tpaddle.put_along_axis(ta, ti, 9.0, axis=1, reduce=reduce)
        np.testing.assert_allclose(t.numpy(), j.numpy(), **TOL)


def test_creation_ops():
    assert tpaddle.zeros([2, 3]).numpy().sum() == 0
    assert tpaddle.ones([2], dtype="int64").dtype == torch.int64
    np.testing.assert_array_equal(tpaddle.full([2], 7.0).numpy(), [7, 7])
    assert tpaddle.arange(4).dtype == torch.int64
    np.testing.assert_allclose(tpaddle.arange(0.0, 1.0, 0.5).numpy(),
                               [0.0, 0.5])
    x = tpaddle.to_tensor([1.0, 2.0])
    y = tpaddle.to_tensor(x)
    y.set_value(np.array([5.0, 5.0]))
    np.testing.assert_array_equal(x.numpy(), [1.0, 2.0])   # a copy


# -- places and the RNG --------------------------------------------------------

def test_places():
    assert tpaddle.get_device() == "cpu"
    assert tpaddle.set_device("gpu:1") == tpaddle.CUDAPlace(1)
    assert tpaddle.get_device() == "gpu:1"
    tpaddle.set_device("cuda")
    assert tpaddle.get_device() == "gpu:0"
    with pytest.raises(ValueError):
        tpaddle.set_device("tpu")
    tpaddle.set_device("cpu")


def test_seed_and_rng_state_replay_initializers():
    tpaddle.seed(42)
    a = tpaddle.nn.Linear(8, 8).weight.numpy()
    state = tpaddle.get_rng_state()
    b = tpaddle.nn.Linear(8, 8).weight.numpy()
    tpaddle.set_rng_state(state)
    c = tpaddle.nn.Linear(8, 8).weight.numpy()
    tpaddle.seed(42)
    d = tpaddle.nn.Linear(8, 8).weight.numpy()
    np.testing.assert_array_equal(b, c)
    np.testing.assert_array_equal(a, d)
    assert not np.array_equal(a, b)
    # the global torch generator is neither seeded nor read
    before = torch.random.get_rng_state()
    tpaddle.seed(1)
    tpaddle.nn.Linear(4, 4)
    assert torch.equal(torch.random.get_rng_state(), before)
