"""The port's eager nn surface (nn.Layer and its containers, the
initializers, nn.Linear / nn.Embedding / nn.RMSNorm, nn.functional, the
eager fused RoPE and swiglu, recompute, amp.decorate and GradScaler, and
the optimizers with ClipGradByGlobalNorm) against the JAX package on the
CPU, with ``set_device("cpu")``; the JAX side's Pallas flash kernels in
interpret mode (PT_PALLAS_INTERPRET=1, restored after).

Tolerances: f32 functions of the same inputs within 1e-5 relative and
absolute (sums in other orders; attention: online softmax in the Pallas
kernel against the dense plain version); their gradients within 1e-5 of
each gradient's largest magnitude. Optimizers fed the same gradients:
parameters and moments within 1e-6 of their largest magnitude after 3
steps (the same f32 update; XLA may fuse a multiply and an add where
PyTorch rounds twice). Initializers: the sample mean within 5 standard
errors of the law's mean and the sample standard deviation within 2% of
the law's (262,144 draws: the standard error of the std is ~0.14%).
Recompute: gradients equal to the plain block's bit for bit (the same ops
run again on the same inputs).
"""
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet.recompute import recompute as jrecompute
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.framework.random import generator
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.utils import state_dict_from_paddle_tpu

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    old = os.environ.get("PT_PALLAS_INTERPRET")
    device = tpaddle.get_device()
    threads = torch.get_num_threads()
    os.environ["PT_PALLAS_INTERPRET"] = "1"
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tpaddle.set_device(device)
    if old is None:
        os.environ.pop("PT_PALLAS_INTERPRET", None)
    else:
        os.environ["PT_PALLAS_INTERPRET"] = old


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _net(nn):
    """One small model in either package, every container in it."""
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.proj = nn.Sequential(nn.Linear(8, 16), nn.RMSNorm(16))
            self.heads = nn.LayerList([nn.Linear(16, 4, bias_attr=False)
                                       for _ in range(2)])
            self.extra = nn.ParameterList([self.create_parameter([4])])
            self.named = nn.LayerDict({"out": nn.Linear(4, 3)})
            self.emb = nn.Embedding(10, 8, padding_idx=0)

        def forward(self, ids):
            h = self.proj(self.emb(ids))
            h = self.heads[0](h) + self.heads[1](h) + self.extra[0]
            return self.named["out"](h)
    return Block()


def _pair_nets():
    jpaddle.seed(3)
    jm = _net(jnn)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tpaddle.seed(3)
    tm = _net(tnn)
    assert tm.set_state_dict(state_dict_from_paddle_tpu(state)) == ([], [])
    return jm, tm, state


# -- Layer ------------------------------------------------------------------

def test_layer_names_and_state_dict_round_trip_match_jax():
    jm, tm, state = _pair_nets()
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert list(tm.state_dict()) == list(state)
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert len(tm.parameters()) == len(jm.parameters()) == 9
    assert isinstance(tm.parameters(), list)
    ids = np.array([[0, 3, 9], [1, 1, 2]], np.int64)
    np.testing.assert_allclose(tm(tpaddle.to_tensor(ids)).numpy(),
                               jm(jpaddle.to_tensor(ids)).numpy(), **TOL)
    # missing and unexpected names, as the JAX package reports them
    partial = dict(list(state.items())[1:], bogus=np.zeros(1))
    assert tm.set_state_dict(partial) == jm.set_state_dict(
        {k: jpaddle.to_tensor(v) for k, v in partial.items()})
    # the padding row looks up zeros
    np.testing.assert_array_equal(
        tm.emb(tpaddle.to_tensor(np.array([0]))).numpy(), np.zeros((1, 8)))


def test_layer_modes_hooks_to_and_clear_gradients():
    _, tm, _ = _pair_nets()
    tm.eval()
    assert not any(l.training for l in tm.sublayers(include_self=True))
    tm.train()
    assert all(l.training for l in tm.sublayers(include_self=True))
    calls = []
    h1 = tm.register_forward_pre_hook(lambda l, i: calls.append("pre"))
    h2 = tm.register_forward_post_hook(
        lambda l, i, o: o * 0.0)
    out = tm(tpaddle.to_tensor(np.array([[1, 2]])))
    assert calls == ["pre"] and not out.numpy().any()
    h1.remove(), h2.remove()
    out = tm(tpaddle.to_tensor(np.array([[1, 2]])))
    out.sum().backward()
    assert all(p.grad is not None for p in tm.parameters())
    tm.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())
    tm.to(dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 and p.is_leaf and
               not p.stop_gradient for p in tm.parameters())
    tm.astype("float32")
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_linear_has_a_bias_by_default_as_the_reference():
    lin = tnn.Linear(4, 3)
    assert [n for n, _ in lin.named_parameters()] == ["weight", "bias"]
    assert lin.weight.shape == [4, 3] and not lin.bias.numpy().any()
    assert [n for n, _ in tnn.Linear(4, 3, bias_attr=False)
            .named_parameters()] == ["weight"]
    norm = tnn.RMSNorm(6, epsilon=1e-5)
    np.testing.assert_array_equal(norm.weight.numpy(), np.ones(6))
    assert norm._epsilon == 1e-5


INIT_CASES = [
    ("Constant", (0.5,), 0.5, 0.0),
    ("Normal", (0.1, 2.0), 0.1, 2.0),
    ("Uniform", (-3.0, 1.0), -1.0, 4.0 / math.sqrt(12.0)),
    ("XavierNormal", (), 0.0, math.sqrt(2.0 / (512 + 512))),
    ("XavierUniform", (), 0.0, math.sqrt(6.0 / 1024) / math.sqrt(3.0)),
]


@pytest.mark.parametrize("name,args,mean,std", INIT_CASES)
def test_initializer_statistics(name, args, mean, std):
    tpaddle.seed(11)
    init = getattr(tnn.initializer, name)(*args)
    w = init([512, 512], "float32", torch.device("cpu"))
    assert w.dtype == torch.float32 and tuple(w.shape) == (512, 512)
    jw = np.asarray(getattr(jnn.initializer, name)(*args)(
        [512, 512], np.float32))
    for sample in (w.numpy(), jw):
        n = sample.size
        if std == 0.0:
            np.testing.assert_array_equal(sample, np.full_like(sample, mean))
            continue
        assert abs(sample.mean() - mean) <= 5 * std / math.sqrt(n)
        assert abs(sample.std() - std) <= 0.02 * std
    # bf16 parameters draw in f32 then cast
    assert init([4], "bfloat16", torch.device("cpu")).dtype == torch.bfloat16


# -- functional ---------------------------------------------------------------

def test_linear_rms_norm_embedding_match_jax():
    x, w, b = _rand(3, 8), _rand(8, 5, seed=1), _rand(5, seed=2)
    g = _rand(8, seed=3)
    cases = [
        (lambda F, t: F.linear(t(x), t(w), t(b)), None),
        (lambda F, t: F.linear(t(x), t(w)), None),
        (lambda F, t: F.rms_norm(t(x), t(g), 1e-6), None),
        (lambda F, t: F.rms_norm(t(x)), None),
        (lambda F, t: F.embedding(t(np.array([[0, 2], [2, 7]])), t(x.T),
                                  padding_idx=2), None),
    ]
    for fn, _ in cases:
        j = fn(JF, jpaddle.to_tensor).numpy()
        t = fn(TF, tpaddle.to_tensor).numpy()
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("kw", [
    {}, {"reduction": "sum"}, {"reduction": "none"}, {"ignore_index": 3},
    {"label_smoothing": 0.1}, {"weight": True}, {"soft_label": True}])
def test_cross_entropy_matches_jax(kw):
    logits = _rand(6, 5, seed=4, scale=3.0)
    lab = np.array([0, 3, 4, 3, 1, 2], np.int64)
    kw = dict(kw)
    if kw.pop("soft_label", False):
        lab = np.abs(_rand(6, 5, seed=5))
        lab /= lab.sum(-1, keepdims=True)
        kw["soft_label"] = True
    args = {}
    for lib in ("j", "t"):
        m = jpaddle if lib == "j" else tpaddle
        k = dict(kw)
        if k.pop("weight", False):
            k["weight"] = m.to_tensor(np.linspace(0.5, 2.0, 5)
                                      .astype(np.float32))
        x = m.to_tensor(logits, stop_gradient=False)
        loss = (JF if lib == "j" else TF).cross_entropy(
            x, m.to_tensor(lab), **k)
        loss.sum().backward()
        args[lib] = (loss.numpy(), x.grad.numpy())
    np.testing.assert_allclose(args["t"][0], args["j"][0], **TOL)
    np.testing.assert_allclose(args["t"][1], args["j"][1], **TOL)


@pytest.mark.parametrize("seq,causal", [(128, True), (32, True), (32, False)])
def test_scaled_dot_product_attention_matches_jax(seq, causal):
    """S = 128 is the kernels' shape (the JAX side runs its Pallas kernel
    in interpret mode), S = 32 the dense fallback on both sides."""
    q, k, v = (_rand(1, seq, 2, 64, seed=s) for s in (6, 7, 8))
    g = _rand(1, seq, 2, 64, seed=9)
    out = {}
    for F, m in ((JF, jpaddle), (TF, tpaddle)):
        ts = [m.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        o = F.scaled_dot_product_attention(*ts, is_causal=causal)
        (o * m.to_tensor(g)).sum().backward()
        out[F] = [o.numpy()] + [t.grad.numpy() for t in ts]
    for a, b in zip(out[TF], out[JF]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())


def test_swiglu_and_fused_rope_match_jax():
    a, b = _rand(2, 3, 8, seed=10), _rand(2, 3, 8, seed=11)
    np.testing.assert_allclose(
        TIF.swiglu(tpaddle.to_tensor(a), tpaddle.to_tensor(b)).numpy(),
        JIF.swiglu(jpaddle.to_tensor(a), jpaddle.to_tensor(b)).numpy(),
        **TOL)
    q, k = _rand(2, 5, 2, 8, seed=12), _rand(2, 5, 1, 8, seed=13)
    pos = np.array([[3, 4, 5, 6, 7]], np.int64)
    for kw in ({}, {"use_neox_rotary_style": False}, {"pos": True}):
        kw = dict(kw)
        res = []
        for IF, m in ((JIF, jpaddle), (TIF, tpaddle)):
            k2 = dict(kw)
            if k2.pop("pos", False):
                k2["position_ids"] = m.to_tensor(pos)
            tq, tk, tv = IF.fused_rotary_position_embedding(
                m.to_tensor(q), m.to_tensor(k), None,
                rotary_emb_base=500.0, **k2)
            assert tv is None
            res.append((tq.numpy(), tk.numpy()))
        for t, j in zip(res[1], res[0]):
            np.testing.assert_allclose(t, j, **TOL)


# -- recompute ----------------------------------------------------------------

def _block(layer):
    def f(x):
        return x + layer[1](TIF.swiglu(layer[0](x)))
    return f


@pytest.mark.parametrize("amp", [False, True])
def test_recompute_gradients_equal_the_plain_block(amp):
    tpaddle.seed(4)
    layers = [tnn.Sequential(tnn.RMSNorm(16), tnn.Linear(16, 32)),
              tnn.Linear(16, 16)]
    x0 = _rand(4, 16, seed=14)
    grads = []
    for use in (False, True):
        x = tpaddle.to_tensor(x0, stop_gradient=False)
        registry.reset_call_counts()
        with tpaddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            y = recompute(_block(layers), x) if use else _block(layers)(x)
        fwd = registry.op_call_counts().get("rms_norm", 0)
        y.astype("float32").sum().backward()
        # the backward ran the segment's forward again, AMP and all
        assert registry.op_call_counts()["rms_norm"] == fwd * (1 + use)
        params = [p for l in layers for p in l.parameters()]
        grads.append([x.grad.numpy()] + [p.grad.numpy() for p in params])
        for p in params:
            p.clear_grad()
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_recompute_replays_the_generators_and_matches_jax_recompute():
    tpaddle.seed(9)
    gen = generator(torch.device("cpu"))

    def noisy(t):
        mask = torch.rand(t.shape, generator=gen)
        return t * tpaddle.Tensor(mask)

    x = tpaddle.to_tensor(_rand(3, 4, seed=15), stop_gradient=False)
    y = recompute(noisy, x)
    after_forward = gen.get_state()
    mask = (y / x).numpy()
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), mask, rtol=1e-6)
    assert torch.equal(gen.get_state(), after_forward)
    # a linear block: the JAX package's recompute gives the same gradient
    w = _rand(4, 4, seed=16)
    res = []
    for m, rc in ((jpaddle, jrecompute), (tpaddle, recompute)):
        xx = m.to_tensor(_rand(3, 4, seed=17), stop_gradient=False)
        ww = m.to_tensor(w, stop_gradient=False)
        rc(lambda t: m.exp(m.matmul(t, ww)), xx).sum().backward()
        res.append((xx.grad.numpy(), ww.grad.numpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, **TOL)


# -- amp -----------------------------------------------------------------------

def test_decorate_o2_keeps_norms_f32_as_jax():
    jm, tm, _ = _pair_nets()
    jpaddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tpaddle.amp.decorate(tm, level="O2", dtype="bfloat16")
    jd = {n: str(np.dtype(p.dtype)) for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).replace("torch.", "")
          for n, p in tm.named_parameters()}
    assert td == jd and td["proj.1.weight"] == "float32"
    assert td["proj.0.weight"] == "bfloat16"


def test_grad_scaler_matches_jax():
    scales = {}
    for m in (jpaddle, tpaddle):
        p = m.to_tensor(np.ones(3, np.float32), stop_gradient=False)
        opt = m.optimizer.SGD(learning_rate=0.1, parameters=[p])
        scaler = m.amp.GradScaler(init_loss_scaling=8.0,
                                  incr_every_n_steps=2)
        seen = []
        for bad in (False, True, False, False):
            loss = scaler.scale((p * 2.0).sum())
            loss.backward()
            if bad:
                p.grad = m.to_tensor(np.array([np.inf, 0, 0], np.float32))
            scaler.step(opt)
            opt.clear_grad()
            seen.append((scaler.get_scale_ratio(), p.numpy().tolist()))
        scales[m] = seen
    assert scales[tpaddle] == scales[jpaddle]


# -- optimizers ----------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("AdamW", {"weight_decay": 0.05}), ("AdamW", {"clip": True}),
    ("Adam", {"weight_decay": 0.01}), ("SGD", {"weight_decay": 0.1})])
def test_optimizer_three_steps_match_jax(name, kw):
    """The same start and the same gradients (normal, ~1) for 3 steps."""
    shapes = [(8, 6), (6,), (5, 3)]
    start = [_rand(*s, seed=20 + i) for i, s in enumerate(shapes)]
    kw = dict(kw)
    results = {}
    for m in (jpaddle, tpaddle):
        params = [m.Parameter(m.to_tensor(a)._value) if m is jpaddle else
                  tpaddle.Parameter(torch.from_numpy(a.copy()))
                  for a in start]
        k = dict(kw)
        if k.pop("clip", False):
            k["grad_clip"] = m.optimizer.ClipGradByGlobalNorm(1.0)
        opt = getattr(m.optimizer, name)(learning_rate=0.01,
                                         parameters=params, **k)
        for step in range(3):
            for i, p in enumerate(params):
                p.grad = m.to_tensor(_rand(*shapes[i], seed=50 + 10 * step
                                           + i))
            opt.step()
            opt.clear_grad()
        state = opt.state_dict()
        results[m] = ([p.numpy() for p in params],
                      {k: np.asarray(v.numpy()) for k, v in state.items()
                       if k != "_step_count"}, state["_step_count"])
    (jp, js, jn), (tp_, ts, tn) = results[jpaddle], results[tpaddle]
    assert jn == tn == 3 and sorted(ts) == sorted(js)
    for a, b in list(zip(tp_, jp)) + [(ts[k], js[k]) for k in js]:
        assert float(np.abs(a - b).max()) <= 1e-6 * float(np.abs(b).max())
    for a, s in zip(tp_, start):
        assert float(np.abs(a - s).max()) > 1e-3


def test_clip_by_global_norm_and_optimizer_state_round_trip():
    grads = [torch.from_numpy(_rand(4, seed=30) * 10),
             torch.from_numpy(_rand(3, seed=31) * 10)]
    clip = tpaddle.optimizer.ClipGradByGlobalNorm(1.0)
    out = clip.apply(grads)
    norm = math.sqrt(sum(float(g.square().sum()) for g in out))
    assert abs(norm - 1.0) <= 1e-6
    jout = jpaddle.optimizer.ClipGradByGlobalNorm(1.0).apply(
        [jpaddle.to_tensor(g.numpy())._value for g in grads])
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # set_state_dict restores what state_dict gave (moments and the step)
    p = tpaddle.Parameter(torch.ones(3))
    opt = tpaddle.optimizer.AdamW(parameters=[p], learning_rate=0.1)
    p.grad = torch.ones(3)
    opt.step()
    saved = opt.state_dict()
    other = tpaddle.optimizer.AdamW(parameters=[p], learning_rate=0.1)
    other.set_state_dict({k: (v.numpy() if hasattr(v, "numpy") else v)
                          for k, v in saved.items()})
    assert other.state_dict()["_step_count"] == 1
    np.testing.assert_array_equal(other.state_dict()["param_0.moment1"]
                                  .numpy(), saved["param_0.moment1"].numpy())
    assert opt.get_lr() == 0.1 and opt.set_lr(0.5) == 0.5
