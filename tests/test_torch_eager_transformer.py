"""The port's eager transformer stack (F.layer_norm, F.gelu, F.tanh,
F.relu, F.dropout, nn.LayerNorm, nn.Dropout, the activation layers,
nn.CrossEntropyLoss, nn.MultiHeadAttention, nn.TransformerEncoderLayer,
nn.TransformerEncoder, the mask surface of F.scaled_dot_product_attention),
the incubate ``flash_attention`` entry, the attention ops of the op
registry and jit.TrainStep, against the JAX package on the CPU, with
``set_device("cpu")``; the JAX side's Pallas flash kernels in interpret
mode (PT_PALLAS_INTERPRET=1, restored after), its other Pallas paths off
(tests/conftest.py). Weights go from the JAX layer to the port's through
``utils.load_params_from_paddle_tpu``; inputs come from numpy seeds.

Tolerances: f32 functions of the same inputs within 1e-5 relative and
absolute (sums in other orders); attention layers' outputs within 1e-5 of
their largest magnitude and every parameter's gradient within 1e-4 of its
largest magnitude (online softmax in the Pallas kernel against the dense
plain version, XLA's dots against PyTorch's), plus 1e-6 of the largest
gradient of the layer: the k projection's bias has a gradient of zero
(softmax ignores a shift shared by every key), so both sides hold
round-off there. LayerNorm with bf16 x and an f32 weight: within one bf16
ulp (2**-7 relative), both sides rounding f32 results that differ in their
last bits. The registry's varlen ops equal the incubate function they call
bit for bit. Dropout draws from the port's generators, not jax.random, so
it is held by its keep share (within 5 standard errors of 1 - p), its
scaling (kept elements are x / (1 - p) exactly) and its repetition under
``paddle.seed``.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.utils import load_params_from_paddle_tpu

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


def _copy_params(jlayer, tlayer):
    assert [n for n, _ in tlayer.named_parameters()] == \
        [n for n, _ in jlayer.named_parameters()]
    load_params_from_paddle_tpu(tlayer, {n: np.asarray(p.numpy())
                                         for n, p in jlayer.named_parameters()})
    return tlayer


# -- functional ops -----------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_gelu_tanh_relu_match_jax(affine):
    x = _rand(2, 5, 16, scale=3.0) + 1.0
    w, b = _rand(16, seed=1), _rand(16, seed=2)
    cases = [
        lambda F, t: F.layer_norm(t(x), 16, t(w) if affine else None,
                                  t(b) if affine else None, 1e-5),
        lambda F, t: F.layer_norm(t(x), [5, 16], epsilon=1e-12),
        lambda F, t: F.gelu(t(x)),
        lambda F, t: F.gelu(t(x), approximate=True),
        lambda F, t: F.tanh(t(x)),
        lambda F, t: F.relu(t(x)),
    ]
    for fn in cases:
        outs = {}
        for F, m in ((JF, jpaddle), (TF, tpaddle)):
            xt = m.to_tensor(x, stop_gradient=False)
            t = lambda a: xt if a is x else m.to_tensor(a)  # noqa: E731
            o = fn(F, t)
            (o * m.to_tensor(_rand(*o.shape, seed=3))).sum().backward()
            outs[F] = (o.numpy(), xt.grad.numpy())
        for a, b in zip(outs[TF], outs[JF]):
            np.testing.assert_allclose(a, b, **TOL)


def test_layer_norm_bf16_x_with_f32_weight_matches_jax():
    """O2: bf16 activations meet the f32 LayerNorm weights; computed in f32,
    returned in x's dtype."""
    x = _rand(4, 64, scale=2.0)
    w, b = _rand(64, seed=1), _rand(64, seed=2)
    outs = {}
    for F, m in ((JF, jpaddle), (TF, tpaddle)):
        o = F.layer_norm(m.to_tensor(x).astype("bfloat16"), 64,
                         m.to_tensor(w), m.to_tensor(b))
        assert "bfloat16" in str(o.dtype)
        outs[F] = o.astype("float32").numpy()
    ref = outs[JF]
    assert bool((np.abs(outs[TF] - ref) <= 2.0 ** -7 * np.abs(ref)
                 + 1e-6).all())


def test_cross_entropy_loss_layer_with_ignore_index_matches_jax():
    logits = _rand(8, 7, seed=4, scale=3.0)
    lab = np.array([0, 3, -100, 6, 1, -100, 2, 5], np.int64)
    outs = {}
    for nn, m in ((jnn, jpaddle), (tnn, tpaddle)):
        x = m.to_tensor(logits, stop_gradient=False)
        loss = nn.CrossEntropyLoss(ignore_index=-100)(x, m.to_tensor(lab))
        loss.backward()
        outs[nn] = (loss.numpy(), x.grad.numpy())
    for a, b in zip(outs[tnn], outs[jnn]):
        np.testing.assert_allclose(a, b, **TOL)
    # ignored rows take no gradient
    assert not outs[tnn][1][[2, 5]].any()


def test_dropout_keep_share_scaling_and_seed():
    p = 0.1
    x = torch.rand(64, 1024) + 0.5
    xt = tpaddle.to_tensor(x.numpy())
    tpaddle.seed(11)
    a = TF.dropout(xt, p).numpy()
    tpaddle.seed(11)
    b = TF.dropout(xt, p).numpy()
    c = TF.dropout(xt, p).numpy()
    np.testing.assert_array_equal(a, b)              # repeated by the seed
    assert not np.array_equal(b, c)                  # fresh on the next call
    kept = a != 0
    n = kept.size
    share = kept.mean()
    assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    xs = x.numpy()
    np.testing.assert_array_equal(
        a[kept], (torch.from_numpy(xs[kept]) / (1 - p)).numpy())
    # downscale_in_infer keeps values; eval mode and p = 0 are the identity
    d = TF.dropout(xt, p, mode="downscale_in_infer").numpy()
    np.testing.assert_array_equal(d[d != 0], xs[d != 0])
    assert TF.dropout(xt, p, training=False) is xt
    assert TF.dropout(xt, 0.0) is xt
    layer = tnn.Dropout(p)
    layer.eval()
    assert layer(xt) is xt
    # axis: one draw along axis 0, shared by the other axis
    e = TF.dropout(xt, 0.5, axis=0).numpy()
    rows = (e != 0).all(axis=1) | (e == 0).all(axis=1)
    assert rows.all()


def test_activation_layers_and_amp_o2_keeps_layer_norm_f32_as_jax():
    def net(nn):
        return nn.Sequential(nn.Linear(8, 16), nn.LayerNorm(16), nn.GELU(),
                             nn.Linear(16, 16), nn.Tanh(), nn.ReLU(),
                             nn.GELU(approximate=True), nn.Linear(16, 4))
    jpaddle.seed(1)
    jm = net(jnn)
    tm = _copy_params(jm, net(tnn))
    x = _rand(3, 8)
    np.testing.assert_allclose(tm(tpaddle.to_tensor(x)).numpy(),
                               jm(jpaddle.to_tensor(x)).numpy(), **TOL)
    assert [type(l).__name__ for l in tm] == [type(l).__name__ for l in jm]
    jpaddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tpaddle.amp.decorate(tm, level="O2", dtype="bfloat16")
    jd = {n: str(np.dtype(p.dtype)) for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).replace("torch.", "")
          for n, p in tm.named_parameters()}
    assert td == jd
    assert td["1.weight"] == td["1.bias"] == "float32"
    assert td["0.weight"] == "bfloat16"


def test_zeros_like_unsqueeze_and_first_token_index():
    x = tpaddle.to_tensor(np.arange(6).reshape(2, 3))
    z = tpaddle.zeros_like(x)
    assert z.dtype == torch.int64 and z.shape == [2, 3] and not z.numpy().any()
    assert tpaddle.zeros_like(x, dtype="float32").dtype == torch.float32
    jx = jpaddle.to_tensor(np.arange(6).reshape(2, 3))
    for axis in (0, -1, [0, -1], [2, 0]):
        assert x.unsqueeze(axis).shape == jx.unsqueeze(axis).shape, axis
    np.testing.assert_array_equal(x[:, 0].numpy(), [0, 3])


# -- attention layers ---------------------------------------------------------

E, HEADS = 128, 2            # head_dim 64: a kernel head dim


def _masks(b, s, kind):
    """The mask of ``kind`` in numpy, for both packages."""
    rng = np.random.RandomState(5)
    if kind is None:
        return None
    if kind == "bool [B,1,1,S]":
        m = np.ones((b, 1, 1, s), bool)
        m[0, ..., s // 3:] = False
        return m
    if kind == "float [B,1,1,S]":
        m = np.zeros((b, 1, 1, s), np.float32)
        m[-1, ..., : s // 4] = -1e9
        return m
    if kind == "2-D [S,S]":
        return np.tril(np.ones((s, s), bool))
    m = rng.rand(b, HEADS, s, s) > 0.3                     # [B, H, S, S]
    m[..., 0] = True
    return m


def _attention_pair(make):
    jpaddle.seed(7)
    jl = make(jnn)
    return jl, _copy_params(jl, make(tnn))


def _run_layer(layer, m, x, mask, extra=()):
    xt = m.to_tensor(x, stop_gradient=False)
    mt = m.to_tensor(mask) if mask is not None else None
    out = layer(xt, *extra, mt) if extra else layer(xt, src_mask=mt)
    (out * m.to_tensor(_rand(*out.shape, seed=9))).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return out.numpy(), xt.grad.numpy(), grads


def _hold_layer(got, ref):
    (o, gx, gp), (o2, gx2, gp2) = got, ref
    assert o.shape == o2.shape
    assert float(np.abs(o - o2).max()) <= 1e-5 * float(np.abs(o2).max())
    assert float(np.abs(gx - gx2).max()) <= 1e-4 * float(np.abs(gx2).max())
    top = max(float(np.abs(g).max()) for g in gp2.values())
    assert set(gp) == set(gp2)
    for n, g in gp2.items():
        assert float(np.abs(gp[n] - g).max()) <= \
            1e-4 * float(np.abs(g).max()) + 1e-6 * top, n


MASKS = [None, "bool [B,1,1,S]", "float [B,1,1,S]", "2-D [S,S]",
         "generic [B,H,S,S]"]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("seq", [128, 32])
def test_multi_head_attention_matches_jax(mask, seq):
    """S = 128 is a kernel shape: the [B,1,1,S] masks go through the
    kernels' key-padding bias (the JAX side's Pallas kernel in interpret
    mode, the port's plain version), the other masks through the dense
    attention; S = 32 takes the dense routes on both sides."""
    jl, tl = _attention_pair(lambda nn: nn.MultiHeadAttention(E, HEADS))
    x = _rand(2, seq, E, seed=seq)
    m = _masks(2, seq, mask)
    reset_launch_counts()
    got = _run_layer(tl, tpaddle, x, m, extra=(None, None))
    assert launch_counts()["flash_attention_fwd"] == 0          # the CPU
    _hold_layer(got, _run_layer(jl, jpaddle, x, m, extra=(None, None)))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("mask", MASKS)
def test_transformer_encoder_layer_matches_jax(normalize_before, mask):
    def make(nn):
        return nn.TransformerEncoderLayer(
            E, HEADS, 256, dropout=0.0, activation="gelu",
            normalize_before=normalize_before)
    jl, tl = _attention_pair(make)
    x = _rand(2, 128, E, seed=4)
    m = _masks(2, 128, mask)
    _hold_layer(_run_layer(tl, tpaddle, x, m), _run_layer(jl, jpaddle, x, m))


def test_transformer_encoder_copies_layers_with_their_own_parameters():
    def make(nn):
        layer = nn.TransformerEncoderLayer(E, HEADS, 256, dropout=0.0)
        return nn.TransformerEncoder(layer, 3, norm=nn.LayerNorm(E))
    jl, tl = _attention_pair(make)
    names = [n for n, _ in tl.named_parameters()]
    assert names == [n for n, _ in jl.named_parameters()]
    assert "layers.2.self_attn.q_proj.weight" in names and len(names) == 50
    p = dict(tl.named_parameters())
    a, b = p["layers.0.linear1.weight"], p["layers.1.linear1.weight"]
    assert a is not b and a._value.data_ptr() != b._value.data_ptr()
    # the copies start from the first layer's values, as the reference's
    assert torch.equal(a._value, b._value)
    x, m = _rand(2, 128, E, seed=6), _masks(2, 128, "bool [B,1,1,S]")
    _hold_layer(_run_layer(tl, tpaddle, x, m), _run_layer(jl, jpaddle, x, m))


def test_attention_dropout_on_generic_masks_under_amp():
    """Dropout with a generic mask takes the dense attention, in f32 under
    AMP O1 (the probabilities dropped at 1 - p and scaled by 1 / (1 - p)):
    repeated under paddle.seed, bf16 out as SDPA is white-listed, and with
    p = 0 equal to the layer without dropout."""
    q, k, v = (tpaddle.to_tensor(_rand(2, 32, HEADS, 64, seed=s))
               for s in (1, 2, 3))
    mask = tpaddle.to_tensor(_masks(2, 32, "generic [B,H,S,S]"))
    runs = []
    for _ in range(2):
        tpaddle.seed(3)
        with tpaddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            o = TF.scaled_dot_product_attention(q, k, v, mask, dropout_p=0.5)
        assert o.dtype == torch.bfloat16
        runs.append(o.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    with tpaddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        nodrop = TF.scaled_dot_product_attention(q, k, v, mask).numpy()
    assert not np.array_equal(runs[0], nodrop)


# -- the incubate entry and the registry ops --------------------------------

def test_incubate_flash_attention_matches_jax():
    q, k, v = (_rand(2, 128, HEADS, 64, seed=s) for s in (1, 2, 3))
    outs = {}
    for IF, m in ((JIF, jpaddle), (TIF, tpaddle)):
        t = [m.to_tensor(a) for a in (q, k, v)]
        res = IF.flash_attention(*t, causal=True)
        assert isinstance(res, tuple) and res[1] is None    # False: a tuple
        out = IF.flash_attention(*t, causal=True, return_softmax=None)
        assert not isinstance(out, tuple)
        outs[IF] = (res[0].numpy(), out.numpy())
    for a, b in zip(outs[TIF], outs[JIF]):
        np.testing.assert_allclose(a, b, **TOL)


def _packed(total_lens, h=HEADS, d=64, seed=0):
    cu = np.concatenate([[0], np.cumsum(total_lens)]).astype(np.int32)
    q, k, v = (_rand(int(cu[-1]), h, d, seed=seed + s) for s in range(3))
    return q, k, v, cu


@pytest.mark.parametrize("causal", [True, False])
def test_registry_attention_ops_match_jax(causal):
    K = {n: registry.get(n).fn for n in ("flash_attn", "flash_attn_qkvpacked",
                                         "flash_attn_unpadded",
                                         "flash_attn_varlen_qkvpacked")}
    JK = {n: jregistry.get(n).fn for n in K}
    q, k, v = (_rand(2, 128, HEADS, 64, seed=s) for s in (4, 5, 6))
    mask = _masks(2, 128, "bool [B,1,1,S]")
    for kw in ({"causal": causal}, {"attn_mask": mask}):
        got = K["flash_attn"](*(torch.from_numpy(a) for a in (q, k, v)),
                              **{a: torch.from_numpy(b) if a == "attn_mask"
                                 else b for a, b in kw.items()})
        ref = JK["flash_attn"](q, k, v, **kw)
        assert got[1:] == (None, None, None)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    qkv = np.stack([q, k, v], axis=2)
    got = K["flash_attn_qkvpacked"](torch.from_numpy(qkv), causal=causal)
    ref = JK["flash_attn_qkvpacked"](qkv, causal=causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    # varlen: 5 documents in 256 tokens (the kernel route: the default
    # scale), and the per-segment route with an explicit scale
    pq, pk, pv, cu = _packed([100, 28, 64, 50, 14])
    for scale in (None, 0.3):
        got = K["flash_attn_unpadded"](
            *(torch.from_numpy(a) for a in (pq, pk, pv)), cu, cu,
            scale=scale, causal=causal)
        ref = JK["flash_attn_unpadded"](pq, pk, pv, cu, cu, scale=scale,
                                        causal=causal)
        assert got[1:] == (None, None, None)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    pqkv = np.stack([pq, pk, pv], axis=1)
    got = K["flash_attn_varlen_qkvpacked"](torch.from_numpy(pqkv), cu, cu,
                                           causal=causal)
    ref = JK["flash_attn_varlen_qkvpacked"](pqkv, cu, cu, causal=causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    with pytest.raises(NotImplementedError):
        K["flash_attn_unpadded"](*(torch.from_numpy(a) for a in (pq, pk, pv)),
                                 cu, cu, attn_mask=torch.ones(1))


def test_registry_varlen_ops_equal_the_incubate_function_with_gradients():
    """Forward and backward through the registry ops are the incubate
    function's, bit for bit; eager Tensors in give a Tensor out."""
    pq, pk, pv, cu = _packed([200, 56], seed=3)
    g = torch.from_numpy(_rand(256, HEADS, 64, seed=9))
    res = []
    for route in ("incubate", "op", "qkvpacked", "tensor"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (pq, pk, pv)]
        if route == "incubate":
            out, _ = TIF.flash_attn_unpadded(*ts, cu, cu, causal=True)
        elif route == "op":
            out = registry.get("flash_attn_unpadded").fn(
                *ts, cu, cu, scale=None, causal=True)[0]
        elif route == "tensor":
            tt = [tpaddle.Tensor._wrap(t) for t in ts]
            out, _ = TIF.flash_attn_unpadded(*tt, tpaddle.to_tensor(cu),
                                             cu, causal=True)
            assert isinstance(out, tpaddle.Tensor)
            out = out._value
        else:
            qkv = torch.stack(ts, dim=1)
            out = registry.get("flash_attn_varlen_qkvpacked").fn(
                qkv, cu, cu, causal=True)[0]
        torch.autograd.backward(out, g)
        res.append([out.detach()] + [t.grad for t in ts])
    for other in res[1:]:
        for a, b in zip(other, res[0]):
            assert torch.equal(a, b)


# -- TrainStep ----------------------------------------------------------------

def test_train_step_semantics():
    """Forward and loss_fn, backward, step and clear_grad, the train mode
    restored, the loss returned detached; without loss_fn the model's own
    loss."""
    class Net(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(4, 3)
            self.drop = tnn.Dropout(0.5)
            self.seen = []

        def forward(self, x, y=None):
            self.seen.append(self.training)
            out = self.fc(self.drop(x))
            return out if y is None else TF.cross_entropy(out, y)

    net = Net()
    net.eval()
    opt = tpaddle.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())
    x = _rand(5, 4)
    y = np.array([0, 1, 2, 1, 0], np.int64)
    w0 = net.fc.weight.numpy().copy()
    step = TrainStep(net, tnn.CrossEntropyLoss(), opt)
    loss = step(tpaddle.to_tensor(x), tpaddle.to_tensor(y))
    assert net.seen == [True] and not net.training
    assert loss.stop_gradient and loss.shape == []
    assert not np.array_equal(net.fc.weight.numpy(), w0)
    assert all(p.grad is None for p in net.parameters())
    step_eval = TrainStep(net, None, opt, train=False)
    loss2 = step_eval(x, y)                      # numpy in, Tensors made
    assert net.seen == [True, False] and not net.training
    expect = TF.cross_entropy(net.fc(tpaddle.to_tensor(x)),
                              tpaddle.to_tensor(y))
    assert float(loss2) > float(expect)          # the step moved downhill


def test_train_step_matches_jax_train_step_f32():
    """Three TrainStep SGD steps of a small MLP with a loss layer: the
    losses within 1e-5 relative and the parameters within 1e-6 of their
    largest magnitude of the JAX package's fused TrainStep."""
    def net(nn):
        return nn.Sequential(nn.Linear(8, 32), nn.LayerNorm(32), nn.GELU(),
                             nn.Linear(32, 5))
    jpaddle.seed(2)
    jm = net(jnn)
    tm = _copy_params(jm, net(tnn))
    x, y = _rand(6, 8, seed=1), np.array([0, 1, 4, 3, 2, 1], np.int64)
    out = {}
    for m, lib, TS, nn in ((jm, jpaddle, JTrainStep, jnn),
                           (tm, tpaddle, TrainStep, tnn)):
        opt = lib.optimizer.SGD(learning_rate=0.5, parameters=m.parameters())
        step = TS(m, nn.CrossEntropyLoss(), opt)
        losses = [float(step(lib.to_tensor(x), lib.to_tensor(y)).numpy())
                  for _ in range(3)]
        out[lib] = (losses, {n: p.numpy() for n, p in m.named_parameters()})
    np.testing.assert_allclose(out[tpaddle][0], out[jpaddle][0], rtol=1e-5)
    for n, p in out[jpaddle][1].items():
        assert float(np.abs(out[tpaddle][1][n] - p).max()) <= \
            1e-6 * float(np.abs(p).max()), n
