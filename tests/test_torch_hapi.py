"""The port's io, LR schedulers, Momentum and the regularizers, SGD's
write-back, metric, save / load and hapi.Model against the JAX package on
the CPU, with ``set_device("cpu")``.

- io: the samplers' orders (sequence, batch, distributed with a shuffle of
  its epoch, random_split's subsets), default_collate_fn's structures and
  dtypes, and DataLoader's batches with 0 and 2 workers, equal to the
  reference's;
- every LR scheduler's value over 30 steps, alone and as an SGD's
  learning rate (parameters equal bit for bit: one f32 multiply and
  subtract a step), and set_lr refused under one;
- Momentum (plain, Nesterov, L2Decay, L1Decay, a float decay) over 3 steps
  of the same gradients: parameters and velocities within 1e-6 of their
  largest magnitude (XLA may fuse a multiply and an add);
- SGD on a bf16 parameter: p - (lr * g).astype(bf16), bit for bit the
  reference's (a round of p - lr * g in f32 differs in ~0.3% of elements),
  and f32 unchanged;
- the metrics on the same predictions: equal (numpy on both sides);
- Model.fit / evaluate / predict of LeNet (the reference's weights,
  shuffle=False): per-batch losses within 1e-5 relative, the final
  parameters within 1e-4 of their largest magnitude (Adam divides by
  sqrt(v): a near-zero gradient's step takes either sign), the eval logs
  and predictions within 1e-5;
- save / load both ways between the packages, the optimizer's state and
  its scheduler's included.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import io as jio
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.utils import load_state_dict_from_paddle_tpu


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


def _tree(x):
    """Batches as nested numpy, with their dtypes (int64 for int32: the
    reference's int64 arrays are int32 under JAX's default, x64 off)."""
    if isinstance(x, (tuple, list)):
        return [_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    a = np.asarray(x.numpy())
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return (a, str(a.dtype))


# -- io ---------------------------------------------------------------------

class _Pairs:
    def __init__(self, io, n=10):
        self.n = n

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), i, float(i) / 2,
                {"id": np.array([i, -i], np.int64)})

    def __len__(self):
        return self.n


def _dataset(io, n=10):
    cls = type("Pairs", (_Pairs, io.Dataset), {})
    return cls(io, n)


def test_samplers_and_random_split_match_jax():
    orders = {}
    for io in (jio, tio):
        ds = _dataset(io, 11)
        dist = [list(io.DistributedBatchSampler(ds, 3, num_replicas=2,
                                                 rank=r, shuffle=True))
                for r in (0, 1)]
        s = io.DistributedBatchSampler(ds, 3, num_replicas=2, rank=1,
                                       shuffle=True, drop_last=True)
        s.set_epoch(3)
        orders[io] = (list(io.SequenceSampler(ds)),
                      list(io.BatchSampler(ds, batch_size=4)),
                      list(io.BatchSampler(ds, batch_size=4,
                                           drop_last=True)),
                      dist, list(s), len(s),
                      [d.indices for d in io.random_split(ds, [4, 7])],
                      [len(d) for d in io.random_split(ds, [0.5, 0.5])])
        assert sorted(io.RandomSampler(ds)) == list(range(11))
    assert orders[tio] == orders[jio]


def test_collate_and_dataloader_match_jax():
    got = {}
    for io, workers in ((jio, 0), (tio, 0), (tio, 2)):
        ds = _dataset(io)
        batches = [_tree(b) for b in io.DataLoader(
            ds, batch_size=4, num_workers=workers)]
        got[(io, workers)] = batches
    want = got[(jio, 0)]
    assert len(want) == 3
    for key in ((tio, 0), (tio, 2)):
        assert len(got[key]) == len(want)
        for a, b in zip(got[key], want):
            assert str(a) == str(b)
    t = tio.default_collate_fn([np.zeros(2, np.float32)] * 3)
    assert isinstance(t, tpaddle.Tensor) and t.place == tpaddle.CPUPlace()
    assert tio.get_worker_info() is None


# -- LR schedulers ----------------------------------------------------------

SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=5, learning_rate=1.0)),
    ("PiecewiseDecay", dict(boundaries=[3, 9], values=[0.1, 0.05, 0.01])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=10)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=7, power=2.0,
                             cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.5, warmup_steps=5, start_lr=0.0,
                          end_lr=0.5)),
    ("LinearWarmup", dict(learning_rate="cos", warmup_steps=4,
                          start_lr=0.01, end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[4, 11])),
    ("StepDecay", dict(learning_rate=0.5, step_size=4, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.5, lr_lambda="lambda")),
    ("MultiplicativeDecay", dict(learning_rate=0.5, lr_lambda="lambda")),
    ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=12)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.5, T_0=4,
                                         T_mult=2)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=30)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=20,
                        anneal_strategy="linear")),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=4)),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=3, mode="triangular2")),
    ("LinearLR", dict(learning_rate=0.5, total_steps=12)),
    ("ReduceOnPlateau", dict(learning_rate=0.5, patience=2, factor=0.5))]


def _scheduler(lr, name, kw):
    kw = dict(kw)
    for k, v in kw.items():
        if v == "lambda":
            kw[k] = lambda e: 0.95 ** e
        elif v == "cos":
            kw[k] = lr.CosineAnnealingDecay(0.1, T_max=10)
    return getattr(lr, name)(**kw)


def _schedule(m, lr, name, kw, steps=30):
    """The scheduler's values over ``steps`` steps, alone and as an SGD's
    learning rate (a parameter stepped with gradient 1 each step)."""
    alone, sched = [], _scheduler(lr, name, kw)
    plateau = name == "ReduceOnPlateau"
    for i in range(steps):
        alone.append(sched())
        sched.step(float(abs(10 - i))) if plateau else sched.step()
    sched = _scheduler(lr, name, kw)
    p = m.Parameter(m.to_tensor(np.zeros(3, np.float32))._value) \
        if m is jpaddle else m.Parameter(torch.zeros(3))
    opt = m.optimizer.SGD(learning_rate=sched, parameters=[p])
    seen = []
    for i in range(steps):
        p.grad = m.to_tensor(np.ones(3, np.float32))
        seen.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step(float(abs(10 - i))) if plateau else sched.step()
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    return alone, seen, p.numpy().tolist(), opt.state_dict()["LR_Scheduler"]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_lr_scheduler_values_match_jax(name, kw):
    j = _schedule(jpaddle, jlr, name, kw)
    t = _schedule(tpaddle, tlr, name, kw)
    assert t[0] == j[0] and t[1] == j[1] == j[0]
    assert t[2] == j[2] and t[3] == j[3]
    assert len(set(t[0])) > 1


# -- optimizers -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"use_nesterov": True}, {"weight_decay": "L2"},
    {"weight_decay": "L1"}, {"weight_decay": 0.01, "use_nesterov": True}])
def test_momentum_and_regularizers_match_jax(kw):
    shapes = [(8, 6), (6,), (5, 3)]
    start = [_rand(*s, seed=30 + i) for i, s in enumerate(shapes)]
    res = {}
    for m in (jpaddle, tpaddle):
        k = dict(kw)
        if k.get("weight_decay") == "L2":
            k["weight_decay"] = m.regularizer.L2Decay(0.05)
        elif k.get("weight_decay") == "L1":
            k["weight_decay"] = m.regularizer.L1Decay(0.05)
        params = [m.Parameter(m.to_tensor(a)._value) if m is jpaddle else
                  tpaddle.Parameter(torch.from_numpy(a.copy()))
                  for a in start]
        opt = m.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                   parameters=params, **k)
        for step in range(3):
            for i, p in enumerate(params):
                p.grad = m.to_tensor(_rand(*shapes[i], seed=60 + 10 * step
                                           + i))
            opt.step()
            opt.clear_grad()
        state = opt.state_dict()
        res[m] = ([p.numpy() for p in params],
                  {k: np.asarray(v.numpy()) for k, v in state.items()
                   if k != "_step_count"})
    (jp, js), (tp_, ts) = res[jpaddle], res[tpaddle]
    assert sorted(ts) == sorted(js) and len(js) == 3
    for a, b in list(zip(tp_, jp)) + [(ts[k], js[k]) for k in js]:
        assert float(np.abs(a - b).max()) <= 1e-6 * float(np.abs(b).max())


def test_regularizers_as_the_reference():
    for m in (jpaddle, tpaddle):
        assert str(m.regularizer.L2Decay(0.5)) == "L2Decay, coeff=0.5"
        assert m.regularizer.L1Decay(2).coeff == 2.0
    p, g = _rand(4, seed=1), _rand(4, seed=2)
    t = tpaddle.regularizer.L1Decay(0.5)(tpaddle.to_tensor(p),
                                         tpaddle.to_tensor(g))
    np.testing.assert_allclose(t.numpy(), g + 0.5 * np.sign(p), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sgd_writes_back_the_rounded_step_as_jax(dtype):
    """p - (lr * g).astype(p.dtype): on bf16 parameters the rounded step
    differs from rounding p - lr * g computed in f32 (87 of 100,000
    elements here, the write-back the port had before), and the port's
    bits are the reference's. On f32 parameters the port's update is the
    f32 p - lr * g it always was (the reference's within one rounding at
    the operands' scale: XLA fuses the multiply and the subtract)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(100_000).astype(np.float32)
    g = (rng.randn(100_000) * 0.01).astype(np.float32)
    out = {}
    for m in (jpaddle, tpaddle):
        v = m.to_tensor(p0, dtype=dtype)
        p = m.Parameter(v._value)
        opt = m.optimizer.SGD(learning_rate=0.1, parameters=[p])
        p.grad = m.to_tensor(g, dtype=dtype)
        opt.step()
        out[m] = p.numpy().astype(np.float32)
    if dtype == "float32":
        plain = torch.from_numpy(p0) - 0.1 * torch.from_numpy(g)
        np.testing.assert_array_equal(out[tpaddle], plain.numpy())
        scale = np.abs(p0) + 0.1 * np.abs(g)
        assert float((np.abs(out[tpaddle] - out[jpaddle]) / scale).max()) \
            <= 2.0 ** -23
        return
    np.testing.assert_array_equal(out[tpaddle], out[jpaddle])
    f32 = torch.from_numpy(p0).bfloat16().float() \
        - 0.1 * torch.from_numpy(g).bfloat16().float()
    assert (f32.bfloat16().float().numpy() != out[jpaddle]).sum() == 87


# -- metric -----------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(32, 6).astype(np.float32)
    labels = rng.randint(0, 6, (32, 1)).astype(np.int64)
    probs = rng.rand(40).astype(np.float32)
    binary = (rng.rand(40) > 0.4).astype(np.int64)
    res = {}
    for m in (jpaddle, tpaddle):
        acc = m.metric.Accuracy(topk=(1, 3))
        r = acc.update(acc.compute(m.to_tensor(logits), m.to_tensor(labels)))
        prec, rec, auc = m.metric.Precision(), m.metric.Recall(), \
            m.metric.Auc()
        for met in (prec, rec):
            met.update(m.to_tensor(probs), m.to_tensor(binary))
        auc.update(np.stack([1 - probs, probs], 1), binary)
        top2 = m.metric.accuracy(m.to_tensor(logits), m.to_tensor(labels),
                                 k=2)
        res[m] = (r, acc.accumulate(), acc.name(), prec.accumulate(),
                  rec.accumulate(), auc.accumulate(), float(top2.numpy()))
    assert res[tpaddle] == res[jpaddle]


# -- Model and save / load ---------------------------------------------------

class _Record:
    """A callback keeping each train batch's loss."""

    def __init__(self, base):
        self.cb = type("Record", (base,), {
            "on_train_batch_end": lambda s, step, logs=None:
            self.losses.append(logs["loss"])})()
        self.losses = []


def _fit(m, state):
    from_ref = m is jpaddle
    net = m.vision.models.LeNet()
    if from_ref:
        net.set_state_dict({k: m.to_tensor(v) for k, v in state.items()})
    else:
        load_state_dict_from_paddle_tpu(net, state)
    model = m.Model(net)
    model.prepare(m.optimizer.Adam(parameters=model.parameters(),
                                   learning_rate=1e-3),
                  m.nn.CrossEntropyLoss(), m.metric.Accuracy())
    rec = _Record(m.hapi.callbacks.Callback)
    train = m.vision.datasets.MNIST(mode="train")
    train = m.io.Subset(train, list(range(256)))
    model.fit(train, batch_size=32, epochs=1, verbose=0, shuffle=False,
              callbacks=[rec.cb])
    test = m.io.Subset(m.vision.datasets.MNIST(mode="test"),
                       list(range(96)))
    logs = model.evaluate(test, batch_size=32, verbose=0)
    pred = model.predict(test, batch_size=48, stack_outputs=True)
    params = {k: v.numpy() for k, v in net.state_dict().items()}
    return rec.losses, logs, pred, params


def test_model_fit_evaluate_predict_match_jax():
    jpaddle.seed(0)
    state = {k: np.asarray(v.numpy()) for k, v in
             jpaddle.vision.models.LeNet().state_dict().items()}
    (jl, jlogs, jpred, jp), (tl, tlogs, tpred, tp_) = (
        _fit(m, state) for m in (jpaddle, tpaddle))
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert sorted(tlogs) == sorted(jlogs) == ["acc", "loss"]
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    assert tlogs["acc"] == jlogs["acc"]
    assert len(tpred) == 1 and tpred[0].shape == (96, 10)
    np.testing.assert_allclose(tpred[0], jpred[0], rtol=1e-5, atol=1e-5)
    for k, v in jp.items():
        assert float(np.abs(tp_[k] - v).max()) <= 1e-4 * np.abs(v).max()


def test_model_train_eval_predict_batch_and_summary():
    tpaddle.seed(0)
    model = tpaddle.Model(tpaddle.vision.models.LeNet())
    model.prepare(tpaddle.optimizer.SGD(learning_rate=0.1,
                                        parameters=model.parameters()),
                  tpaddle.nn.CrossEntropyLoss(), tpaddle.metric.Accuracy())
    x = _rand(4, 1, 28, 28, seed=3)
    y = np.array([[1], [2], [3], [4]], np.int64)
    loss, metrics = model.train_batch([x], [y])
    assert np.isfinite(loss[0]) and len(metrics) == 1
    eval_loss, _ = model.eval_batch([x], [y])
    assert eval_loss[0] < loss[0]
    assert model.predict_batch([x])[0].shape == (4, 10)
    info = model.summary()
    assert info["total_params"] == info["trainable_params"] == 61_610


def test_save_load_across_packages(tmp_path):
    jpaddle.seed(1)
    jnet = jpaddle.vision.models.LeNet()
    tnet = tpaddle.vision.models.LeNet()
    x = _rand(2, 1, 28, 28, seed=4)
    # the reference's file into the port
    jpaddle.save(jnet.state_dict(), str(tmp_path / "j.pdparams"))
    assert tnet.set_state_dict(tpaddle.load(str(tmp_path / "j.pdparams"))) \
        == ([], [])
    np.testing.assert_allclose(tnet(tpaddle.to_tensor(x)).numpy(),
                               jnet(jpaddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    # the port's file (an optimizer's state and scheduler too) back
    opt = tpaddle.optimizer.Momentum(
        learning_rate=tlr.StepDecay(0.1, step_size=2), momentum=0.9,
        parameters=tnet.parameters())
    loss = tnet(tpaddle.to_tensor(x)).sum()
    loss.backward()
    opt.step()
    opt._learning_rate.step()
    tpaddle.save(tnet.state_dict(), str(tmp_path / "t.pdparams"))
    tpaddle.save(opt.state_dict(), str(tmp_path / "sub" / "t.pdopt"))
    jnet.set_state_dict(jpaddle.load(str(tmp_path / "t.pdparams")))
    np.testing.assert_allclose(jnet(jpaddle.to_tensor(x)).numpy(),
                               tnet(tpaddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    jopt = jpaddle.optimizer.Momentum(
        learning_rate=jlr.StepDecay(0.1, step_size=2), momentum=0.9,
        parameters=jnet.parameters())
    jopt.set_state_dict(jpaddle.load(str(tmp_path / "sub" / "t.pdopt")))
    assert jopt._step_count == 1 and jopt._learning_rate.last_epoch == 1
    state = tpaddle.load(str(tmp_path / "sub" / "t.pdopt"))
    opt2 = tpaddle.optimizer.Momentum(
        learning_rate=tlr.StepDecay(0.1, step_size=2), momentum=0.9,
        parameters=tnet.parameters())
    opt2.set_state_dict(state)
    assert opt2.state_dict().keys() == opt.state_dict().keys()
    assert opt2._learning_rate.last_epoch == 1
    arr = tpaddle.load(str(tmp_path / "t.pdparams"), return_numpy=True)
    assert isinstance(arr["fc.0.weight"], np.ndarray)
    # a bf16 tensor the reference saved loads as bf16
    jpaddle.save({"w": jpaddle.to_tensor(x, dtype="bfloat16")},
                 str(tmp_path / "b.pdparams"))
    w = tpaddle.load(str(tmp_path / "b.pdparams"))["w"]
    assert w.dtype == torch.bfloat16
    tpaddle.async_save({"w": tpaddle.to_tensor(x)},
                       str(tmp_path / "a.pdparams"))
    tpaddle.clear_async_save_task_queue()
    np.testing.assert_array_equal(
        jpaddle.load(str(tmp_path / "a.pdparams"))["w"].numpy(), x)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
