"""The port's GPT and BERT models (paddle_tpu_torch.models.gpt / .bert)
and their training through jit.TrainStep, against the JAX package on the
CPU, with ``set_device("cpu")``; the JAX side's Pallas flash kernels in
interpret mode (PT_PALLAS_INTERPRET=1, restored after), its other Pallas
paths off (tests/conftest.py). The JAX model is built from a seed and its
parameters ({structured name: numpy}) go into the port's model through
``utils.load_params_from_paddle_tpu``. Tokens come from numpy seeds.
Sizes: the ``debug`` presets (2 layers, hidden 64, 2 heads of 32: the dense
attention on both sides) and the same at hidden 128 (2 heads of 64: at
S = 128 the flash kernels' shape, the JAX side's Pallas kernel in interpret
mode against the port's plain version).

Tolerances, f32: the loss within 1e-5 relative; the logits within 1e-5 of
their largest magnitude; every gradient within 1e-4 of its leaf's largest
magnitude plus 1e-6 of the largest gradient of the model (the k
projections' biases have a gradient of zero, softmax ignoring a shift
shared by every key, so both sides hold round-off there). Three TrainStep
AdamW steps (lr 1e-3) against the JAX package's fused TrainStep: the losses
within 1e-5 relative; each leaf's update (after minus before) within 1e-3
relative L2 (readings of this comparison, seeds 0-3, hidden 64 and 128: up
to 3.5e-4), and each element within 1e-4 of its leaf's largest magnitude
plus half the learning rate (AdamW moves each element by about lr times
the sign of its gradient, so a gradient near its round-off moves by a part
of lr on either side: readings up to 0.18 lr). Two kinds of leaf are held
apart:
the k biases (zero gradient: AdamW turns the round-off into steps of up to
lr, so each side stays within 3 lr of the start, and the gradient is at
round-off, below 1e-6 of the largest), and the leaves the loss does not
reach (BERT's pooler and NSP head under an MLM loss): the port's eager
step, as the reference's ``_eager_step``, leaves them as they were (no
gradient, no update), the JAX package's fused step decays them (a zero
gradient, AdamW's decoupled decay): p (1 - lr wd)^3 within 1e-6 relative.

Tolerances under amp.decorate O2 bf16 (bf16 parameters except the
LayerNorms, bf16 activations, f32 loss), from readings of this comparison
on this machine (seeds 0-3 of the model and the tokens, hidden 64 and 128,
GPT and BERT with the MLM loss of bench.py::bench_bert): the loss gap 3e-6 to 2.3e-4 relative, the worst leaf's max
|gradient gap| 1.6e-2 to 5.3e-2 of the leaf's largest magnitude and its
relative L2 gap 1.3e-2 to 3.3e-2, the TrainStep losses 3e-5 to 1.8e-4
relative, the worst leaf's update (after minus before, 3 steps) 9.2e-2 to
0.23 relative L2 (bf16 rounding of each step's new value). Held: the loss
within 5e-4, each gradient within 8e-2 of its leaf's largest magnitude and
5e-2 relative L2, the TrainStep losses within 5e-4 and each update within
0.35 relative L2; and the dtypes: every parameter's as the JAX model's,
bf16 logits, f32 loss, gradients of their parameters' dtypes.
Dropout draws from the port's generators, not jax.random: a model with
dropout 0.1 is held by its repetition under ``paddle.seed`` and by its eval
mode equal to the model without dropout.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as JB
from paddle_tpu.models import gpt as JG

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.utils import load_params_from_paddle_tpu

LR, WD = 1e-3, 0.01          # AdamW's learning rate; its default decay
KINDS = {"gpt": (JG, TG, "GPTForCausalLM", "GPT_PRESETS", "GPTConfig"),
         "bert": (JB, TB, "BertForPretraining", "BERT_PRESETS",
                  "BertConfig"),
         "bert-cls": (JB, TB, "BertForSequenceClassification",
                      "BERT_PRESETS", "BertConfig")}


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


def _pair(kind, seed=0, **overrides):
    """The JAX model from ``seed`` and the port's model over its
    parameters."""
    jmod, tmod, cls, presets, config = KINDS[kind]
    base = dict(vars(getattr(jmod, presets)["debug"]), **overrides)
    jpaddle.seed(seed)
    jm = getattr(jmod, cls)(getattr(jmod, config)(**base))
    tm = getattr(tmod, cls)(getattr(tmod, config)(**base))
    names = [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == names
    load_params_from_paddle_tpu(tm, {n: np.asarray(p.numpy())
                                     for n, p in jm.named_parameters()})
    return jm, tm


def _tokens(b, s, seed, vocab=256):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s))
    return ids.astype(np.int64), np.roll(ids, -1, axis=1).astype(np.int64)


def _mlm_labels(labels, seed):
    """MLM labels with a share of positions ignored (-100)."""
    lab = labels.copy()
    lab[np.random.RandomState(seed).rand(*lab.shape) < 0.3] = -100
    return lab


def _loss(kind, lib, model, ids, labels):
    t = lib.to_tensor
    if kind == "gpt":
        return model(t(ids), t(labels))
    if kind == "bert":
        return model(t(ids), mlm_labels=t(labels),
                     nsp_labels=t(labels[:, :1] % 2))
    if kind == "bert-mlm":                      # bench.py::bench_bert's loss
        return model(t(ids), mlm_labels=t(labels))
    return model(t(ids), labels=t(labels[:, 0] % 2))


def _loss_and_grads(kind, lib, model, ids, labels):
    loss = _loss(kind, lib, model, ids, labels)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy(), np.float32)
             for n, p in model.named_parameters() if p.grad is not None}
    if lib is tpaddle:
        assert all(p.grad.dtype == p.dtype for p in model.parameters()
                   if p.grad is not None)
    model.clear_gradients()
    return float(loss.numpy()), loss.dtype, grads


def _hold_grads_f32(got, ref):
    assert set(got) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for name, g in ref.items():
        assert float(np.abs(got[name] - g).max()) <= \
            1e-4 * float(np.abs(g).max()) + 1e-6 * top, name


def test_parameter_names_match_jax_and_the_encoder_copies_are_own():
    for kind in KINDS:
        jm, tm = _pair(kind)
        for (n, jp), tp in zip(jm.named_parameters(), tm.parameters()):
            assert tp.shape == list(jp.shape), n
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    _, tm = _pair("bert")
    names = [n for n, _ in tm.named_parameters()]
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in names
    p = dict(tm.named_parameters())
    assert p["bert.encoder.layers.0.linear1.weight"]._value.data_ptr() != \
        p["bert.encoder.layers.1.linear1.weight"]._value.data_ptr()


CASES = [("gpt", 64, 128), ("gpt", 128, 128), ("gpt", 128, 32),
         ("bert", 64, 128), ("bert", 128, 128), ("bert", 128, 32),
         ("bert-cls", 128, 128)]


@pytest.mark.parametrize("kind,hidden,seq", CASES)
def test_loss_and_every_gradient_match_jax_f32(kind, hidden, seq):
    jm, tm = _pair(kind, hidden_size=hidden)
    ids, labels = _tokens(2, seq, seed=seq + hidden)
    if kind == "bert":
        labels = _mlm_labels(labels, seed=1)
    lj, _, gj = _loss_and_grads(kind, jpaddle, jm, ids, labels)
    reset_launch_counts()
    lt, dt, gt = _loss_and_grads(kind, tpaddle, tm, ids, labels)
    assert launch_counts()["flash_attention_fwd"] == 0     # the CPU path
    assert dt == torch.float32
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _hold_grads_f32(gt, gj)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_logits_match_jax_f32_in_eval(kind):
    jm, tm = _pair(kind, hidden_size=128)
    ids, _ = _tokens(2, 128, seed=3)
    jm.eval(), tm.eval()
    with jpaddle.no_grad():
        jo = jm(jpaddle.to_tensor(ids))
    with tpaddle.no_grad():
        to = tm(tpaddle.to_tensor(ids))
    jo = jo if isinstance(jo, tuple) else (jo,)
    to = to if isinstance(to, tuple) else (to,)
    for a, b in zip(to, jo):
        a, b = a.numpy(), np.asarray(b.numpy())
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())


@pytest.mark.parametrize("mask_dtype", ["bool", "float32"])
def test_bert_model_with_a_key_padding_mask_matches_jax(mask_dtype):
    """BertModel(input_ids, attention_mask=[B, 1, 1, S]): the kernels'
    key-padding bias at S = 128 (the JAX side's Pallas kernel in interpret
    mode), the sequence output and the pooled output."""
    jm, tm = _pair("bert", hidden_size=128)
    ids, _ = _tokens(2, 128, seed=8)
    keep = np.ones((2, 1, 1, 128), bool)
    keep[0, ..., 90:] = False
    mask = keep if mask_dtype == "bool" else \
        np.where(keep, 0.0, -1e4).astype(np.float32)
    outs = {}
    for m, lib in ((jm.bert, jpaddle), (tm.bert, tpaddle)):
        seq, pooled = m(lib.to_tensor(ids), attention_mask=lib.to_tensor(mask))
        (seq.sum() + pooled.sum()).backward()
        outs[lib] = (seq.numpy(), pooled.numpy(),
                     {n: p.grad.numpy() for n, p in m.named_parameters()
                      if p.grad is not None})
    for a, b in zip(outs[tpaddle][:2], outs[jpaddle][:2]):
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())
    _hold_grads_f32(outs[tpaddle][2], outs[jpaddle][2])


def _mlm_loss(nn, vocab):
    """The MLM loss over the first output (bench.py::bench_bert's), a Layer
    of either package."""
    class MLMLoss(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = nn.CrossEntropyLoss()

        def forward(self, outs, labels):
            logits = outs[0] if isinstance(outs, (tuple, list)) else outs
            return self.ce(logits.reshape([-1, vocab]), labels.reshape([-1]))
    return MLMLoss()


def _train(kind, lib, model, ids, labels, steps=3):
    nn, TS = (jnn, JTrainStep) if lib is jpaddle else (tnn, TrainStep)
    opt = lib.optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=LR)
    loss_fn = None if kind == "gpt" else _mlm_loss(nn, 256)
    step = TS(model, loss_fn, opt)
    losses = [float(step(lib.to_tensor(ids), lib.to_tensor(labels)).numpy())
              for _ in range(steps)]
    return losses, {n: np.asarray(p.numpy(), np.float32)
                    for n, p in model.named_parameters()}


UNREACHED = ("bert.pooler.", "nsp_head.")     # under an MLM loss


@pytest.mark.parametrize("kind,hidden", [("gpt", 64), ("gpt", 128),
                                         ("bert", 64), ("bert", 128)])
def test_three_train_steps_match_jax_f32(kind, hidden):
    jm, tm = _pair(kind, hidden_size=hidden)
    ids, labels = _tokens(2, 128, seed=21)
    start = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    kbias_grads = []
    for lib, m in ((jpaddle, jm), (tpaddle, tm)):
        g = _loss_and_grads(kind, lib, m, ids, labels)[2] if kind == "gpt" \
            else _mlm_grads(lib, m, ids, labels)
        top = max(float(np.abs(v).max()) for v in g.values())
        kbias_grads.append(max(float(np.abs(v).max()) / top
                               for n, v in g.items() if "k_proj.bias" in n))
    assert max(kbias_grads) <= 1e-6
    lj, pj = _train(kind, jpaddle, jm, ids, labels)
    lt, pt = _train(kind, tpaddle, tm, ids, labels)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert lt[-1] < lt[0]
    for n, p in pj.items():
        if "k_proj.bias" in n:
            for side in (p, pt[n]):
                assert float(np.abs(side - start[n]).max()) <= 3 * LR * 1.01
        elif n.startswith(UNREACHED) and kind == "bert":
            np.testing.assert_array_equal(pt[n], start[n])
            np.testing.assert_allclose(p, start[n] * (1 - LR * WD) ** 3,
                                       rtol=1e-6)
        else:
            assert float(np.abs(pt[n] - p).max()) <= \
                1e-4 * float(np.abs(p).max()) + 0.5 * LR, n
            ref = p - start[n]
            assert float(np.linalg.norm((pt[n] - start[n]) - ref)) <= \
                1e-3 * float(np.linalg.norm(ref)), n


def _mlm_grads(lib, model, ids, labels):
    outs = model(lib.to_tensor(ids))
    loss = _mlm_loss(jnn if lib is jpaddle else tnn, 256)(
        outs, lib.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy(), np.float32)
             for n, p in model.named_parameters() if p.grad is not None}
    model.clear_gradients()
    return grads


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_amp_o2_loss_gradients_and_train_steps_match_jax(kind):
    jm, tm = _pair(kind, hidden_size=128)
    jm = jpaddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = tpaddle.amp.decorate(tm, level="O2", dtype="bfloat16")
    jd = {n: str(np.dtype(p.dtype)) for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).replace("torch.", "")
          for n, p in tm.named_parameters()}
    assert td == jd
    assert {v for n, v in td.items() if "norm" in n or "ln_" in n} == \
        {"float32"}
    assert "bfloat16" in td.values()
    ids, labels = _tokens(2, 128, seed=10)
    tm.eval()
    with tpaddle.no_grad():
        out = tm(tpaddle.to_tensor(ids))
    tm.train()
    assert (out[0] if isinstance(out, tuple) else out).dtype == \
        torch.bfloat16
    if kind == "bert":
        labels = _mlm_labels(labels, seed=2)
    objective = "bert-mlm" if kind == "bert" else kind
    lj, _, gj = _loss_and_grads(objective, jpaddle, jm, ids, labels)
    lt, dt, gt = _loss_and_grads(objective, tpaddle, tm, ids, labels)
    assert dt == torch.float32
    assert abs(lt - lj) <= 5e-4 * abs(lj)
    assert set(gt) == set(gj)
    for n, g in gj.items():
        if "k_proj.bias" in n:
            continue                     # zero gradient: round-off only
        assert float(np.abs(gt[n] - g).max()) <= \
            8e-2 * float(np.abs(g).max()), n
        assert float(np.linalg.norm(gt[n] - g)) <= \
            5e-2 * float(np.linalg.norm(g)), n
    start = {n: np.asarray(p.numpy(), np.float32)
             for n, p in jm.named_parameters()}
    lj, pj = _train(kind, jpaddle, jm, ids, labels)
    lt, pt = _train(kind, tpaddle, tm, ids, labels)
    np.testing.assert_allclose(lt, lj, rtol=5e-4)
    for n, p in pj.items():
        if "k_proj.bias" in n or n.startswith(UNREACHED):
            continue
        ref = p - start[n]
        assert float(np.linalg.norm((pt[n] - start[n]) - ref)) <= \
            0.35 * float(np.linalg.norm(ref)), n


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_dropout_repeats_under_seed_and_eval_equals_no_dropout(kind):
    jm, tm = _pair(kind, hidden_size=128, dropout=0.1)
    _, plain = _pair(kind, hidden_size=128)
    ids, labels = _tokens(2, 128, seed=4)
    losses = []
    for seed in (5, 5, 6):
        tpaddle.seed(seed)
        losses.append(float(_loss(kind, tpaddle, tm, ids, labels)))
    assert losses[0] == losses[1] != losses[2]
    tm.eval()
    with tpaddle.no_grad():
        a = _loss(kind, tpaddle, tm, ids, labels)
        b = _loss(kind, tpaddle, plain, ids, labels)
    assert float(a) == float(b) != losses[0]
