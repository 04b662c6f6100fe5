"""The port's eager Llama (paddle_tpu_torch.models.llama.LlamaForCausalLM,
its training loop and generate) against the JAX package's eager model on
the CPU, with ``set_device("cpu")``, where the port's RMSNorm and
flash-attention wrappers take their plain versions and the JAX package
runs its Pallas flash-attention kernels in interpret mode
(PT_PALLAS_INTERPRET=1, restored after). The JAX model is built from a
seed; its ``state_dict()`` goes into the port's model through
``utils.state_dict_from_paddle_tpu`` and ``set_state_dict``. Tokens come
from numpy seeds. S = 128 is a kernel shape (the JAX side runs its Pallas
kernels), S = 32 takes the dense fallback on both sides.

Tolerances: in f32 the loss within 1e-5 relative and every gradient within
1e-4 of its leaf's largest magnitude (the same f32 arithmetic, sums taken
in other orders: online softmax in the Pallas kernels against the dense
plain versions, XLA's dots against PyTorch's); the logits within 1e-4 of
their largest magnitude. Under AMP O1 bf16 each op of the step runs at
the reference's dtype (the same set of op names and output dtypes as the
JAX step, seen by each side's op observers), and the tolerances come from
readings (tests/torch_eager_amp_gaps.py, this machine, 6 seeds of the
debug preset at S = 128, against the JAX step under AMP O1 bf16): the
port's own step reads a loss gap of 1.6e-6 to 1.8e-4 relative, a worst
leaf's max |gap| of 1.43e-2 to 1.72e-2 of the leaf's largest magnitude
and a worst leaf's relative L2 gap of 1.55e-2 to 1.79e-2; the same step
in f32 (the control) reads 1.1e-5 to 3.0e-4, 1.89e-2 to 2.59e-2 and
2.00e-2 to 2.19e-2. So each gradient is held within 1.8e-2 of its leaf's
largest magnitude and 1.9e-2 relative L2, between the two, and the test
checks that the f32 step fails them; the loss, which does not tell the
two apart at this size, within 4e-4 relative (twice the port's largest).
After 3 AdamW steps the parameters within 1e-4 of their largest magnitude
plus a tenth of the learning rate: AdamW moves each element by about
lr * m / sqrt(v), and where a gradient is within its round-off of eps the
two frameworks' round-off moves that step by a part of lr. Greedy tokens
equal, token for token, in f32.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.models import llama as JL

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.utils import state_dict_from_paddle_tpu


@pytest.fixture(autouse=True)
def _cpu_port():
    # the JAX side's Pallas kernels in interpret mode, the port on the CPU
    # and on one PyTorch thread (the first float exp after MKL's first GEMM,
    # see test_torch_llama_train.py), all restored after
    old = os.environ.get("PT_PALLAS_INTERPRET")
    threads = torch.get_num_threads()
    device = tpaddle.get_device()
    os.environ["PT_PALLAS_INTERPRET"] = "1"
    torch.set_num_threads(1)
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(device)
    torch.set_num_threads(threads)
    if old is None:
        os.environ.pop("PT_PALLAS_INTERPRET", None)
    else:
        os.environ["PT_PALLAS_INTERPRET"] = old


def _pair(preset="debug", seed=0, **overrides):
    """The JAX model from ``seed`` and the port's model over its weights."""
    base = dict(vars(JL.LLAMA_PRESETS[preset]), **overrides)
    jpaddle.seed(seed)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(**base))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tpaddle.set_device("cpu")
    tm = TL.LlamaForCausalLM(TL.LlamaConfig(**base))
    missing, unexpected = tm.set_state_dict(state_dict_from_paddle_tpu(state))
    assert missing == [] and unexpected == []
    return jm, tm


def _tokens(vocab, b, s, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s))
    return ids.astype(np.int64), np.roll(ids, -1, axis=1).astype(np.int64)


def _loss_and_grads(model, lib, ids, labels, amp):
    i, l = lib.to_tensor(ids), lib.to_tensor(labels)
    if amp:
        with lib.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(i, labels=l)
    else:
        loss = model(i, labels=l)
    loss.backward()
    if lib is tpaddle:
        # each f32 parameter's gradient is f32 (the AMP casts' backward)
        assert all(p.grad.dtype == p.dtype for p in model.parameters())
    grads = {n: np.asarray(p.grad.numpy(), np.float32)
             for n, p in model.named_parameters()}
    model.clear_gradients()
    return float(loss.numpy()), grads


@pytest.fixture(scope="module")
def debug_pair():
    old = os.environ.get("PT_PALLAS_INTERPRET")
    os.environ["PT_PALLAS_INTERPRET"] = "1"
    device = tpaddle.get_device()
    try:
        yield _pair()
    finally:
        tpaddle.set_device(device)
        if old is None:
            os.environ.pop("PT_PALLAS_INTERPRET", None)
        else:
            os.environ["PT_PALLAS_INTERPRET"] = old


def test_parameter_names_and_state_dict_match_jax(debug_pair):
    jm, tm = debug_pair
    jnames = [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == jnames
    assert list(tm.state_dict()) == list(jm.state_dict()) == jnames
    for (n, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        assert tp.shape == jp.shape, n
        assert tp.dtype == torch.float32 and not tp.stop_gradient
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    # the round trip: the port's state_dict into a fresh port model
    tpaddle.seed(5)
    other = TL.LlamaForCausalLM(TL.LlamaConfig(**vars(
        JL.LLAMA_PRESETS["debug"])))
    assert other.set_state_dict(tm.state_dict()) == ([], [])
    for a, b in zip(other.parameters(), tm.parameters()):
        assert torch.equal(a._value, b._value)


@pytest.mark.parametrize("seq", [128, 32])
def test_loss_and_every_gradient_match_jax_f32(debug_pair, seq):
    jm, tm = debug_pair
    ids, labels = _tokens(256, 1 if seq == 128 else 2, seq, seed=seq)
    lj, gj = _loss_and_grads(jm, jpaddle, ids, labels, amp=False)
    reset_launch_counts()
    lt, gt = _loss_and_grads(tm, tpaddle, ids, labels, amp=False)
    assert launch_counts()["flash_attention_fwd"] == 0     # CPU path
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert set(gt) == set(gj) and len(gt) == 21
    for name, g in gj.items():
        scale = float(np.abs(g).max())
        assert scale > 0, name
        assert float(np.abs(gt[name] - g).max()) <= 1e-4 * scale, name


def test_logits_match_jax_f32_and_in_eval(debug_pair):
    jm, tm = debug_pair
    ids, _ = _tokens(256, 2, 32, seed=3)
    jm.eval(), tm.eval()
    try:
        with jpaddle.no_grad():
            lj = jm(jpaddle.to_tensor(ids)).numpy()
        with tpaddle.no_grad():
            out = tm(tpaddle.to_tensor(ids))
        assert out.shape == [2, 32, 256] and out.dtype == torch.float32
        assert out.stop_gradient
        lt = out.numpy()
    finally:
        jm.train(), tm.train()
    assert float(np.abs(lt - lj).max()) <= 1e-4 * float(np.abs(lj).max())


def _op_dtypes(dispatch, run):
    """The set of (op name, output dtypes) that ``run()`` reports to the
    op observers, the AMP casts and the recompute wrapper left out (the
    JAX package reports those as ops of their own), integers as "int"
    (the JAX package runs without x64)."""
    seen = set()

    def obs(name, leaves):
        if name not in ("cast", "recompute"):
            seen.add((name, tuple(
                "int" if "int" in str(t.dtype) else
                str(t.dtype).replace("torch.", "") for t in leaves)))
    dispatch.add_op_observer(obs)
    try:
        out = run()
    finally:
        dispatch.remove_op_observer(obs)
    return out, seen


def _amp_gaps(ref, got):
    """Worst leaf's max |gap| over its largest magnitude, and worst
    leaf's relative L2 gap."""
    worst = max(float(np.abs(got[n] - g).max()) / float(np.abs(g).max())
                for n, g in ref.items())
    l2 = max(float(np.linalg.norm(got[n] - g)) / float(np.linalg.norm(g))
             for n, g in ref.items())
    return worst, l2


def test_amp_o1_bf16_loss_and_gradients_match_jax(debug_pair):
    from paddle_tpu.core import dispatch as JD
    from paddle_tpu_torch.core import dispatch as TD

    jm, tm = debug_pair
    ids, labels = _tokens(256, 1, 128, seed=11)
    (lj, gj), jops = _op_dtypes(JD, lambda: _loss_and_grads(
        jm, jpaddle, ids, labels, amp=True))
    (lt, gt), tops = _op_dtypes(TD, lambda: _loss_and_grads(
        tm, tpaddle, ids, labels, amp=True))
    # linear and attention in bf16, rms_norm and the loss in f32, as JAX
    assert ("linear", ("bfloat16",)) in tops
    assert ("rms_norm", ("float32",)) in tops
    assert tops == jops
    np.testing.assert_allclose(lt, lj, rtol=4e-4)
    worst, l2 = _amp_gaps(gj, gt)
    assert worst <= 1.8e-2 and l2 <= 1.9e-2, (worst, l2)
    # the control: the port's step in f32 fails the same tolerances
    _, gf = _loss_and_grads(tm, tpaddle, ids, labels, amp=False)
    worst_f, l2_f = _amp_gaps(gj, gf)
    assert worst_f > 1.8e-2 and l2_f > 1.9e-2, (worst_f, l2_f)


def test_tiny_preset_bf16_embedding_cast_matches_jax():
    """The "tiny" preset (dtype bfloat16, 4 heads of 64): the embedding's
    output is cast to bf16 and the rest promotes to f32 (bf16 x f32 -> f32,
    as jnp.matmul promotes). The logits, in eval mode, within 1e-4 of their
    largest magnitude: the bf16 rounding of the embedding is the same on
    both sides, the trunk f32."""
    jm, tm = _pair("tiny", seed=2)
    ids, _ = _tokens(512, 1, 32, seed=4)
    jm.eval(), tm.eval()
    with jpaddle.no_grad():
        lj = jm(jpaddle.to_tensor(ids)).numpy()
    with tpaddle.no_grad():
        x = tm.model.embed_tokens(tpaddle.to_tensor(ids))
        out = tm(tpaddle.to_tensor(ids))
    assert x.dtype == torch.float32 and out.dtype == torch.float32
    assert float(np.abs(out.numpy() - lj).max()) <= \
        1e-4 * float(np.abs(lj).max())


def test_adamw_three_steps_match_jax():
    jm, tm = _pair(seed=1)
    lr = 1e-3
    jo = jpaddle.optimizer.AdamW(parameters=jm.parameters(), learning_rate=lr)
    to = tpaddle.optimizer.AdamW(parameters=tm.parameters(), learning_rate=lr)
    ids, labels = _tokens(256, 2, 32, seed=7)
    start = [p.numpy().copy() for p in tm.parameters()]
    for _ in range(3):
        losses = []
        for model, lib, opt in ((jm, jpaddle, jo), (tm, tpaddle, to)):
            loss = model(lib.to_tensor(ids), labels=lib.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1] < float(np.log(256))
    for (name, jp), tp, p0 in zip(jm.named_parameters(), tm.parameters(),
                                  start):
        a = np.asarray(jp.numpy(), np.float32)
        tol = 1e-4 * float(np.abs(a).max()) + 0.1 * lr
        assert float(np.abs(tp.numpy() - a).max()) <= tol, name
        # the steps moved every parameter by far more than that tolerance
        assert float(np.abs(tp.numpy() - p0).max()) > 10 * tol, name
    assert to.state_dict()["_step_count"] == 3


@pytest.mark.parametrize("prompt", [128, 24])
def test_greedy_generate_equals_jax_f32(debug_pair, prompt):
    jm, tm = debug_pair
    ids, _ = _tokens(256, 2, prompt, seed=prompt + 1)
    try:
        oj = jm.generate(jpaddle.to_tensor(ids), max_new_tokens=6).numpy()
        out = tm.generate(tpaddle.to_tensor(ids), max_new_tokens=6)
    finally:
        jm.train(), tm.train()
    assert out.shape == [2, prompt + 6] and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), oj)


def test_eager_loop_runs_with_the_port_alone():
    """The PaddlePaddle user's loop (tests/test_models_launch.py:14-38)
    on the port alone: the loss falls over 8 steps, generate returns the
    prompt and 4 tokens with ``shape`` a list."""
    tpaddle.seed(0)
    model = TL.LlamaForCausalLM(TL.LLAMA_PRESETS["debug"])
    opt = tpaddle.optimizer.AdamW(parameters=model.parameters(),
                                  learning_rate=1e-3)
    ids = tpaddle.to_tensor(np.random.RandomState(0).randint(0, 256, (2, 32)))
    labels = tpaddle.to_tensor(np.roll(ids.numpy(), -1, 1))
    first = None
    for _ in range(8):
        loss = model(ids, labels=labels)
        first = float(loss) if first is None else first
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert float(loss) < first
    out = model.generate(tpaddle.to_tensor(np.arange(8).reshape(1, 8)),
                         max_new_tokens=4)
    assert out.shape == [1, 12]
