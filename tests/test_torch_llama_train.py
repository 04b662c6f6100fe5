"""The port's training path (paddle_tpu_torch.models.llama and
distributed.fleet.HybridTrainer) against the JAX package on the CPU, where
the port's flash-attention and RMSNorm wrappers take their plain versions
and the JAX package runs its Pallas flash-attention kernels in interpret
mode (PT_PALLAS_INTERPRET=1 per test, restored afterwards). The same
weights (the JAX package's init, carried over as numpy) and tokens (numpy
seeds) go through both.

Tolerances: in f32 the loss within 1e-5 relative and every gradient leaf
within 1e-4 of its largest magnitude (the same f32 arithmetic, with sums
in another order: online softmax in the Pallas kernels against the dense
plain versions, XLA's dots against PyTorch's); in bf16 the loss within
2e-2 relative and each gradient leaf within 1e-1 of its largest magnitude
(the two frameworks round bf16 intermediates at other places). Trainer:
losses within 1e-5 relative, moments after three steps within 1e-4 of
their largest magnitude, parameters within that plus a tenth of the
learning rate: AdamW moves each element by about lr * m / sqrt(v), and
where a gradient is within its round-off of eps, the two frameworks'
round-off moves that step by a part of lr (6% at most in this test).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.fleet.trainer import HybridTrainer as JTrainer
from paddle_tpu.models import llama as JL

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.distributed.fleet import HybridTrainer
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu


@pytest.fixture(autouse=True)
def _interpret_mode():
    # the JAX side's Pallas kernels in interpret mode, restored after;
    # and one PyTorch thread while the test runs, restored after: in a fresh
    # process with two or more threads, the first float exp after MKL's
    # first GEMM sometimes computes one thread's share with a low-accuracy
    # exp (relative error up to 1.5e-4), which moves the plain versions'
    # softmax and LSE past the tolerance; see test_torch_varlen_attention.py
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


def _config(**kw):
    base = dict(vars(JL.LLAMA_PRESETS["debug"]))
    base.update(kw)
    return JL.LlamaConfig(**base), TL.LlamaConfig(**base)


def _batch(vocab, b=2, s=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_loss_and_grads(jcfg, params, ids, labels, remat):
    loss, grads = jax.value_and_grad(JL.loss_fn_stacked)(
        params, (jnp.asarray(ids), jnp.asarray(labels)), jcfg, remat)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in TL.leaves(grads).items()}


def _port_loss_and_grads(tcfg, np_params, ids, labels, remat):
    params = stacked_params_from_paddle_tpu(np_params)
    leaves = TL.leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = TL.loss_fn_stacked(params, (torch.tensor(ids).long(),
                                       torch.tensor(labels).long()),
                              tcfg, remat=remat)
    loss.backward()
    return float(loss.detach()), {k: t.grad.float().numpy()
                         for k, t in leaves.items()}


def _compare(jcfg, tcfg, remat, loss_rtol, grad_tol, seed=0):
    params = JL.init_stacked_params(jcfg, jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, params)
    ids, labels = _batch(jcfg.vocab_size, seed=seed)
    lj, gj = _jax_loss_and_grads(jcfg, params, ids, labels, remat)
    lt, gt = _port_loss_and_grads(tcfg, np_params, ids, labels, remat)
    assert np.isfinite(lt)
    np.testing.assert_allclose(lt, lj, rtol=loss_rtol)
    assert sorted(gj) == sorted(gt) and len(gt) == 12
    for name in gj:
        scale = float(np.abs(gj[name]).max())
        assert scale > 0, name
        err = float(np.abs(gt[name] - gj[name]).max())
        assert err <= grad_tol * scale, (name, err, scale)


@pytest.mark.parametrize("remat,policy", [(True, "full"), (False, "full"),
                                          (True, "save_attn")])
def test_loss_and_every_gradient_match_jax_f32(remat, policy):
    jcfg, tcfg = _config(remat_policy=policy)
    _compare(jcfg, tcfg, remat, 1e-5, 1e-4)


def test_save_attn_layer_keeps_attention_output_not_qkv():
    """remat_policy="save_attn" keeps, as the reference's
    save_only_these_names("flash_attn_out") does, each layer's attention
    output (O, with its LSE for the flash backward), and recomputes q, k
    and v in the backward: beside the layer's input and weights, the
    tensors a layer saves for its backward lie in exactly two storages,
    O's (the [B, H, S, D] tensor equal to O, and the [B, S, H, D] view of
    it that the checkpointed rest of the block takes) and the f32
    [B, H, S] LSE's. Its gradients are the full-recompute layer's."""
    _, tcfg = _config(remat_policy="save_attn")
    params = TL.init_stacked_params(tcfg, seed=3, device="cpu")
    layer = {key: params["blocks"][key][0].detach().requires_grad_(True)
             for key in TL._BLOCK_KEYS}
    b, s, h = 2, 128, tcfg.hidden_size
    nh, hd = tcfg.num_attention_heads, tcfg.head_dim
    x = torch.randn(b, s, h, generator=torch.Generator().manual_seed(4)) \
        .requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = TL._block_save_attn(layer, x, tcfg)
    q, k, v = (t.transpose(1, 2) for t in TL._qkv(layer, x, tcfg))
    o, lse = TL.fa.forward_with_lse(q, k, v, None, 0, True, 0.0)
    inputs = {t.untyped_storage().data_ptr()
              for t in [x] + list(layer.values())}
    kept = [t for t in saved
            if t.untyped_storage().data_ptr() not in inputs]
    heads = [t for t in kept if tuple(t.shape) == (b, nh, s, hd)]
    assert len(heads) == 1 and torch.equal(heads[0], o)
    storages = {t.untyped_storage().data_ptr() for t in kept}
    assert len(storages) == 2, [tuple(t.shape) for t in kept]
    assert not any(torch.equal(heads[0], t) for t in (q, k, v))
    lses = [t for t in kept if tuple(t.shape) == (b, nh, s)]
    assert len(lses) == 1 and lses[0].dtype == torch.float32
    assert torch.equal(lses[0], lse)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    leaves = [x] + list(layer.values())
    got = torch.autograd.grad(y, leaves, cot)
    ref = torch.autograd.grad(TL._block(layer, x, tcfg), leaves, cot)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)


def test_gqa_loss_and_gradients_match_jax():
    jcfg, tcfg = _config(num_attention_heads=2, num_key_value_heads=1)
    _compare(jcfg, tcfg, True, 1e-5, 1e-4, seed=1)


def test_bf16_loss_and_gradients_match_jax():
    jcfg, tcfg = _config(dtype="bfloat16")
    _compare(jcfg, tcfg, True, 2e-2, 1e-1, seed=2)


def test_cpu_path_launches_no_kernel_and_sep_mesh_raises():
    jcfg, tcfg = _config()
    params = TL.init_stacked_params(tcfg, seed=0, device="cpu")
    ids, labels = _batch(tcfg.vocab_size, s=128)
    reset_launch_counts()
    with torch.no_grad():
        logits = TL.forward_stacked(params, torch.tensor(ids).long(), tcfg)
    assert logits.shape == (2, 128, tcfg.vocab_size)
    assert logits.dtype == torch.float32
    assert all(n == 0 for n in launch_counts().values())
    # a sep mesh splits the sequence over the ranks of a hybrid group: it
    # raises without one
    with pytest.raises(ValueError, match="sep=2"):
        TL.loss_fn_stacked(params, (torch.tensor(ids).long(),
                                    torch.tensor(labels).long()), tcfg,
                           mesh={"dp": 1, "sep": 2})


def test_trainer_three_steps_match_jax_trainer():
    jcfg, tcfg = _config()
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
        ("dp", "pp", "sharding", "sep", "mp"))
    lr = 1e-3
    jt = JTrainer(jcfg, mesh, learning_rate=lr)
    tt = HybridTrainer(tcfg, learning_rate=lr, device="cpu")
    s0 = jt.elastic_state()
    tt.load_elastic_state(s0)
    for step in range(3):
        ids, labels = _batch(jcfg.vocab_size, seed=10 + step)
        lj = float(jt.step(ids, labels))
        lt = float(tt.step(ids, labels))
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    sj, st = jt.elastic_state(), tt.elastic_state()
    assert sorted(sj) == sorted(st) and int(st["step"]) == 3
    for key in sj:
        if key == "step":
            continue
        a = np.asarray(sj[key], np.float32)
        tol = 1e-4 * float(np.abs(a).max()) + (0.1 * lr if key[0] == "p"
                                               else 0.0)
        assert float(np.abs(st[key] - a).max()) <= tol, key
    # the steps moved the parameters by far more than that tolerance
    moved = max(float(np.abs(st[k] - s0[k]).max()) for k in s0 if k[0] == "p")
    assert moved >= 2 * lr


def test_trainer_rejects_a_mesh_of_many_devices():
    # a mesh larger than the initialized world (here one process) raises,
    # a pp axis and a sep axis too
    _, tcfg = _config()
    for mesh in ({"dp": 2, "mp": 1}, {"pp": 2}, {"sep": 2}):
        with pytest.raises(ValueError, match="world"):
            HybridTrainer(tcfg, mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA: the default device is valid")
        HybridTrainer(tcfg)
