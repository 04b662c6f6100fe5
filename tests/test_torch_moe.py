"""The port's MoE (incubate.distributed.models.moe), the MoE ops of the op
registry and fused_ec_moe / FusedEcMoe, against the JAX package on the CPU,
in one process, with ``set_device("cpu")``; inputs from numpy seeds (the
routing's from tests/test_moe_ep.py:16-54).

Tolerances: the routing is discrete, so slots, capacities and drops are
equal exactly; f32 functions of the same inputs (probabilities, gates,
buffers, outputs, aux losses) within 1e-5 relative and 1e-6 absolute (sums
in other orders); ``moe_block_stacked``'s loss and every gradient against
``jax.grad`` of the reference within rtol 1e-5 and 1e-6 of the gradient's
largest magnitude; the eager layers' outputs and parameter gradients within
1e-5 relative and absolute. ``random_routing`` draws from a torch.Generator
(jax.random cannot be matched bit for bit): its rule is held with the
reference's draw supplied, and its draws by their repetition under a seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.incubate.distributed.models import moe as JM
from paddle_tpu.incubate.nn import FusedEcMoe as JFusedEcMoe
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.incubate.distributed.models import moe as TM
from paddle_tpu_torch.incubate.nn import FusedEcMoe as TFusedEcMoe
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import registry

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    device = tpaddle.get_device()
    threads = torch.get_num_threads()
    tpaddle.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tpaddle.set_device(device)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(rng, d, f, e):
    return {"wg": (rng.randn(d, e) * 0.1).astype(np.float32),
            "w1": (rng.randn(e, d, f) * 0.05).astype(np.float32),
            "w2": (rng.randn(e, f, d) * 0.05).astype(np.float32)}


@pytest.mark.parametrize("k,cf", [(2, 1.25), (1, 1.0), (2, 0.5)])
def test_gating_sort_dispatch_and_combine_match_reference(k, cf):
    rng = np.random.RandomState(0)
    s, e = 64, 8
    logits = rng.randn(s, e).astype(np.float32)
    x = rng.randn(s, 4).astype(np.float32)
    dj, cj, auxj = JM.top2_gating(jnp.asarray(logits), cf, k)
    dt, ct, auxt = TM.top2_gating(_t(logits), cf, k)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    slot_j, gate_j, cap_j, aux_sj = JM.topk_sort_dispatch(
        jnp.asarray(logits), cf, k)
    slot_t, gate_t, cap_t, aux_st = TM.topk_sort_dispatch(_t(logits), cf, k)
    assert cap_t == cap_j
    assert slot_t.dtype == torch.int32
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    assert (slot_t < 0).any() or cf > 1       # drops at the tight capacity
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), **TOL)
    np.testing.assert_allclose(float(aux_st), float(aux_sj), **TOL)
    buf_j = JM.dispatch_to_experts(jnp.asarray(x), slot_j, e, cap_j)
    buf_t = TM.dispatch_to_experts(_t(x), slot_t, e, cap_t)
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    eo = rng.randn(e, cap_j, 4).astype(np.float32)
    np.testing.assert_allclose(
        TM.combine_from_experts(_t(eo), slot_t, gate_t).numpy(),
        np.asarray(JM.combine_from_experts(jnp.asarray(eo), slot_j, gate_j)),
        **TOL)


def test_capacity_drops_and_ties_follow_the_reference():
    # every token picks expert 0: over capacity the later ones drop
    s = 8
    logits = np.stack([np.full(s, 5.0), np.full(s, -5.0)], 1) \
        .astype(np.float32)
    slot, gate, cap, _ = TM.topk_sort_dispatch(_t(logits), 0.5, 1)
    assert cap == 2
    assert (slot[:, 0] >= 0).tolist() == [True, True] + [False] * 6
    assert torch.all(gate[2:, 0] == 0.0)
    # exact ties: lax.top_k and argmax take the lower expert index
    tied = np.zeros((16, 4), np.float32)
    tied[::2, 1] = tied[::2, 3] = 1.0
    for k in (1, 2, 3):
        sj, gj, _, _ = JM.topk_sort_dispatch(jnp.asarray(tied), 1.5, k)
        st, gt, _, _ = TM.topk_sort_dispatch(_t(tied), 1.5, k)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
        dj, _, _ = JM.top2_gating(jnp.asarray(tied), 1.5, k)
        dt, _, _ = TM.top2_gating(_t(tied), 1.5, k)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_moe_block_stacked_forward_and_gradients_match_jax_grad():
    rng = np.random.RandomState(0)
    d, f, e, s = 16, 32, 8, 64
    x = rng.randn(s, d).astype(np.float32)
    y = rng.randn(s, d).astype(np.float32)
    p = _params(rng, d, f, e)

    def jloss(params, xx):
        out, aux = JM.moe_block_stacked(params, xx)
        return jnp.mean((out - y) ** 2) + 0.01 * aux, (out, aux)

    (lj, (oj, aj)), (gj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_(True)
          for k, v in TM.moe_params_from_paddle_tpu(p).items()}
    tx = _t(x).requires_grad_(True)
    out, aux = TM.moe_block_stacked(tp, tx)
    loss = ((out - _t(y)) ** 2).mean() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aj), rtol=1e-5)
    for name, got, want in [("x", tx.grad, gxj)] + [
            (k, tp[k].grad, gj[k]) for k in ("wg", "w1", "w2")]:
        want = np.asarray(want)
        tol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol,
                                   err_msg=name)


def test_moe_params_slices_the_experts():
    p = _params(np.random.RandomState(1), 4, 6, 8)
    for rank in range(4):
        got = TM.moe_params_from_paddle_tpu(p, rank, 4)
        np.testing.assert_array_equal(got["wg"].numpy(), p["wg"])
        np.testing.assert_array_equal(got["w1"].numpy(),
                                      p["w1"][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["w2"].numpy(),
                                      p["w2"][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="8 experts"):
        TM.moe_params_from_paddle_tpu(p, 0, 3)


def test_moe_layer_and_aux_loss_match_reference_eager_layer():
    jpaddle.seed(3)
    jl = JM.MoELayer(8, num_experts=4, top_k=2, capacity_factor=1.0)
    tl = TM.MoELayer(8, num_experts=4, top_k=2, capacity_factor=1.0)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(tl.state_dict())
    missing, unexpected = tl.set_state_dict(state)
    assert missing == [] and unexpected == []
    x = np.random.RandomState(5).randn(2, 8, 8).astype(np.float32)
    jx = jpaddle.to_tensor(x, stop_gradient=False)
    tx = tpaddle.to_tensor(x, stop_gradient=False)
    jo, to = jl(jx), tl(tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()), **TOL)
    np.testing.assert_allclose(float(tl.aux_loss.numpy()),
                               float(jl.aux_loss.numpy()), **TOL)
    (jo.sum() + jl.aux_loss).backward()
    (to.sum() + tl.aux_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-5)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    # the default experts' GELU is the exact form, moe_block_stacked's the
    # tanh one: the layer's expert is nn.GELU()
    assert type(tl.experts[0][1]).__name__ == "GELU"
    with pytest.raises(ValueError, match="num_experts"):
        TM.MoELayer(8)


def _ops(name):
    return registry.get(name).fn, jregistry.get(name).fn


def test_registry_moe_helper_ops_match_reference():
    rng = np.random.RandomState(2)
    numbers = rng.randint(-1, 9, (5, 6)).astype(np.int64)
    t, j = _ops("number_count")
    np.testing.assert_array_equal(t(_t(numbers), 8).numpy(),
                                  np.asarray(j(numbers, 8)))
    ids = rng.randint(0, 4, 24).astype(np.int64)
    cum = np.cumsum(np.bincount(ids, minlength=4))
    t, j = _ops("assign_pos")
    np.testing.assert_array_equal(t(_t(ids), _t(cum), 20).numpy(),
                                  np.asarray(j(ids, cum, 20)))
    counts = rng.randint(0, 10, (2 * 4,)).astype(np.int64)
    cap = np.array([3, 5, 0, 9], np.int64)
    t, j = _ops("limit_by_capacity")
    np.testing.assert_array_equal(t(_t(counts), _t(cap), 2).numpy(),
                                  np.asarray(j(counts, cap, 2)))
    gate_idx = rng.randint(-1, 8, (30,)).astype(np.int64)
    limit = rng.randint(0, 5, (8,)).astype(np.int64)
    t, j = _ops("prune_gate_by_capacity")
    np.testing.assert_array_equal(t(_t(gate_idx), _t(limit), 4, 2).numpy(),
                                  np.asarray(j(gate_idx, limit, 4, 2)))
    # random_routing: the reference's rule on the reference's own draw
    prob = rng.rand(12, 2).astype(np.float32)
    idx = rng.randint(0, 8, (12, 2)).astype(np.int64)
    t, j = _ops("random_routing")
    draw = np.asarray(jax.random.uniform(jax.random.key(7), prob.shape))
    np.testing.assert_array_equal(
        t(_t(prob), None, _t(idx), seed=7, draw=_t(draw)).numpy(),
        np.asarray(j(prob, None, idx, seed=7)))
    a = t(_t(prob), None, _t(idx), seed=7)
    np.testing.assert_array_equal(a.numpy(),
                                  t(_t(prob), None, _t(idx), seed=7).numpy())
    kept = a.numpy() >= 0
    assert 0 < kept.sum() < kept.size
    np.testing.assert_array_equal(a.numpy()[kept], idx.reshape(-1)[kept])


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_registry_moe_op_and_fused_ec_moe_match_reference(act):
    rng = np.random.RandomState(4)
    b, s, h, i, e = 2, 5, 8, 12, 3
    x = rng.randn(b, s, h).astype(np.float32)
    gate = rng.randn(b, s, e).astype(np.float32)
    w0 = (rng.randn(e, h, i) * 0.3).astype(np.float32)
    w1 = (rng.randn(e, i, h) * 0.3).astype(np.float32)
    b0 = (rng.randn(e, 1, i) * 0.1).astype(np.float32)
    b1 = (rng.randn(e, 1, h) * 0.1).astype(np.float32)
    t, j = _ops("moe")
    tx = _t(x).requires_grad_(True)
    got = t(tx, _t(gate), _t(w0), _t(w1), act_type=act)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(j(x, gate, w0, w1, act_type=act)),
                               **TOL)
    got.sum().backward()
    want = jax.grad(lambda xx: j(xx, gate, w0, w1, act_type=act).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)
    args = (x, gate, w0, b0, w1, b1)
    got = TIF.fused_ec_moe(*(tpaddle.to_tensor(a) for a in args), act)
    ref = JIF.fused_ec_moe(*(jpaddle.to_tensor(a) for a in args), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), **TOL)
    jpaddle.seed(6)
    jlayer = JFusedEcMoe(h, i, e, act_type=act)
    tlayer = TFusedEcMoe(h, i, e, act_type=act)
    state = {k: np.asarray(v.numpy()) for k, v in
             jlayer.state_dict().items()}
    assert tlayer.set_state_dict(state) == ([], [])
    tin = tpaddle.to_tensor(x, stop_gradient=False)
    jin = jpaddle.to_tensor(x, stop_gradient=False)
    to = tlayer(tin, tpaddle.to_tensor(gate))
    jo = jlayer(jin, jpaddle.to_tensor(gate))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()), **TOL)
    to.sum().backward()
    jo.sum().backward()
    np.testing.assert_allclose(tin.grad.numpy(), np.asarray(jin.grad.numpy()),
                               **TOL)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in
          jlayer.named_parameters()}
    for n, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="gelu or relu"):
        TIF.fused_ec_moe(*(tpaddle.to_tensor(a) for a in args), "silu")
