"""The port's pipeline engines (1F1B, interleaved v = 2, ZB-H1) at pp 2 and
pp 4 over gloo ranks on the CPU, held to the JAX package's engines run in
this process on its 8-device CPU mesh.

The reference is single-controller: its engines run every stage in one
process. The port's ranks each build only their stage's layers
(paddle_tpu_torch.distributed.spawn of tests/torch_dist_workers.py::
pipeline_engines, which imports no JAX), load the reference's whole-model
state by global names, and send the activations and gradients between
them; the gradients gathered over the ranks are held to the reference's.
Both sides run the reference's test model (tests/test_pipeline_schedules.py
::_seq_model: 8 x (Linear 12 -> 12, Tanh), MSELoss), 4 micro-batches of
2 rows. One spawn a pp degree serves every test here (a module fixture).

Tolerances: the loss and every gradient within rtol 1e-5, atol 1e-6 (the
reference's own bound for its engines against each other); 3 train_batch
steps of SGD (lr 0.1) with and without a GradScaler (scale 1024), the
losses and the parameters after them within rtol 1e-5, atol 1e-6;
eval_batch within rtol 1e-5; 3 steps of SGD under fleet's
distributed_optimizer with a global-norm clip of 0.05 (active at every
step), the losses and parameters within rtol 1e-5, atol 1e-6.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel.pipeline_parallel import (
    PipelineParallel as JPP, PipelineParallelWithInterleave as JVPP,
    PipelineParallelZeroBubble as JZB)
from paddle_tpu.distributed.meta_parallel.pp_layers import (
    PipelineLayer as JPipe, SharedLayerDesc as JShared)

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist

RTOL, ATOL = 1e-5, 1e-6
ENGINES = {"1f1b": (JPP, {}), "vpp": (JVPP, {"num_virtual_pipeline_stages":
                                            2}),
           "zb": (JZB, {})}


def _seq_model(shared=False, seed=0):
    jpaddle.seed(seed)
    layers = []
    for i in range(8):
        if shared and i in (0, 7):
            layers.append(JShared("tie", jnn.Linear, None, "weight", 12, 12))
        else:
            layers.append(jnn.Linear(12, 12))
        layers.append(jnn.Tanh())
    return layers


def _jax_engine(pp, cls, kw, shared=False):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": pp,
                               "pp_configs": {"accumulate_steps": 4}}
    jfleet.init(is_collective=True, strategy=strategy)
    hcg = jfleet.get_hybrid_communicate_group()
    model = JPipe(_seq_model(shared), num_stages=pp, loss_fn=jnn.MSELoss())
    return model, cls(model, hcg, strategy=strategy, **kw)


def _data():
    rng = np.random.RandomState(7)
    return (rng.randn(8, 12).astype(np.float32),
            rng.randn(8, 12).astype(np.float32))


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _reference(pp):
    """The reference engines' numbers on the port's inputs."""
    x, y = _data()
    xt, yt = jpaddle.to_tensor(x), jpaddle.to_tensor(y)
    out = {}
    for name, (cls, kw) in ENGINES.items():
        model, eng = _jax_engine(pp, cls, kw)
        out["state"] = _state(model)
        loss = eng.forward_backward_pipeline((xt, yt))
        out[name] = {"loss": float(np.asarray(loss._value)),
                     "grads": {n: np.asarray(p.grad._value)
                               for n, p in model.named_parameters()
                               if p.grad is not None}}
        for use_scaler in (False, True):
            model, eng = _jax_engine(pp, cls, kw)
            opt = joptimizer.SGD(learning_rate=0.1,
                                 parameters=model.parameters())
            scaler = jamp.GradScaler(init_loss_scaling=1024.0) \
                if use_scaler else None
            out[name][f"train_{use_scaler}"] = [
                float(np.asarray(eng.train_batch(
                    (xt, yt), opt, scaler=scaler)._value))
                for _ in range(3)]
            out[name][f"params_{use_scaler}"] = _state(model)
        out[name]["eval"] = float(np.asarray(
            eng.eval_batch((xt, yt), compute_loss=True)._value))
    model, eng = _jax_engine(pp, JPP, {}, shared=True)
    out["shared_state"] = _state(model)
    out["shared_loss"] = float(np.asarray(
        eng.forward_backward_pipeline((xt, yt))._value))
    out["shared_grads"] = {n: np.asarray(p.grad._value)
                           for n, p in model.named_parameters()}
    model, eng = _jax_engine(pp, JPP, {}, shared=True)
    opt = joptimizer.SGD(learning_rate=0.1, parameters=model.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(0.05))
    out["clip_losses"] = [float(np.asarray(
        eng.train_batch((xt, yt), opt)._value)) for _ in range(3)]
    out["clip_params"] = _state(model)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def runs(request, tmp_path_factory):
    pp = request.param
    saved = jtopology.get_hybrid_communicate_group()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _reference(pp)
    finally:
        jtopology.set_hybrid_communicate_group(saved)
        torch.set_num_threads(threads)
    out = tmp_path_factory.mktemp(f"engines_pp{pp}")
    x, y = _data()
    dist.spawn(W.pipeline_engines, args=(str(out), ref["state"],
                                         ref["shared_state"], x, y),
               nprocs=pp, backend="gloo", timeout=240)
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(pp)]
    return pp, ref, ranks


def _gathered(ranks, engine, key="grads"):
    merged = {}
    for got in ranks:
        for name, g in got[engine][key].items():
            assert name not in merged, name        # each layer on one stage
            merged[name] = g
    return merged


@pytest.mark.parametrize("engine", list(ENGINES))
def test_loss_and_gathered_gradients_match_reference(runs, engine):
    pp, ref, ranks = runs
    for got in ranks:
        assert got["stage"] == ranks.index(got)
        # this stage's entries of the reference's whole-model state, and
        # the whole state itself, load with nothing missing or unexpected
        assert all(load == (([], []), ([], []), True)
                   for load in got["load"])
        np.testing.assert_allclose(got[engine]["loss"], ref[engine]["loss"],
                                   rtol=RTOL, atol=ATOL)
    grads = _gathered(ranks, engine)
    assert sorted(grads) == sorted(ref[engine]["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref[engine]["grads"][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_train_batch_with_and_without_grad_scaler(runs, engine):
    pp, ref, ranks = runs
    for use_scaler in (False, True):
        for got in ranks:
            np.testing.assert_allclose(got[engine][f"train_{use_scaler}"],
                                       ref[engine][f"train_{use_scaler}"],
                                       rtol=RTOL, atol=ATOL)
        params = _gathered(ranks, engine, f"params_{use_scaler}")
        want = ref[engine][f"params_{use_scaler}"]
        assert sorted(params) == sorted(want)
        for name, p in params.items():
            np.testing.assert_allclose(p, want[name], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    # the scaled run is the unscaled one
    np.testing.assert_allclose(ranks[0][engine]["train_True"],
                               ranks[0][engine]["train_False"], rtol=1e-5)
    for got in ranks:
        np.testing.assert_allclose(got[engine]["eval"], ref[engine]["eval"],
                                   rtol=RTOL)


def test_shared_layer_gradient_is_the_reference_shared_one(runs):
    pp, ref, ranks = runs
    first, last = ranks[0], ranks[-1]
    want = ref["shared_grads"]["layers_list.0.weight"]
    for got in (first, last):
        np.testing.assert_allclose(got["shared_loss"], ref["shared_loss"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["shared_grads"]["layers_list.0.weight"],
                                   want, rtol=RTOL, atol=ATOL)
    assert first["firstly_shared"]["layers_list.0.weight"] is True
    assert last["firstly_shared"]["layers_list.0.weight"] is False
    for got in ranks[1:-1]:
        assert "layers_list.0.weight" not in got["shared_grads"]


def test_global_norm_clip_counts_every_stage_and_the_tie_once(runs):
    # a clip of 0.05 scales every step (the norm is above 1): a norm of
    # one stage, or the tie counted twice, would move the parameters
    pp, ref, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["clip_losses"], ref["clip_losses"],
                                   rtol=RTOL, atol=ATOL)
        for name, p in got["clip_params"].items():
            np.testing.assert_allclose(p, ref["clip_params"][name],
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    held = set().union(*(got["clip_params"] for got in ranks))
    assert held == set(ref["clip_params"])


def test_zero_bubble_runs_b_and_w_as_separate_pullbacks(runs):
    pp, ref, ranks = runs
    for got in ranks:
        calls = got["zb_calls"]
        b = [c for c in calls if c == 1]
        w = [c for c in calls if c > 1]
        assert len(w) == 4
        # stage 0's input takes no gradient: its B has no pullback
        assert len(b) == (0 if got["stage"] == 0 else 4), calls


def test_forward_dispatch_and_point_to_point(runs):
    pp, ref, ranks = runs
    for got in ranks:
        assert "forward_stage" in got["forward_error"]
        assert got["dispatch"] == ["PipelineParallelZeroBubble",
                                   "PipelineParallelWithInterleave",
                                   "PipelineParallel",
                                   "PipelineParallelWithInterleave"]
    a0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    first, second = ranks[0]["p2p"], ranks[1]["p2p"]
    np.testing.assert_array_equal(second[0], a0)
    np.testing.assert_array_equal(second[1], a0 + 1)
    np.testing.assert_array_equal(first[0], a0 + 10)
    np.testing.assert_array_equal(first[1], a0 + 11)
