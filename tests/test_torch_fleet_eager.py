"""Collective Fleet and the eager tensor-parallel surface of the port at 4
gloo ranks on the CPU: fleet.init with hybrid_configs, the tensor-parallel
layers (gathered) against their dense forms, ZeRO stage 1, DataParallel,
and the eager LlamaForCausalLM at mp 2 x dp 2 through distributed_model /
distributed_optimizer held to the JAX package's eager model run in this
process; the segment-parallel mode's wrapper; the parameter-server mode,
not ported, raises naming ROADMAP.md.

Ranks are spawned (paddle_tpu_torch.distributed.spawn) from rank
functions in tests/torch_dist_workers.py, which import only torch and the
port. Tolerances: the layers against numpy or dense torch on the same
numbers, 1e-5 relative and 1e-6 absolute (f32 sums split over ranks); the
stage-1 optimizer against AdamW in the same process over the mean of the
ranks' gradients, 1e-6 (the mean taken by the all-reduce, in another
order); the eager Llama as tests/test_torch_eager_llama.py holds the
one-process f32 model: the loss within 1e-5 relative, the parameters after
one step within 1e-4 of their largest magnitude plus a tenth of the
learning rate. The eager Llama is held with tied word embeddings too (the
vocab-sharded table as the head): the table's gradient, the lookup's and
the head's summed, within 1e-4 of its largest magnitude.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.models import llama as JL

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spawn(fn, tmp_path, *args):
    dist.spawn(fn, args=(str(tmp_path),) + args, nprocs=4, backend="gloo",
               timeout=180)
    return [pickle.loads(p.read_bytes()) if p.exists() else None
            for p in (tmp_path / f"rank{r}.pkl" for r in range(4))]


def test_fleet_init_and_tp_layers_sharded_parity(tmp_path):
    res = _spawn(W.fleet_tp_layers, tmp_path)
    for r, got in enumerate(res):
        info = got["info"]
        assert info["mode"] == "tensor_parallel"
        assert info["degrees"] == {"dp": 2, "pp": 1, "sharding": 1,
                                   "sep": 1, "mp": 2}
        assert (info["dp_rank"], info["mp_rank"]) == divmod(r, 2)
        assert info["mp_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert info["dp_ranks"] == [r % 2, r % 2 + 2]
        assert info["worker"] == (4, r, r == 0)
        assert info["mesh"]["dp"] == 2 and info["mesh"]["mp"] == 2
        # the column layer keeps columns, the row layer rows; the row
        # layer's bias is whole on every rank
        assert info["flags"] == (True, 1, True, 0, False, (16, 16),
                                 (16, 16))
        x = got["x"]
        ref = x @ got["col_w"] + got["col_b"]
        y = ref @ got["row_w"] + got["row_b"]
        np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["g"], x @ got["g_w"] + got["g_b"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["z"], got["g"] @ got["rs_w"]
                                   + got["rs_b"], rtol=1e-5, atol=1e-6)
        # d sum(y): every row of the cotangent is ones
        ones = np.ones_like(y)
        np.testing.assert_allclose(got["x_grad"],
                                   ones @ got["row_w"].T @ got["col_w"].T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["col_w_grad"],
                                   x.T @ (ones @ got["row_w"].T),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["row_w_grad"], ref.T @ ones,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["row_b_grad"], ones.sum(0),
                                   rtol=1e-6)
    # every rank drew the same full parameters: the gathered ones agree
    for got in res[1:]:
        np.testing.assert_array_equal(got["col_w"], res[0]["col_w"])


def test_vocab_parallel_embedding_and_cross_entropy_match_dense(tmp_path):
    res = _spawn(W.vocab_and_cross_entropy, tmp_path)
    for got in res:
        table, ids = got["table"], got["ids"]
        np.testing.assert_array_equal(got["x"], table[ids])
        grad = np.zeros_like(table)
        np.add.at(grad, ids.reshape(-1), got["cot"].reshape(-1, 8))
        np.testing.assert_allclose(got["table_grad"], grad, rtol=1e-6,
                                   atol=1e-6)
        logits = torch.tensor(got["logits"], requires_grad=True)
        labels = torch.tensor(got["labels"])
        dense = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 64), labels.reshape(-1), reduction="none",
            ignore_index=-100).reshape(3, 5, 1)
        np.testing.assert_allclose(got["loss"], dense.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert got["loss"][0, 0, 0] == 0.0
        dense.sum().backward()
        np.testing.assert_allclose(got["logits_grad"], logits.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_sharding_stage1_holds_a_slice_of_each_moment(tmp_path):
    res = _spawn(W.sharding_stage1, tmp_path, 1e-2)
    for r, got in enumerate(res):
        # stage3_forward: gathered just in time, gradients reduce-scattered
        for overlap in (False, True):
            np.testing.assert_allclose(got[f"stage3_y_{overlap}"],
                                       got["stage3_dense_y"], rtol=1e-5,
                                       atol=1e-6)
            for g, d in zip(got[f"stage3_g_{overlap}"],
                            got["stage3_dense_g"]):
                np.testing.assert_allclose(g, d, rtol=1e-5, atol=1e-5)
        # weight 70 elements: 18 a rank, the last 16; bias 7: 2, 2, 2, 1
        shapes = sorted(got["moments"].values())
        want = sorted([(18 if r < 3 else 16,)] * 2
                      + [(2 if r < 3 else 1,)] * 2)
        assert shapes == want, got["moments"]
        # its state_dict gathers them whole, as the reference's arrays
        assert sorted(got["full_moments"].values()) == \
            sorted([(10, 7)] * 2 + [(7,)] * 2), got["full_moments"]
        np.testing.assert_allclose(got["w"], got["ref_w"], atol=1e-6)
        np.testing.assert_allclose(got["b"], got["ref_b"], atol=1e-6)
        np.testing.assert_array_equal(got["w"], res[0]["w"])


def test_data_parallel_averages_gradients_outside_no_sync(tmp_path):
    res = _spawn(W.data_parallel, tmp_path)
    w, x = res[0]["w"], res[0]["x"]
    # sum over the batch rows of d(x @ w + b).sum()/dw = x^T 1
    local = [x[r].T @ np.ones((2, 3), np.float32) for r in range(4)]
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["w"], w)     # rank 0's, broadcast
        np.testing.assert_allclose(got["synced"], sum(local) / 4,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["local"], local[r], rtol=1e-6)
        assert got["scaled"] == 2.0


@pytest.fixture
def _jax_single_process():
    # the reference's eager model builds plain layers without a hybrid
    # group; earlier tests in this process may have left one set
    saved = jtopology.get_hybrid_communicate_group()
    jtopology.set_hybrid_communicate_group(None)
    yield
    jtopology.set_hybrid_communicate_group(saved)


@pytest.mark.parametrize("tied", [False, True])
def test_eager_llama_mp2_dp2_matches_jax_eager_model(tmp_path,
                                                     _jax_single_process,
                                                     tied):
    cfg = dict(vars(JL.LLAMA_PRESETS["debug"]), tie_word_embeddings=tied)
    lr = 1e-3
    jpaddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg["vocab_size"], (4, 32)).astype(np.int64)
    labels = np.roll(ids, -1, 1).astype(np.int64)
    got = _spawn(W.eager_llama, tmp_path, cfg, state, ids, labels, lr)[0]
    # tied: no head of its own (lm_head None), the table is the head
    assert got["kinds"] == sorted(["ColumnParallelLinear",
                                   "NoneType" if tied else "Linear",
                                   "RowParallelLinear",
                                   "VocabParallelEmbedding"])
    opt = jpaddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.1,
        grad_clip=jpaddle.nn.ClipGradByGlobalNorm(1.0))
    loss = jm(jpaddle.to_tensor(ids), labels=jpaddle.to_tensor(labels))
    loss.backward()
    # the table's gradient: the lookup's plus, tied, the head's
    table_grad = np.asarray(jm.model.embed_tokens.weight.grad.numpy())
    np.testing.assert_allclose(
        got["table_grad"], table_grad, rtol=0,
        atol=1e-4 * float(np.abs(table_grad).max()))
    opt.step()
    np.testing.assert_allclose(got["loss"], float(loss.numpy()), rtol=1e-5)
    after = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    assert sorted(after) == sorted(got["params"])
    moved = 0.0
    for name, a in after.items():
        tol = 1e-4 * float(np.abs(a).max()) + 0.1 * lr
        assert got["params"][name].shape == a.shape, name
        assert float(np.abs(got["params"][name] - a).max()) <= tol, name
        moved = max(moved, float(np.abs(a - state[name]).max()))
    assert moved >= 0.5 * lr


def test_fleet_segment_parallel_mode_wraps_and_broadcasts(tmp_path):
    res = _spawn(W.segment_parallel, tmp_path)
    for r, got in enumerate(res):
        # dp 2 x sep 2: sep ranks are consecutive (mp is 1)
        assert got["mode"] == "segment_parallel"
        assert got["kind"] == "SegmentParallel"
        assert got["sep_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert not np.array_equal(got["before"], res[0]["before"]) or r == 0
        # every rank holds rank 0's parameters: broadcast over dp, then sep
        np.testing.assert_array_equal(got["after"], res[0]["before"])
        # the wrapper splits nothing: its forward is the layer's
        np.testing.assert_array_equal(got["y"], got["y_inner"])


def test_fleet_parameter_server_mode_raises_naming_roadmap():
    from paddle_tpu_torch.distributed.fleet import fleet as F

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.init_server()

    class _PSRole:
        _is_collective = False

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.init(role_maker=_PSRole())
