"""Megatron sequence parallelism (distributed/fleet/sequence_parallel_utils
.py) over an mp group of 2 gloo ranks on the CPU.

The four SP ops forward and backward on numbers whose results are known:
ScatterOp keeps a rank's slice and all-gathers the gradient, GatherOp the
reverse, AllGatherOp reduce-scatters the gradient (a rank-dependent
cotangent shows the sum) and ReduceScatterOp sums a rank-dependent input.
Then ColumnSequenceParallelLinear -> RowSequenceParallelLinear over each
rank's half of a [S, B, in] input, with the reference's layers' weights
(paddle_tpu/distributed/fleet/sequence_parallel_utils.py in this process,
where its ops are identities: the dense product), and the gradients of
sum(y * w): the row layer's bias is marked sequence-parallel and its
gradient, a partial sum on each rank, is summed over mp by
register_sequence_parallel_allreduce_hooks.

Tolerances: the ops move numbers without arithmetic (exact) or sum two
ranks' f32 values (1e-6 relative); the layers against the reference's
f32 products within 1e-5 relative and 1e-6 absolute (f32 sums split over
ranks), as tests/test_torch_fleet_eager.py holds the tensor-parallel
layers. In the same world, SyncBatchNorm over each rank's half of a batch
against the reference's BatchNorm2D over the whole batch.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet import sequence_parallel_utils as JSP

import paddle_tpu_torch as tpaddle
import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.fleet import sequence_parallel_utils as SP

WORLD = 2
_RUN = {}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def run(tmp_path_factory):
    """The reference layers in this process, then one spawn of 2 ranks,
    shared by this module's tests."""
    if not _RUN:
        saved = jtopology.get_hybrid_communicate_group()
        jtopology.set_hybrid_communicate_group(None)
        try:
            _RUN.update(_run(tmp_path_factory))
        finally:
            jtopology.set_hybrid_communicate_group(saved)
    return _RUN


def _run(tmp_path_factory):
    rng = np.random.RandomState(3)
    x = rng.randn(8, 4, 6).astype(np.float32)
    w = rng.randn(8, 4, 6).astype(np.float32)
    seq_x = rng.randn(8, 2, 16).astype(np.float32)
    seq_w = rng.randn(8, 2, 16).astype(np.float32)
    jpaddle.seed(5)
    jcol = JSP.ColumnSequenceParallelLinear(16, 32, has_bias=True,
                                            gather_output=False)
    jrow = JSP.RowSequenceParallelLinear(32, 16, has_bias=True,
                                         input_is_parallel=True)
    jcol.bias.set_value(rng.randn(32).astype(np.float32))
    jrow.bias.set_value(rng.randn(16).astype(np.float32))
    jx = jpaddle.to_tensor(seq_x, stop_gradient=False)
    jy = jrow(jcol(jx))
    (jy * jpaddle.to_tensor(seq_w)).sum().backward()
    ref = {"y": jy.numpy(), "x_grad": jx.grad.numpy(),
           "col_w_grad": jcol.weight.grad.numpy(),
           "col_b_grad": jcol.bias.grad.numpy(),
           "row_w_grad": jrow.weight.grad.numpy(),
           "row_b_grad": jrow.bias.grad.numpy()}
    weights = [np.asarray(p.numpy()) for p in (jcol.weight, jcol.bias,
                                               jrow.weight, jrow.bias)]
    # SyncBatchNorm's job: the reference's BatchNorm2D over the whole batch
    bn_x = rng.randn(6, 3, 4, 5).astype(np.float32) * 2.0 + 1.0
    bn_g = rng.randn(6, 3, 4, 5).astype(np.float32)
    bn_wb = (np.linspace(0.5, 1.5, 3).astype(np.float32),
             np.linspace(-0.2, 0.3, 3).astype(np.float32))
    jbn = jpaddle.nn.BatchNorm2D(3)
    jbn.weight.set_value(bn_wb[0])
    jbn.bias.set_value(bn_wb[1])
    jy = jbn(jpaddle.to_tensor(bn_x))
    (jy * jpaddle.to_tensor(bn_g)).sum().backward()
    ref_bn = {"y": jy.numpy(), "w_grad": jbn.weight.grad.numpy(),
              "b_grad": jbn.bias.grad.numpy()}
    out = tmp_path_factory.mktemp("sequence_parallel")
    dist.spawn(W.sequence_parallel, args=(str(out), x, w, seq_x, seq_w,
                                          *weights, (bn_x, bn_g, bn_wb)),
               nprocs=WORLD, backend="gloo", timeout=180)
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(WORLD)]
    return {"x": x, "w": w, "ref": ref, "ranks": ranks, "ref_bn": ref_bn}


def test_scatter_and_gather_ops_forward_and_backward(run):
    x, w = run["x"], run["w"]
    for r, got in enumerate(run["ranks"]):
        mine = slice(4 * r, 4 * r + 4)
        y, g = got["scatter"]
        np.testing.assert_array_equal(y, x[mine])
        np.testing.assert_array_equal(g, w)
        y, g = got["gather"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(g, w[mine])
        y, g = got["scatter_axis1"]
        np.testing.assert_array_equal(y, x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(g, w)
        y, g, kind = got["scatter_eager"]
        assert kind == "Tensor"
        np.testing.assert_array_equal(y, x[mine])
        np.testing.assert_array_equal(g, w)


def test_allgather_and_reduce_scatter_ops_sum_over_mp(run):
    x, w = run["x"], run["w"]
    for r, got in enumerate(run["ranks"]):
        mine = slice(4 * r, 4 * r + 4)
        y, g = got["allgather"]
        np.testing.assert_array_equal(y, x)
        # the reduce-scatter of w * 1 and w * 2
        np.testing.assert_allclose(g, 3 * w[mine], rtol=1e-6)
        y, g = got["reduce_scatter"]
        np.testing.assert_allclose(y, 3 * x[mine], rtol=1e-6)
        np.testing.assert_array_equal(g, w)


def test_sequence_parallel_linear_pair_matches_reference_layers(run):
    ref = run["ref"]
    for got in run["ranks"]:
        pair = got["pair"]
        # each rank's output is its half of the sequence
        assert pair["local_y"] == (4, 2, 16)
        # the row layer's bias is sequence-parallel, the others are not
        assert pair["marked"] == [False, False, False, True]
        for key, want in ref.items():
            np.testing.assert_allclose(pair[key], want, rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_sync_batch_norm_matches_reference_whole_batch(run):
    """Each rank's half of the batch through SyncBatchNorm (statistics
    all-reduced) against the reference's BatchNorm2D on the whole batch:
    the outputs, and the weight's and bias's gradients summed over the
    ranks (within 1e-5: E[x^2] - E[x]^2 against the two-pass variance);
    the running buffers are left as they were."""
    ref = run["ref_bn"]
    got = [r["sync_bn"] for r in run["ranks"]]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               ref["y"], rtol=1e-5, atol=1e-5)
    for key in ("w_grad", "b_grad"):
        np.testing.assert_allclose(sum(g[key] for g in got), ref[key],
                                   rtol=1e-5, atol=1e-5)
    for g in got:
        assert g["kind"] == "SyncBatchNorm"
        np.testing.assert_array_equal(g["buffers"][0], np.zeros(3))
        np.testing.assert_array_equal(g["buffers"][1], np.ones(3))


@pytest.fixture
def _cpu_place():
    device = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(device)


def test_ops_are_identities_without_an_mp_group(_cpu_place):
    x = torch.randn(4, 3, requires_grad=True)
    for op in (SP.ScatterOp, SP.GatherOp, SP.AllGatherOp,
               SP.ReduceScatterOp):
        y = op.apply(x)
        assert torch.equal(y, x)
        g, = torch.autograd.grad(y.sum(), x)
        assert torch.equal(g, torch.ones_like(x))
    col = SP.ColumnSequenceParallelLinear(3, 4, has_bias=True)
    assert tuple(col.weight.shape) == (3, 4)
    with pytest.raises(ValueError, match="gather_output"):
        SP.ColumnSequenceParallelLinear(3, 4, gather_output=True)
    with pytest.raises(ValueError, match="input_is_parallel"):
        SP.RowSequenceParallelLinear(4, 3, input_is_parallel=False)
