"""The port's expert-parallel MoE (``moe_block_stacked(..., group=)``) and
``global_scatter`` / ``global_gather`` at ep 2 (world 2) and ep 4 (world
4) over gloo ranks on the CPU, held to the reference on the global batch.

Each rank (tests/torch_dist_workers.py::moe_ep, torch and the port only)
holds its rows of x and its E / n experts; the reference runs
``moe_block_stacked`` under ``jit`` on one device, and on the (dp 2, ep 4)
mesh of the CPU devices as tests/test_moe_ep.py runs it (w1 / w2 sharded
over 'ep'). Both take 3 SGD steps (lr 1.0) of that file's loss,
mean((out - y)^2) + 0.01·aux, from its seed's parameters (d 16, f 32, 8
experts, 64 tokens). The port's ranks write their losses so that they sum
to it (moe_block_stacked's loss contract), and sum the wg gradients over
the group.

Tolerances: the routing is discrete, so the slots of the port's gathered
logits equal the reference's exactly; the first step's output rows and
aux within 1e-5 relative and 1e-6 absolute (f32 sums in other orders); the
losses within 1e-5 relative; the parameters after 3 steps within 1e-5 of
each leaf's largest magnitude (an SGD step of lr 1.0 carries the
gradients' last bits into the parameters). ``global_scatter`` moves rows
and ``global_gather`` moves them back exactly (equal to the reference's
``shard_map`` all_to_all bit for bit), and its gradient is the reverse
exchange of the cotangent.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import collective as jcollective
from paddle_tpu.distributed.utils import global_gather as jgather
from paddle_tpu.distributed.utils import global_scatter as jscatter
from paddle_tpu.incubate.distributed.models.moe import (moe_block_stacked,
                                                        topk_sort_dispatch)
from paddle_tpu.utils.jax_compat import shard_map

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist

D, F, E, S = 16, 32, 8, 64
STEPS, LR = 3, 1.0
SCATTER_ROWS = 32
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    """tests/test_moe_ep.py's seed and draws: x, y, then the params."""
    rng = np.random.RandomState(0)
    x = rng.randn(S, D).astype(np.float32)
    y = rng.randn(S, D).astype(np.float32)
    p = {"wg": (rng.randn(D, E) * 0.1).astype(np.float32),
         "w1": (rng.randn(E, D, F) * 0.05).astype(np.float32),
         "w2": (rng.randn(E, F, D) * 0.05).astype(np.float32)}
    return x, y, p


def _reference(x, y, p, mesh=None):
    """3 SGD steps of the reference, jitted, on one device or on ``mesh``
    (dp, ep) with the experts over 'ep': losses, the first step's output
    and aux, the parameters after."""
    def loss_fn(params, xx, yy):
        out, aux = moe_block_stacked(params, xx)
        return jnp.mean((out - yy) ** 2) + 0.01 * aux, (out, aux)

    @jax.jit
    def step(params, xx, yy):
        (l, (out, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, xx, yy)
        return l, out, aux, jax.tree_util.tree_map(
            lambda a, b: a - LR * b, params, g)

    params = {k: jnp.asarray(v) for k, v in p.items()}
    xx, yy = jnp.asarray(x), jnp.asarray(y)
    if mesh is not None:
        spec = {"wg": P(None, "ep"), "w1": P("ep"), "w2": P("ep")}
        params = {k: jax.device_put(v, NamedSharding(mesh, spec[k]))
                  for k, v in params.items()}
        xx = jax.device_put(xx, NamedSharding(mesh, P("dp")))
        yy = jax.device_put(yy, NamedSharding(mesh, P("dp")))
    losses = []
    for i in range(STEPS):
        l, out, aux, params = step(params, xx, yy)
        losses.append(float(l))
        if i == 0:
            out0, aux0 = np.asarray(out), float(aux)
    return {"losses": losses, "out0": out0, "aux0": aux0,
            **{k: np.asarray(v) for k, v in params.items()}}


def _reference_scatter(rows, n):
    """The reference's global_scatter and global_gather of ``rows`` under
    a shard_map over an 'ep' axis of n CPU devices (rank r's rows
    r·R/n onwards), and the gather of the ramp cotangent (the scatter's
    gradient)."""
    group = jcollective.new_group(list(range(n)), axis_name="ep")
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("ep",))

    def run(fn, a):
        def body(v):
            out = fn(JTensor(v), None, None, group=group)
            return out._value if isinstance(out, JTensor) else out
        return np.asarray(shard_map(body, mesh=mesh, in_specs=P("ep"),
                                    out_specs=P("ep"), check_vma=False)(
            jnp.asarray(a)))

    per = rows.shape[0] // n
    ramp = np.concatenate([np.arange(per * rows.shape[1], dtype=np.float32)
                           .reshape(per, -1)] * n)
    return run(jscatter, rows), run(jgather, ramp)


_RUNS = {}


@pytest.fixture
def runs(request, tmp_path_factory):
    """One spawn a world (one test a world, so that xdist's workers do not
    each run the same world)."""
    world = request.param
    if world not in _RUNS:
        x, y, p = _inputs()
        scatter = np.random.RandomState(3).randn(SCATTER_ROWS, 3) \
            .astype(np.float32)
        out = tmp_path_factory.mktemp(f"moe_ep_world{world}")
        dist.spawn(W.moe_ep, args=(str(out), p, x, y, STEPS, LR, scatter),
                   nprocs=world, backend="gloo", timeout=240)
        ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                 for r in range(world)]
        _RUNS[world] = (world, ranks, scatter)
    return _RUNS[world]


WORLDS = pytest.mark.parametrize("runs", [4, 2], ids=["ep4", "ep2"],
                                 indirect=True)


@WORLDS
def test_moe_block_stacked_over_an_expert_group_matches_reference(runs):
    world, ranks, _ = runs
    x, y, p = _inputs()
    slot_ref = np.asarray(topk_sort_dispatch(jnp.asarray(x @ p["wg"]), 1.5,
                                             2)[0])
    one = _reference(x, y, p)
    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    on_mesh = _reference(x, y, p, Mesh(devs, ("dp", "ep")))
    rows = S // world
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["slot"], slot_ref)
        mine = slice(r * rows, (r + 1) * rows)
        for ref in (one, on_mesh):
            np.testing.assert_allclose(got["out0"], ref["out0"][mine], **TOL)
            np.testing.assert_allclose(got["aux0"], ref["aux0"], **TOL)
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
    for key in ("wg", "w1", "w2"):
        for ref in (one, on_mesh):
            tol = 1e-5 * float(np.abs(ref[key]).max())
            np.testing.assert_allclose(ranks[0][key], ref[key], rtol=0,
                                       atol=tol, err_msg=key)
    # every rank took the same wg step
    for got in ranks[1:]:
        np.testing.assert_array_equal(got["wg"], ranks[0]["wg"])


@WORLDS
def test_global_scatter_and_gather_match_reference_all_to_all(runs):
    world, ranks, scatter = runs
    want, want_grad = _reference_scatter(scatter, world)
    per = SCATTER_ROWS // world
    for r, got in enumerate(ranks):
        mine = slice(r * per, (r + 1) * per)
        np.testing.assert_array_equal(got["scattered"], want[mine])
        np.testing.assert_array_equal(got["round_trip"], scatter[mine])
        np.testing.assert_array_equal(got["scatter_grad"], want_grad[mine])
        assert got["eager_kind"] == "Tensor" and got["eager_equal"]


@WORLDS
def test_expert_group_value_errors(runs):
    world, ranks, _ = runs
    per = SCATTER_ROWS // world
    for got in ranks:
        err = got["errors"]
        assert f"{per - 1} rows" in err["rows"] and f"{world} ranks" in \
            err["rows"]
        assert "splits the" in err["counts"] and "equally" in err["counts"]
        assert f"{2 * world + 1} experts" in err["experts"]


def test_one_rank_group_is_the_local_block():
    from paddle_tpu_torch.distributed.utils import global_scatter
    from paddle_tpu_torch.incubate.distributed.models import moe as TM

    x, y, p = _inputs()
    tp = TM.moe_params_from_paddle_tpu(p)
    xs = torch.from_numpy(x)
    # a group without a process group (one process) is a world of one
    group = dist.new_group([0])
    a, aux_a = TM.moe_block_stacked(tp, xs)
    b, aux_b = TM.moe_block_stacked(tp, xs, group=group)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert global_scatter(xs, None, None, group=group) is xs
