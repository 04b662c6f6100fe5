"""The port's ring attention (ops/kernels/ring_attention.py) over a sep
group of 2 and of 4 gloo ranks on the CPU, held to the reference's
``ring_attention_bhsd`` under ``shard_map`` over 'sep' on the 8-device CPU
mesh (as tests/test_distributed.py:81-175 runs it): O and the gradients of
sum(O * w) for q, k and v, causal and not, at a shard of a kernel shape
(128 positions a rank: the flash kernels' plain versions) and at a shard
the kernels do not take (8: the flash module's dense fallback).

Tolerances, relative to the largest magnitude of the reference's tensor:
f32 within 1e-5 (both sides compute each hop in f32; the port's merge and
its accumulators sum in other orders: the largest gap seen is 9e-7); bf16
within 2e-2 (both round O and the gradients to bf16 once; the port also
rounds each hop's O, dK and dV to bf16 before it merges or adds them in
f32, as the flash kernels return them: the largest gap seen against a
float64 dense reference is 8.2e-3).

Beside it, the one-process composition that chip_smoke.py's sep phase
runs on one card (``compose_forward`` / ``compose_backward``: n virtual
ranks, no exchange) against ``flash_attention_bhsd`` over the whole
sequence in f32 (within 1e-5 of the largest magnitude), and no kernel
launches on the CPU.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.ops.pallas.ring_attention import ring_attention_bhsd as \
    jring
from paddle_tpu.utils.jax_compat import shard_map

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import ring_attention as RA

B, H, D = 1, 2, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (dtype, causal, positions a rank)
CASES = [("float32", True, 128), ("float32", False, 128),
         ("float32", True, 8), ("float32", False, 8),
         ("bfloat16", True, 128), ("bfloat16", False, 128)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _name(dtype, causal, shard):
    return f"{dtype}_{'causal' if causal else 'full'}_{shard}"


def _inputs(n, shard, seed):
    rng = np.random.RandomState(seed)
    return {x: rng.randn(B, H, n * shard, D).astype(np.float32)
            for x in "qkvw"}


def _reference(n, case, dtype, causal):
    """The reference ring's O and gradients, whole, as f32 numpy."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("sep",))
    spec = P(None, None, "sep", None)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(case[x]).astype(jd) for x in "qkv")
    w = jnp.asarray(case["w"])

    def ring(ql, kl, vl):
        return jring(ql, kl, vl, axis_name="sep", is_causal=causal)

    fwd = shard_map(ring, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                    check_vma=False)

    def loss(a, b, c):
        return jnp.sum(fwd(a, b, c).astype(jnp.float32) * w)

    o = fwd(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return {n_: np.asarray(t.astype(jnp.float32))
            for n_, t in zip(("o", "dq", "dk", "dv"), (o,) + grads)}


_RUNS = {}


@pytest.fixture
def runs(request, tmp_path_factory):
    """One spawn a world, every case in it (one test a world, so that
    xdist's workers do not each spawn the same world)."""
    n = request.param
    if n not in _RUNS:
        cases = {}
        for i, (dtype, causal, shard) in enumerate(CASES):
            case = _inputs(n, shard, seed=10 * n + i)
            case.update(dtype=dtype, causal=causal)
            cases[_name(dtype, causal, shard)] = case
        out = tmp_path_factory.mktemp(f"ring_world{n}")
        dist.spawn(W.ring_attention, args=(str(out), cases), nprocs=n,
                   backend="gloo", timeout=180)
        ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                 for r in range(n)]
        _RUNS[n] = (cases, ranks)
    return n, _RUNS[n]


WORLDS = pytest.mark.parametrize("runs", [2, 4], ids=["sep2", "sep4"],
                                 indirect=True)


@WORLDS
def test_ring_matches_reference_ring(runs):
    n, (cases, ranks) = runs
    for dtype, causal, shard in CASES:
        name = _name(dtype, causal, shard)
        ref = _reference(n, cases[name], dtype, causal)
        for key, want in ref.items():
            got = np.concatenate([r[name][key] for r in ranks], axis=2)
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            assert err <= TOL[dtype] * scale, (name, key, err / scale)
        # O and the gradients come back in the inputs' dtype
        assert ranks[0][name]["dtypes"] == [f"torch.{dtype}"] * 4
    # the sep group is the world's ring, and nothing launched on the CPU
    for r, got in enumerate(ranks):
        assert got["mode"] == "segment_parallel"
        assert got["sep_ranks"] == list(range(n))
        assert tuple(got["neighbours"]) == ((r - 1) % n, (r + 1) % n)
        assert all(v == 0 for v in got["launches"].values())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_composition_matches_whole_flash_attention(n, causal):
    case = _inputs(n, 128, seed=7 + n)
    q, k, v, w = (torch.tensor(case[x]) for x in "qkvw")
    qs, ks, vs, ws = (t.chunk(n, dim=2) for t in (q, k, v, w))
    reset_launch_counts()
    os_, lses = RA.compose_forward(qs, ks, vs, causal)
    dqs, dks, dvs = RA.compose_backward(qs, ks, vs, os_, lses, ws, causal)
    assert all(c == 0 for c in launch_counts().values())
    _, lse = FA.forward_with_lse(q, k, v, None, 0, causal, 0.0)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    whole = FA.flash_attention_bhsd(qg, kg, vg, is_causal=causal)
    (whole * w).sum().backward()
    for got, want in ((torch.cat(os_, 2), whole.detach()),
                      (torch.cat(lses, 2), lse), (torch.cat(dqs, 2), qg.grad),
                      (torch.cat(dks, 2), kg.grad),
                      (torch.cat(dvs, 2), vg.grad)):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
