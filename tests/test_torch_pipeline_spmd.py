"""The port's spmd_pipeline and spmd_pipeline_interleaved at pp 4 over gloo
ranks on the CPU, held to the JAX package's on its CPU mesh
(tests/test_distributed.py:304-330, tests/test_pipeline_schedules.py:
151-196): the last stage's outputs, and the gradients of sum(out * g) with
respect to each stage's weights and to the input.

Each port rank calls the function with its stage's weights
(tests/torch_dist_workers.py::pipeline_spmd, one spawn for every case); the
reference runs inside shard_map over a 'pp' axis and jax.grad transposes
its ppermute ring. Tolerances: outputs and gradients within rtol 1e-5 and
1e-6 of the largest magnitude (f32 chains of 4 or 8 matrix products in two
frameworks). ``overlap_sends`` (each tick's micro-batch in halves) against
the unsplit path of the port: within rtol 1e-6 and 1e-7 of the largest
magnitude, not bit for bit (a half's GEMM may round differently from the
whole's; the reference's own bit-for-bit check of this,
tests/test_overlap.py::test_spmd_pipeline_overlap_sends_bitwise_parity,
fails); with an odd micro-batch (3 rows) it is the unsplit path, bit for
bit.
"""
import functools
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed.meta_parallel import (spmd_pipeline,
                                                  spmd_pipeline_interleaved)
from paddle_tpu.utils.jax_compat import shard_map

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist

PP, V, N_MICRO, MB, D = 4, 2, 8, 4, 16


def _inputs():
    rng = np.random.RandomState(0)
    ws = (rng.rand(PP, D, D).astype(np.float32) * 0.5)
    wv = (rng.randn(PP, V, D, D) / np.sqrt(D)).astype(np.float32)
    x = rng.rand(N_MICRO, MB, D).astype(np.float32)
    g = rng.randn(N_MICRO, MB, D).astype(np.float32)
    return ws, wv, x, g


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:PP]), ("pp",))


def _ref(kind, ws, x, g, overlap=False):
    """(out, dws, dx) of the reference's function on the CPU mesh."""
    n_micro = x.shape[0]

    def ring(w, xs):
        stage = jax.lax.axis_index("pp")
        if kind == "plain":
            out = spmd_pipeline(lambda p, h: h @ p[0], w, xs, n_micro,
                                axis_name="pp", overlap_sends=overlap)
        else:
            out = spmd_pipeline_interleaved(
                lambda p, h: jnp.tanh(h @ p), w[0], xs, n_micro, V,
                axis_name="pp")
        return jax.lax.psum(jnp.where(stage == PP - 1, out, 0.0), "pp")

    wspec = P("pp", None, None) if kind == "plain" else \
        P("pp", None, None, None)
    fn = shard_map(ring, mesh=_mesh(), in_specs=(wspec, P()),
                   out_specs=P(), check_vma=False)

    def loss(w, xs):
        return jnp.sum(fn(w, xs) * g)

    out = np.asarray(jax.jit(fn)(jnp.asarray(ws), jnp.asarray(x)))
    dws, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(ws),
                                                       jnp.asarray(x))
    return out, np.asarray(dws), np.asarray(dx)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws, wv, x, g = _inputs()
    out = tmp_path_factory.mktemp("spmd")
    dist.spawn(W.pipeline_spmd, args=(str(out), ws, wv, x, g, N_MICRO),
               nprocs=PP, backend="gloo", timeout=240)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(PP)]


def _close(got, want, rtol=1e-5, rel_atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["plain", "halves", "interleaved"])
def test_outputs_and_gradients_match_reference(runs, case):
    ws, wv, x, g = _inputs()
    kind = "interleaved" if case == "interleaved" else "plain"
    w = wv if kind == "interleaved" else ws
    out, dws, dx = _ref(kind, w, x, g, overlap=case == "halves")
    last = runs[-1][case]
    _close(last["out"], out)
    for r, got in enumerate(runs):
        assert got["stage"] == r
        if r < PP - 1:
            assert not got[case]["out"].any()     # zeros off the last stage
        _close(got[case]["dw"], dws[r])
    _close(runs[0][case]["dx"], dx)
    for got in runs[1:]:
        assert got[case]["dx"] is None


def test_overlap_sends_holds_the_unsplit_path(runs):
    for got in runs:
        for key in ("out", "dw"):
            _close(got["halves"][key], got["plain"][key], rtol=1e-6,
                   rel_atol=1e-7)
        # mb = 3 cannot split: the unsplit schedule, bit for bit
        for key in ("out", "dw", "dx"):
            a, b = got["odd_halves"][key], got["odd"][key]
            assert (a is None and b is None) or np.array_equal(a, b)
    ws, _, x, g = _inputs()
    out, dws, dx = _ref("plain", ws, x[:, :3], g[:, :3])
    _close(runs[-1]["odd"]["out"], out)
    _close(runs[0]["odd"]["dx"], dx)
