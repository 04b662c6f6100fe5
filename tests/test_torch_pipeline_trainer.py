"""The port's HybridTrainer over meshes with a 'pp' axis (gloo ranks on the
CPU), held to the reference HybridTrainer(mesh, pipeline_micro_batches=…)
on the 8-device CPU mesh: pp 2 x mp 2, pp 2 x dp 2 and pp 4 with 4
micro-batches, pp 2 with 1 micro-batch (the reference's plain stack
placement), and pp 2 with ``overlap_sends`` (2 micro-batches of 2 rows, so
that each splits into halves).

Both sides start from the reference's initial parameters (the port's ranks
take their slices, the stack axis split over 'pp', through
utils.stacked_params_from_paddle_tpu). The config is
tests/test_torch_hybrid_trainer.py's with 4 layers, so that pp 4 holds one
a stage.

Tolerances. Against the port's one-process trainer on the same numbers, as
tests/test_torch_hybrid_trainer.py:12-21 states them: the gathered moments
after three steps within 1e-4 of their largest magnitude, the gathered
parameters within that plus a tenth of the learning rate, the clip's norm
within 1e-5 relative. Against the reference's pipelined trainer: losses
within 1e-5 relative and the parameters as above; the moments within 5e-4
of their largest magnitude, because at this config (4 layers, 8 rows a
step) the reference's own pipelined trainer differs from its stacked one
by up to 3.1e-4 of the largest magnitude (m and v of w_up at pp 2 x mp 2),
and the two packages' one-process trainers differ by up to 1.3e-4, while
the port's pipelined trainer stays within 3.8e-5 of its one-process one.
The leaves every pp rank holds whole (embedding, final norm, head) must be
bit for bit equal on every pp rank after the steps.

remat_policy="save_attn" at pp 2 recomputes whole blocks, as the
reference's stage function does (llama.py:620): held to the reference's
pipelined trainer with save_attn as above, and bit for bit to the port's
"full" job of the same mesh and micro-batches, with the flash forward
called twice a layer a micro-batch on each stage (once more in the
recomputation).
"""
import pickle

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.distributed.fleet.trainer import HybridTrainer as JTrainer
from paddle_tpu.models import llama as JL

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.fleet import HybridTrainer
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=64, dtype="float32")
LR = 1e-2
AXES = ("dp", "pp", "sharding", "sep", "mp")
JOBS = {
    4: [dict(name="pp2xmp2", mesh={"pp": 2, "mp": 2}, n_micro=4,
             elastic=True),
        dict(name="pp2xdp2", mesh={"pp": 2, "dp": 2}, n_micro=4),
        dict(name="pp4", mesh={"pp": 4}, n_micro=4)],
    2: [dict(name="pp2_one_micro", mesh={"pp": 2}, n_micro=1),
        dict(name="pp2_overlap", mesh={"pp": 2}, n_micro=2, overlap=True)],
}
# remat_policy="save_attn" under pp: whole blocks recomputed, as the
# reference's stage function does (beside the "full" job of the mesh)
SAVE_ATTN = {2: [dict(name="pp2_one_micro_save_attn", mesh={"pp": 2},
                      n_micro=1, policy="save_attn")], 4: []}
BATCH = {4: 8, 2: 4}


def _batches(n, b, seed=10, s=32):
    out = []
    for k in range(n):
        ids = np.random.RandomState(seed + k).randint(0, 128, (b, s))
        out.append((ids.astype(np.int64), np.roll(ids, -1, 1)
                    .astype(np.int64)))
    return out


def _jax_mesh(degrees):
    shape = tuple(degrees.get(a, 1) for a in AXES)
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, AXES)


def _np_params():
    jt = JTrainer(JL.LlamaConfig(**CFG), _jax_mesh({"dp": 1}),
                  learning_rate=LR, seed=0)
    return jax.tree.map(np.asarray, jt.params)


_RUNS = {}


@pytest.fixture
def runs(request, tmp_path_factory):
    """One spawn a world, shared by the tests of this module."""
    world = request.param
    if world not in _RUNS:
        _RUNS[world] = _run(world, tmp_path_factory)
    return _RUNS[world]


def _run(world, tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        np_params = _np_params()
        batches = _batches(3, BATCH[world])
        ref, norms = {}, {}
        for job in JOBS[world] + SAVE_ATTN[world]:
            jt = JTrainer(JL.LlamaConfig(**CFG, remat_policy=job.get(
                              "policy", "full")), _jax_mesh(job["mesh"]),
                          learning_rate=LR, seed=0,
                          pipeline_micro_batches=job["n_micro"],
                          overlap_sends=job.get("overlap", False))
            jt.load_elastic_state(_fresh_state(np_params))
            losses = [float(jt.step(i, l)) for i, l in batches]
            ref[job["name"]] = (losses, jt.elastic_state())
        norms = _one_process(np_params, batches)
    finally:
        torch.set_num_threads(threads)
    out = tmp_path_factory.mktemp(f"trainer_world{world}")
    dist.spawn(W.trainer_pipeline, args=(str(out), CFG, np_params, batches,
                                         LR, JOBS[world] + SAVE_ATTN[world]),
               nprocs=world, backend="gloo", timeout=240)
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(world)]
    return world, ref, norms, ranks


def _fresh_state(np_params):
    """The reference's elastic state of ``np_params`` at step 0."""
    state = {"step": np.asarray(0, np.int64)}
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    for kp, v in flat:
        key = jax.tree_util.keystr(kp)
        state["p:" + key] = v
        state["m:" + key] = np.zeros(v.shape, np.float32)
        state["v:" + key] = np.zeros(v.shape, np.float32)
    return state


def _one_process(np_params, batches):
    """The port's one-process trainer's clip norms and final state."""
    tr = HybridTrainer(TL.LlamaConfig(**CFG), learning_rate=LR,
                       device="cpu")
    src = TL.leaves(stacked_params_from_paddle_tpu(np_params))
    with torch.no_grad():
        for name, t in TL.leaves(tr.params).items():
            t.copy_(src[name])
    norms = []
    for ids, labels in batches:
        tr.step(ids, labels)
        norms.append(float(tr.last_grad_norm))
    return norms, tr.elastic_state()


def _hold_state(sj, st, moments=1e-4):
    assert sorted(sj) == sorted(st) and int(st["step"]) == int(sj["step"])
    for key in sj:
        if key == "step":
            continue
        a = np.asarray(sj[key], np.float32)
        assert st[key].shape == a.shape, key
        tol = (1e-4 * float(np.abs(a).max()) + 0.1 * LR if key[0] == "p"
               else moments * float(np.abs(a).max()))
        assert float(np.abs(st[key] - a).max()) <= tol, key


WORLDS = pytest.mark.parametrize("runs", [4, 2], ids=["world4", "world2"],
                                 indirect=True)


@WORLDS
def test_pipelined_trainer_matches_reference_trainer(runs):
    world, ref, norms, ranks = runs
    for job in JOBS[world]:
        name = job["name"]
        losses, state = ref[name]
        for got in ranks:
            np.testing.assert_allclose(got[name]["losses"], losses,
                                       rtol=1e-5, err_msg=name)
        _hold_state(state, ranks[0][name]["state"], moments=5e-4)
        # each rank held its L / pp layers
        pp = job["mesh"]["pp"]
        shape = ranks[0][name]["local_shapes"]["['blocks']['wq']"]
        assert shape[0] == CFG["num_hidden_layers"] // pp, (name, shape)


@WORLDS
def test_clip_norm_and_state_equal_the_one_process_trainer(runs):
    world, ref, (norms, state), ranks = runs
    for job in JOBS[world]:
        for got in ranks:
            np.testing.assert_allclose(got[job["name"]]["norms"], norms,
                                       rtol=1e-5, err_msg=job["name"])
        _hold_state(state, ranks[0][job["name"]]["state"])


@WORLDS
def test_replicated_leaves_equal_on_every_pp_rank(runs):
    world, ref, norms, ranks = runs
    for job in JOBS[world]:
        name = job["name"]
        by_place = {}
        for got in ranks:
            coords = dict(got[name]["coords"])
            coords.pop("pp")
            by_place.setdefault(tuple(sorted(coords.items())), []).append(
                got[name]["replicated"])
        for group in by_place.values():
            assert len(group) == job["mesh"]["pp"]
            for other in group[1:]:
                for leaf, value in group[0].items():
                    assert np.array_equal(value, other[leaf]), (name, leaf)


@pytest.mark.parametrize("runs", [4], ids=["world4"], indirect=True)
def test_elastic_state_at_pp2_mp2_loads_at_dp4(runs):
    world, ref, norms, ranks = runs
    got = ranks[0]["pp2xmp2"]
    assert got["reload_exact"]
    np.testing.assert_allclose(got["dp_loss"], got["losses"][-1], rtol=1e-6)
    assert got["after_gap"] <= 1e-5


@pytest.mark.parametrize("runs", [2], ids=["world2"], indirect=True)
def test_save_attn_under_pp_recomputes_whole_blocks(runs):
    world, ref, _, ranks = runs
    losses, state = ref["pp2_one_micro_save_attn"]
    layers = CFG["num_hidden_layers"] // 2
    for got in ranks:
        saved, full = got["pp2_one_micro_save_attn"], got["pp2_one_micro"]
        np.testing.assert_allclose(saved["losses"], losses, rtol=1e-5)
        assert saved["losses"] == full["losses"]
        assert saved["norms"] == full["norms"]
        assert saved["forwards_per_step"] == full["forwards_per_step"] \
            == 2 * layers
    _hold_state(state, ranks[0]["pp2_one_micro_save_attn"]["state"],
                moments=5e-4)
    a = ranks[0]["pp2_one_micro_save_attn"]["state"]
    b = ranks[0]["pp2_one_micro"]["state"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
