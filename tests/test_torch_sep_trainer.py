"""The port's HybridTrainer over meshes with a 'sep' axis (gloo ranks on the
CPU: sep 2 at world 2; sep 2 x mp 2, sep 2 x sharding 2 and pp 2 x sep 2
with 4 micro-batches at world 4), held to the reference HybridTrainer on
the same mesh of the 8-device CPU mesh, and to the port's own one-process
trainer (mesh=None).

Each sep rank holds every leaf and its shard of every sequence (16 of the
32 positions); attention runs as a ring over the sep group and RoPE at the
shard's global positions. The reference rotates the whole array before its
shard_map over 'sep' (llama.py:486-509), so a shard rotated at local
positions would miss it at the first loss. Both sides start from the
reference's initial parameters (the port's ranks take their slices through
utils.stacked_params_from_paddle_tpu); the config is
tests/test_torch_hybrid_trainer.py's.

Tolerances, as tests/test_torch_hybrid_trainer.py:12-21 states them:
losses within 1e-5 relative; the gathered moments after three steps within
1e-4 of their largest magnitude; the gathered parameters within that plus a
tenth of the learning rate; the clip's norm against the one-process
trainer within 1e-5 relative. After the steps every leaf, parameters and
moments, is bit for bit equal on every rank of a sep group.

Every world steps on 4 rows of 32 tokens. At 8 rows this config is too
sensitive to hold a mesh to 1e-4: the reference's own mp 2 trainer ends
3.4e-4 of the largest magnitude away from its one-device trainer (v of
wk), and its sep 2 x mp 2 one 2.7e-4, while at 4 rows every one of its
meshes (mp 2, pp 2, sep 2 x mp 2, sep 2 x sharding 2) stays within 3.5e-6
of it.
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
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=64, dtype="float32")
LR = 1e-2
SEQ = 32
AXES = ("dp", "pp", "sharding", "sep", "mp")
JOBS = {
    2: [dict(name="sep2", mesh={"sep": 2})],
    4: [dict(name="sep2xmp2", mesh={"sep": 2, "mp": 2}),
        dict(name="sep2xsh2", mesh={"sep": 2, "sharding": 2}),
        dict(name="pp2xsep2", mesh={"pp": 2, "sep": 2}, n_micro=4)],
}
# remat_policy="save_attn" over 'sep' (beside the "full" job of its mesh)
SAVE_ATTN = {2: [dict(name="sep2_save_attn", mesh={"sep": 2},
                      policy="save_attn")], 4: []}
BATCH = 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n, b, seed=10):
    out = []
    for k in range(n):
        ids = np.random.RandomState(seed + k).randint(0, 128, (b, SEQ))
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


def _fresh_state(np_params):
    """The reference's elastic state of ``np_params`` at step 0."""
    state = {"step": np.asarray(0, np.int64)}
    for kp, v in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        key = jax.tree_util.keystr(kp)
        state["p:" + key] = v
        state["m:" + key] = np.zeros(v.shape, np.float32)
        state["v:" + key] = np.zeros(v.shape, np.float32)
    return state


def _one_process(np_params, batches):
    """The port's one-process trainer's losses, clip norms and state."""
    tr = HybridTrainer(TL.LlamaConfig(**CFG), learning_rate=LR,
                       device="cpu")
    src = TL.leaves(stacked_params_from_paddle_tpu(np_params))
    with torch.no_grad():
        for name, t in TL.leaves(tr.params).items():
            t.copy_(src[name])
    losses, norms = [], []
    for ids, labels in batches:
        losses.append(float(tr.step(ids, labels)))
        norms.append(float(tr.last_grad_norm))
    return losses, norms, tr.elastic_state()


_RUNS = {}


@pytest.fixture
def runs(request, tmp_path_factory):
    """One spawn a world, every job in it (one test a world, so that
    xdist's workers do not each run the same world)."""
    world = request.param
    if world not in _RUNS:
        _RUNS[world] = _run(world, tmp_path_factory)
    return _RUNS[world]


def _run(world, tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        np_params = _np_params()
        batches = _batches(3, BATCH)
        ref = {}
        for job in JOBS[world] + SAVE_ATTN[world]:
            jt = JTrainer(JL.LlamaConfig(**CFG, remat_policy=job.get(
                              "policy", "full")), _jax_mesh(job["mesh"]),
                          learning_rate=LR, seed=0,
                          pipeline_micro_batches=job.get("n_micro"))
            jt.load_elastic_state(_fresh_state(np_params))
            losses = [float(jt.step(i, l)) for i, l in batches]
            ref[job["name"]] = (losses, jt.elastic_state())
        one = _one_process(np_params, batches)
    finally:
        torch.set_num_threads(threads)
    out = tmp_path_factory.mktemp(f"sep_trainer_world{world}")
    dist.spawn(W.trainer_sep, args=(str(out), CFG, np_params, batches, LR,
                                    JOBS[world] + SAVE_ATTN[world]),
               nprocs=world, backend="gloo", timeout=240)
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(world)]
    return world, ref, one, ranks


def _hold_state(sj, st):
    assert sorted(sj) == sorted(st) and int(st["step"]) == int(sj["step"])
    for key in sj:
        if key == "step":
            continue
        a = np.asarray(sj[key], np.float32)
        assert st[key].shape == a.shape, key
        tol = (1e-4 * float(np.abs(a).max()) + 0.1 * LR if key[0] == "p"
               else 1e-4 * float(np.abs(a).max()))
        assert float(np.abs(st[key] - a).max()) <= tol, key


WORLDS = pytest.mark.parametrize("runs", [4, 2], ids=["world4", "world2"],
                                 indirect=True)


@WORLDS
def test_sep_trainer_matches_reference_and_one_process_trainers(runs):
    world, ref, (losses1, norms1, state1), ranks = runs
    for job in JOBS[world]:
        name = job["name"]
        losses, state = ref[name]
        for got in ranks:
            out = got[name]
            np.testing.assert_allclose(out["losses"], losses, rtol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(out["losses"], losses1, rtol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(out["norms"], norms1, rtol=1e-5,
                                       err_msg=name)
            # each data rank's rows, each sep rank's half of every sequence
            rows = BATCH // job["mesh"].get("sharding", 1)
            want = ((job["n_micro"], rows // job["n_micro"], SEQ // 2)
                    if "n_micro" in job else (rows, SEQ // 2))
            assert out["placed"] == want, (name, out["placed"])
            assert out["sep_replicas_equal"], (name, out["coords"])
            assert "sequence length 31" in out["odd_sequence"]
            assert "sep=2" in out["odd_sequence"]
        _hold_state(state, ranks[0][name]["state"])
        _hold_state(state1, ranks[0][name]["state"])


def test_sep_mesh_without_its_hybrid_group_raises():
    cfg = TL.LlamaConfig(**CFG)
    params = TL.init_stacked_params(cfg, seed=0, device="cpu")
    ids = torch.zeros(2, SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="sep=2.*no hybrid group"):
        TL.loss_fn_stacked(params, (ids, ids), cfg, mesh={"sep": 2})
    # a sep mesh larger than the initialized world (one process)
    with pytest.raises(ValueError, match="world"):
        HybridTrainer(cfg, mesh={"sep": 2}, device="cpu")


@pytest.mark.parametrize("runs", [2], ids=["world2"], indirect=True)
def test_save_attn_over_sep_matches_reference_and_full_policy(runs):
    world, ref, _, ranks = runs
    losses, state = ref["sep2_save_attn"]
    layers = CFG["num_hidden_layers"]
    for got in ranks:
        saved, full = got["sep2_save_attn"], got["sep2"]
        np.testing.assert_allclose(saved["losses"], losses, rtol=1e-5)
        assert saved["losses"] == full["losses"]
        assert saved["norms"] == full["norms"]
        hops = saved["coords"]["sep"] + 1
        assert saved["forwards_per_step"] == layers * hops
        assert full["forwards_per_step"] == 2 * layers * hops
        assert saved["sep_replicas_equal"]
    _hold_state(state, ranks[0]["sep2_save_attn"]["state"])
    a, b = ranks[0]["sep2_save_attn"]["state"], ranks[0]["sep2"]["state"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
