"""The port's HybridTrainer over a mesh of 4 gloo ranks on the CPU, held to
the reference HybridTrainer on the 8-device CPU mesh (4 devices of it, at
the same mesh).

The reference trains in one process over full arrays; the port's ranks
each hold their shards (paddle_tpu_torch.distributed.spawn of rank
functions in tests/torch_dist_workers.py, which import only torch and the
port). Both start from the reference's initial parameters: the port's
ranks take their slices through utils.stacked_params_from_paddle_tpu.
Tokens come from numpy seeds. The config is the f32 one of
tests/test_distributed.py:263-266 with 4 heads of 8 (not 2 of 16), so that
mp 4 splits the heads.

Tolerances, as tests/test_torch_llama_train.py states them for one card:
losses within 1e-5 relative; the gathered moments after three steps within
1e-4 of their largest magnitude; the gathered parameters within that plus
a tenth of the learning rate (AdamW moves an element by about lr * m /
sqrt(v), and where a gradient is within its round-off of eps, the
frameworks' round-off moves that step by a part of lr). The clip's norm,
each mesh against the port's one-process trainer, within 1e-5 relative
(the sums of squares added in other orders).
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
from paddle_tpu_torch.distributed.topology import rank_layout
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=64, dtype="float32")
LR = 1e-2
AXES = ("dp", "pp", "sharding", "sep", "mp")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n, seed=10, b=4, s=32):
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


def _jax_trainer(degrees, seed=0):
    jt = JTrainer(JL.LlamaConfig(**CFG), _jax_mesh(degrees),
                  learning_rate=LR, seed=seed)
    return jt, jax.tree.map(np.asarray, jt.params)


def _spawn(fn, tmp_path, *args):
    dist.spawn(fn, args=(str(tmp_path),) + args, nprocs=4, backend="gloo",
               timeout=180)
    return pickle.loads((tmp_path / "rank0.pkl").read_bytes())


def _one_process_norms(np_params, batches, clip=1.0):
    tr = HybridTrainer(TL.LlamaConfig(**CFG), learning_rate=LR,
                       grad_clip_norm=clip, device="cpu")
    src = TL.leaves(stacked_params_from_paddle_tpu(np_params))
    with torch.no_grad():
        for name, t in TL.leaves(tr.params).items():
            t.copy_(src[name])
    norms = []
    for ids, labels in batches:
        tr.step(ids, labels)
        norms.append(float(tr.last_grad_norm))
    return norms


def _hold_state(sj, st):
    assert sorted(sj) == sorted(st) and int(st["step"]) == int(sj["step"])
    for key in sj:
        if key == "step":
            continue
        a = np.asarray(sj[key], np.float32)
        assert st[key].shape == a.shape, key
        tol = 1e-4 * float(np.abs(a).max()) + (0.1 * LR if key[0] == "p"
                                               else 0.0)
        assert float(np.abs(st[key] - a).max()) <= tol, key


@pytest.mark.parametrize("degrees", [{"sharding": 2, "mp": 2},
                                     {"dp": 2, "sharding": 2}, {"mp": 4}],
                         ids=["mp2xsh2", "dp2xsh2", "mp4"])
def test_mesh_trainer_matches_reference_trainer(tmp_path, degrees):
    jt, np_params = _jax_trainer(degrees)
    batches = _batches(3)
    got = _spawn(W.trainer_mesh, tmp_path, CFG, degrees, np_params,
                 batches, LR)
    lj = [float(jt.step(ids, labels)) for ids, labels in batches]
    np.testing.assert_allclose(got["losses"], lj, rtol=1e-5)
    _hold_state(jt.elastic_state(), got["state"])
    # each rank held only its shards
    mp, sh = degrees.get("mp", 1), degrees.get("sharding", 1)
    assert got["local_shapes"]["['blocks']['wq']"] == (2, 32 // sh, 32 // mp)
    assert got["local_shapes"]["['lm_head']"] == (32 // sh, 128 // mp)
    assert got["local_shapes"]["['embed']"] == (128 // mp, 32)
    # the clip counted each element once: the one-process norms
    np.testing.assert_allclose(got["norms"],
                               _one_process_norms(np_params, batches),
                               rtol=1e-5)


def test_elastic_state_under_mp2_sharding2_loads_under_dp4(tmp_path):
    _, np_params = _jax_trainer({"sharding": 2, "mp": 2}, seed=1)
    got = _spawn(W.trainer_elastic, tmp_path, CFG, np_params, _batches(3),
                 LR)
    assert got["reload_exact"]
    np.testing.assert_allclose(got["dp4_loss"], got["next_loss"],
                               rtol=1e-6)
    assert got["after_gap"] <= 1e-5


def test_clip_norm_equal_across_topologies(tmp_path):
    # a clip below the gradient norm, so that it scales every step
    _, np_params = _jax_trainer({"dp": 4}, seed=2)
    batches = _batches(2, seed=30)
    meshes = [{"dp": 4}, {"mp": 4}, {"dp": 2, "mp": 2},
              {"sharding": 4}]
    got = _spawn(W.trainer_norms, tmp_path, CFG, np_params, batches, LR,
                 0.05, meshes)
    ref = _one_process_norms(np_params, batches, clip=0.05)
    assert ref[0] > 0.05
    for mesh in meshes:
        np.testing.assert_allclose(got[str(mesh)], ref, rtol=1e-5,
                                   err_msg=str(mesh))


def test_converter_slices_tile_the_reference_arrays():
    _, np_params = _jax_trainer({"dp": 1})
    full = TL.leaves(stacked_params_from_paddle_tpu(np_params))
    specs = TL.leaves(TL.param_specs(TL.LlamaConfig(**CFG)))
    mesh = {"dp": 1, "sharding": 2, "mp": 2}
    pieces = [TL.leaves(stacked_params_from_paddle_tpu(
        np_params, rank_layout(mesh, rank=r))) for r in range(4)]
    for name, t in full.items():
        spec = specs[name]
        grid = [[pieces[2 * s + m][name] for m in range(2)]
                for s in range(2)]
        if "mp" in spec:
            rows = [torch.cat(g, dim=spec.index("mp")) for g in grid]
        else:
            assert all(torch.equal(g[0], g[1]) for g in grid)
            rows = [g[0] for g in grid]
        whole = torch.cat(rows, dim=spec.index("sharding")) \
            if "sharding" in spec else rows[0]
        assert torch.equal(whole, t), name


def test_trainer_refuses_what_is_not_ported():
    cfg = TL.LlamaConfig(**CFG)
    # a sep mesh larger than the world (one process) raises naming it, as
    # dp 2 does, and a sep mesh with no hybrid group behind it raises; the
    # reference's own refusals raise ValueError: micro-batches without a
    # 'pp' axis, and layers that pp does not divide
    with pytest.raises(ValueError, match="world"):
        HybridTrainer(cfg, mesh={"sep": 2}, device="cpu")
    params = TL.init_stacked_params(cfg, seed=0, device="cpu")
    ids = torch.zeros(2, 32, dtype=torch.long)
    with pytest.raises(ValueError, match="no hybrid group"):
        TL.loss_fn_stacked(params, (ids, ids), cfg, mesh={"sep": 2})
    with pytest.raises(ValueError, match="requires a mesh with a 'pp'"):
        HybridTrainer(cfg, pipeline_micro_batches=2, device="cpu")
    with pytest.raises(ValueError, match="divide evenly over pp=4"):
        HybridTrainer(cfg, mesh={"pp": 4}, pipeline_micro_batches=4,
                      device="cpu")
    # overlap_sends without pp does nothing, as in the reference
    assert HybridTrainer(cfg, overlap_sends=True, device="cpu").pipelined \
        is False
    tr = HybridTrainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.lower_text((4, 32))
    with pytest.raises(ValueError, match="split"):
        HybridTrainer(TL.LlamaConfig(**dict(CFG, num_attention_heads=2,
                                            num_key_value_heads=2)),
                      mesh={"mp": 4}, device="cpu")


def test_save_attn_over_mp2_sharding2_matches_reference_and_full(tmp_path):
    mesh = {"sharding": 2, "mp": 2}
    _, np_params = _jax_trainer(mesh)
    batches = _batches(3)
    jt = JTrainer(JL.LlamaConfig(**CFG, remat_policy="save_attn"),
                  _jax_mesh(mesh), learning_rate=LR, seed=0)
    lj = [float(jt.step(ids, labels)) for ids, labels in batches]
    jobs = [dict(name="full", mesh=mesh),
            dict(name="save_attn", mesh=mesh, policy="save_attn")]
    got = _spawn(W.trainer_sep, tmp_path, CFG, np_params, batches, LR, jobs)
    saved, full = got["save_attn"], got["full"]
    np.testing.assert_allclose(saved["losses"], lj, rtol=1e-5)
    _hold_state(jt.elastic_state(), saved["state"])
    assert saved["losses"] == full["losses"]
    assert saved["norms"] == full["norms"]
    assert all(np.array_equal(saved["state"][k], full["state"][k])
               for k in saved["state"])
    layers = CFG["num_hidden_layers"]
    assert saved["forwards_per_step"] == layers
    assert full["forwards_per_step"] == 2 * layers
