"""The port's ZeRO stages 1-3 through ``group_sharded_parallel`` and through
Fleet (``sharding_configs["stage"]``) at 4 gloo ranks on the CPU, held to
the reference's ``group_sharded_parallel`` stepped the same way in this
process.

The reference's stages are placements (its numbers are those of the
unsharded step), so each of its levels is one process's AdamW with the
global-norm clip on the global batch. The port's ranks each hold their
slices and take their rows (tests/torch_dist_workers.py::group_sharded):
"os", "os_g" and "p_g_os" at sharding 2 (ranks {0, 1} and {2, 3}, each
pair running the same job), "p_g_os" at sharding 4, and Fleet at mp 2 x
sharding 2 with stage 2 and stage 3. The model is the eager
LlamaForCausalLM of the "debug" preset (recompute on: under stage 3 each
layer's gathers run again in the backward) with the reference's weights,
3 AdamW steps (weight decay 0.1, clip 1.0) on 4 rows of 32 tokens.

Tolerances, as tests/test_torch_fleet_eager.py holds the eager Llama (its
stage-1 layer test holds a Linear within 1e-6 of AdamW in one process, and
so is the uneven Linear here): the losses within 1e-5 relative; every
parameter after the steps within 1e-4 of its largest magnitude plus a
tenth of the learning rate (AdamW moves an element by about lr·m /
sqrt(v), and where a gradient is within its round-off of eps the two
frameworks' round-off moves that step by a part of lr).

AdamW's update m / (sqrt(v) + eps) does not change when every gradient is
scaled, nor does a step whose global norm the clip brings down to 1, so
the parameters alone cannot see a group average taken wrong. The clip's
global norm each step is held to the reference's within 1e-5 relative,
and each moment after the steps within 1e-4 of its largest magnitude (the
uneven Linear, which has no clip, within 1e-5).
"""
import math
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.meta_parallel import \
    group_sharded_parallel as jgroup_sharded
from paddle_tpu.models import llama as JL

import torch_dist_workers as W
from paddle_tpu_torch import distributed as dist

LR = 1e-3
JOBS = [dict(name="os_sh2", level="os", sharding=2),
        dict(name="os_g_sh2", level="os_g", sharding=2),
        dict(name="p_g_os_sh2", level="p_g_os", sharding=2, reload=True),
        dict(name="p_g_os_sh4", level="p_g_os", sharding=4),
        dict(name="fleet_mp2_sh2_stage2", fleet=dict(mp_degree=2,
                                                     sharding_degree=2),
             stage=2),
        dict(name="fleet_mp2_sh2_stage3", fleet=dict(mp_degree=2,
                                                     sharding_degree=2),
             stage=3)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(cfg, n=3, b=4, s=32):
    out = []
    for k in range(n):
        ids = np.random.RandomState(20 + k).randint(0, cfg["vocab_size"],
                                                    (b, s))
        out.append((ids.astype(np.int64),
                    np.roll(ids, -1, 1).astype(np.int64)))
    return out


def _reference(cfg, level, batches):
    """The reference's group_sharded_parallel at ``level``: the initial
    state, the losses, the parameters after the steps, the clip's global
    norm each step (of the gradients before it) and the moments after."""
    saved = jtopology.get_hybrid_communicate_group()
    jtopology.set_hybrid_communicate_group(None)
    try:
        jpaddle.seed(0)
        jm = JL.LlamaForCausalLM(JL.LlamaConfig(**cfg))
        state = {k: np.asarray(v.numpy()) for k, v in
                 jm.state_dict().items()}
        opt = jpaddle.optimizer.AdamW(
            learning_rate=LR, parameters=jm.parameters(), weight_decay=0.1,
            grad_clip=jpaddle.nn.ClipGradByGlobalNorm(1.0))
        jm, opt, _ = jgroup_sharded(jm, opt, level)
        layer = getattr(jm, "_layer", jm)
        losses, norms = [], []
        for ids, labels in batches:
            loss = jm(jpaddle.to_tensor(ids),
                      labels=jpaddle.to_tensor(labels))
            loss.backward()
            norms.append(math.sqrt(sum(
                float(np.square(np.asarray(p.grad.numpy(),
                                           np.float64)).sum())
                for p in layer.parameters() if p.grad is not None)))
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        after = {n: np.asarray(p.numpy()) for n, p in
                 layer.named_parameters()}
        moments = {k: np.asarray(v.numpy()) for k, v in
                   opt.state_dict().items() if k != "_step_count"}
    finally:
        jtopology.set_hybrid_communicate_group(saved)
    return state, losses, after, norms, moments


_RUN = {}


@pytest.fixture
def run(tmp_path_factory):
    """One spawn of 4 ranks for every job."""
    if not _RUN:
        cfg = dict(vars(JL.LLAMA_PRESETS["debug"]))
        batches = _batches(cfg)
        refs = {lv: _reference(cfg, lv, batches)
                for lv in ("os", "os_g", "p_g_os")}
        out = tmp_path_factory.mktemp("group_sharded")
        dist.spawn(W.group_sharded, args=(str(out), cfg, refs["os"][0],
                                          batches, LR, JOBS),
                   nprocs=4, backend="gloo", timeout=240)
        _RUN.update(cfg=cfg, refs=refs, ranks=[
            pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(4)])
    return _RUN


def _hold(got, ref, name):
    _, losses, after, norms, moments = ref
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5,
                               err_msg=name)
    assert sorted(got["params"]) == sorted(after), name
    for k, a in after.items():
        assert got["params"][k].shape == a.shape, (name, k)
        tol = 1e-4 * float(np.abs(a).max()) + 0.1 * LR
        assert float(np.abs(got["params"][k] - a).max()) <= tol, (name, k)
    assert sorted(got["moments"]) == sorted(moments), name
    for k, a in moments.items():
        assert got["moments"][k].shape == a.shape, (name, k)
        tol = 1e-4 * float(np.abs(a).max())
        assert float(np.abs(got["moments"][k] - a).max()) <= tol, (name, k)


@pytest.mark.parametrize("job", JOBS, ids=[j["name"] for j in JOBS])
def test_group_sharded_matches_reference_step(run, job):
    level = job.get("level") or ("os_g" if job["stage"] == 2 else "p_g_os")
    ref = run["refs"][level]
    # the clip is active at least once: the norm it brings down is the
    # one that would show a gradient averaged wrong
    assert max(ref[3]) > 1.0
    for got in run["ranks"]:
        _hold(got[job["name"]], ref, job["name"])
    after = ref[2]
    moved = max(float(np.abs(after[k] - run["refs"]["os"][0][k]).max())
                for k in after)
    assert moved >= 0.5 * LR


def test_stage3_holds_slices_between_steps_and_state_dicts_are_full(run):
    state = run["refs"]["os"][0]
    order = list(state)
    for job in JOBS:
        n = job.get("sharding", 2)
        for got in run["ranks"]:
            out = got[job["name"]]
            for k, local in out["local"].items():
                numel = int(np.prod(state[k].shape))
                if "fleet" in job and job["stage"] == 3:
                    # the mp shard's slice over sharding 2
                    assert local < numel, (job["name"], k)
                elif job.get("level") == "p_g_os":
                    assert local == math.ceil(numel / n), (job["name"], k)
                else:
                    assert local == numel or "fleet" in job, (job["name"],
                                                              k)
            # the optimizer's state_dict holds each moment whole (its
            # names param_<i> after the model's parameters' order)
            for key, m in out["moments"].items():
                i = int(key.split(".")[0][len("param_"):])
                assert m.shape == state[order[i]].shape, (job["name"], key)
    assert run["ranks"][0]["p_g_os_sh2"]["kind"] == "GroupShardedStage3"
    assert run["ranks"][0]["os_g_sh2"]["kind"] == "GroupShardedStage2"
    for got in run["ranks"]:
        out = got["p_g_os_sh2"]
        # a model and optimizer loaded from the full state_dicts take the
        # same next step
        assert out["reload_loss"] == out["next_loss"]
        assert out["reload_gap"] == 0.0


def test_stage3_uneven_slices_match_adamw_on_the_mean_gradient(run):
    for r, got in enumerate(run["ranks"]):
        out = got["uneven"]
        # 70 weights: 18 a rank, the last rank's slice padded to 18; 7
        # biases: 2 a rank
        assert out["local"] == [18, 2]
        np.testing.assert_allclose(out["w"], out["ref_w"], atol=1e-6)
        np.testing.assert_allclose(out["b"], out["ref_b"], atol=1e-6)
        # no clip: a gradient averaged wrong shows in the moments
        assert sorted(out["moments"]) == sorted(out["ref_moments"])
        for k, want in out["ref_moments"].items():
            np.testing.assert_allclose(
                out["moments"][k], want,
                atol=1e-5 * float(np.abs(want).max()), rtol=0, err_msg=k)
        np.testing.assert_array_equal(out["w"], run["ranks"][0]["uneven"]
                                      ["w"])


def test_group_sharded_refuses_an_unknown_level():
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.meta_parallel import (
        DygraphShardingOptimizer, group_sharded_parallel)

    device = tpaddle.get_device()
    tpaddle.set_device("cpu")
    try:
        lin = nn.Linear(4, 3)
        opt = optimizer.AdamW(parameters=lin.parameters())
        with pytest.raises(ValueError, match="unknown group_sharded level"):
            group_sharded_parallel(lin, opt, "p_os")
        with pytest.raises(ValueError, match="stage 4"):
            DygraphShardingOptimizer(opt, stage=4)
    finally:
        tpaddle.set_device(device)
