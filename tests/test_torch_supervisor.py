"""The port's self-healing supervisor (paddle_tpu_torch.distributed.
resilience.supervisor) on the CPU, against the JAX package's.

Bit for bit (the step is numpy, the same float64 arithmetic on both
sides): the reference's single-process toy runs (tests/
test_supervisor.py:171-282: clean, a NaN batch skipped, a rollback after
two anomalies in a row, a disk-tier resume into a fresh supervisor) give
the port the same reports, losses, final states and train/* counts. Two
supervisors on threads form a 2-rank group over the TCP transport and
clear a stale ``__unhealthy__`` mark; their snapshot ring delivers each
rank's state to its neighbour. One 2-process world (tests/
torch_resilience_worker.py "elastic") kills rank 1 at its 5th step;
the survivor's watchdog escalates, the relaunched rank rejoins and
restores from the survivor's ring replica, and both end on the
uninterrupted trajectory (NaN batch skipped in both) within 1e-12.
``HybridTrainer.run_elastic`` on a tiny Llama (one process, f32) holds to
the reference trainer's run within tests/test_torch_hybrid_trainer.py's
tolerances, a NaN step skipped on both sides.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.resilience import guards as Jg
from paddle_tpu.distributed.resilience import supervisor as Js
from paddle_tpu.profiler import metrics as Jm
from paddle_tpu_torch.distributed import store as Tst
from paddle_tpu_torch.distributed import watchdog as Twd
from paddle_tpu_torch.distributed.resilience import guards as Tg
from paddle_tpu_torch.distributed.resilience import supervisor as Ts
from paddle_tpu_torch.profiler import metrics as Tm

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_resilience_worker as rw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
W_TRUE = (np.arange(4, dtype=np.float64) + 1.0) / 4
TRAIN = ("train/steps", "train/anomalies", "train/skipped_batches",
         "train/rollbacks", "train/snapshots")


def _toy_batch(step):
    r = np.random.RandomState(500 + step)
    x = r.rand(8, 4)
    return x, x @ W_TRUE


def _make_train_fn(nan_steps=(), nan_once=True):
    fired = set()

    def train_fn(state, step, ctx):
        x, y = _toy_batch(step)
        err = x @ state["w"] - y
        grad = ctx.all_reduce(2.0 * x.T @ err / len(y), "avg")
        loss = float((err * err).mean())
        if step in nan_steps and (not nan_once or step not in fired):
            fired.add(step)
            loss = float("nan")
        return {"w": state["w"] - 0.1 * grad}, loss

    return train_fn


def _run(S, G, M, w0, num_steps, nan_steps=(), **cfg):
    guard = cfg.pop("guard", None)
    config = S.SupervisorConfig(world_size=1, **cfg,
                                **({"guard": G.GuardConfig(**guard)}
                                   if guard else {}))
    before = {k: M.counter(k).value for k in TRAIN}
    state, report = S.run_elastic(_make_train_fn(nan_steps),
                                  {"w": np.asarray(w0, np.float64)},
                                  config, num_steps=num_steps)
    return state, report, {k: M.counter(k).value - before[k]
                           for k in TRAIN}


def _same(j, t):
    (js, jr, jc), (ts, tr, tc) = j, t
    assert ts["w"].tobytes() == js["w"].tobytes()
    jl, tl = dict(jr), dict(tr)
    assert np.asarray(tl.pop("losses")).tobytes() == \
        np.asarray(jl.pop("losses")).tobytes()
    assert tl == jl
    assert tc == jc


@pytest.mark.parametrize("case", [
    dict(num_steps=8, snapshot_every=4),
    dict(num_steps=10, snapshot_every=4, nan_steps={5},
         guard=dict(max_consecutive=3, warmup_steps=100)),
    dict(num_steps=10, snapshot_every=2, nan_steps={5, 6},
         guard=dict(max_consecutive=2, warmup_steps=100))],
    ids=["clean", "nan_skip", "rollback"])
def test_toy_runs_equal_the_reference_bit_for_bit(case):
    j = _run(Js, Jg, Jm, np.zeros(4), **dict(case))
    t = _run(Ts, Tg, Tm, np.zeros(4), **dict(case))
    _same(j, t)
    report = t[1]
    if case.get("nan_steps") == {5}:
        assert report["skipped"] == 1 and np.isnan(report["losses"][5])
    if case.get("nan_steps") == {5, 6}:
        assert report["rollbacks"] == 1


def test_disk_tier_resume_equals_the_reference(tmp_path):
    out = []
    for S, G, M, tag in ((Js, Jg, Jm, "j"), (Ts, Tg, Tm, "t")):
        root = str(tmp_path / tag)
        first = _run(S, G, M, np.zeros(4), 6, snapshot_every=0,
                     ckpt_root=root, ckpt_every=3, keep=2)
        # "restart": a fresh supervisor from a wrong initial state
        second = _run(S, G, M, np.full(4, 99.0), 12, snapshot_every=0,
                      ckpt_root=root, ckpt_every=3, keep=2)
        out.append((first, second, sorted(os.listdir(root))))
    (j1, j2, jd), (t1, t2, td) = out
    _same(j1, t1)
    _same(j2, t2)
    assert td == jd == ["step_00000009", "step_00000012"]


def test_two_supervisors_form_a_group_and_clear_a_stale_mark():
    store = Tst.TCPStore("127.0.0.1", 0, is_master=True)
    store.set(Twd.unhealthy_key(0), json.dumps({"op": "all_reduce"}))
    c0 = Tm.counter("elastic/unhealthy_cleared").value
    results = {}

    def side(rank):
        cfg = Ts.SupervisorConfig(
            rank=rank, world_size=2, job_id=f"t2r{os.getpid()}",
            snapshot_every=2, replicate_async=True,
            transport_timeout_s=20.0, reform_timeout_s=20.0,
            guard=Tg.GuardConfig(warmup_steps=100))
        client = Tst.TCPStore("127.0.0.1", store.port, is_master=False)
        sup = Ts.Supervisor(cfg, store=client)
        state, report = sup.run(_make_train_fn(), {"w": np.zeros(4)},
                                num_steps=6)
        results[rank] = (state, report, dict(sup._replicas))

    th = threading.Thread(target=side, args=(1,), daemon=True)
    th.start()
    side(0)
    th.join(timeout=30)
    try:
        assert 0 in results and 1 in results
        assert results[0][0]["w"].tobytes() == results[1][0]["w"].tobytes()
        for rank, other in ((0, 1), (1, 0)):
            replicas = results[rank][2]
            assert (other, 6) in replicas, sorted(replicas)
            assert replicas[(other, 6)]["w"].tobytes() == \
                results[other][0]["w"].tobytes()
        assert Twd.read_unhealthy(store, 0) is None
        assert Tm.counter("elastic/unhealthy_cleared").value == c0 + 1
    finally:
        store.close()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_killed_rank_rejoins_from_the_ring_replica(tmp_path):
    port = _free_port()
    worker = str(ROOT / "tests" / "torch_resilience_worker.py")

    def spawn(rank, rejoin=False):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM="2",
                   PADDLE_MASTER=f"127.0.0.1:{port}",
                   PADDLE_STORE_TIMEOUT="60", RESILIENCE_MODE="elastic",
                   RESILIENCE_OUT_DIR=str(tmp_path), TOY_NAN_STEP="7",
                   WATCHDOG_TIMEOUT="2", REFORM_TIMEOUT="60",
                   PT_HOST_ID="localhost")
        env.pop("PT_FAULT_PLAN", None)
        env.pop("PT_SUPERVISOR_REJOIN", None)
        if rejoin:
            env["PT_SUPERVISOR_REJOIN"] = "1"
        elif rank == 1:
            env["PT_FAULT_PLAN"] = "kill@step#5:rank=1"
        return subprocess.Popen([sys.executable, worker], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    p0, p1 = spawn(0), spawn(1)
    p1b = None
    try:
        assert p1.wait(timeout=120) == 1, "the plan should kill rank 1"
        p1b = spawn(1, rejoin=True)
        out1 = p1b.communicate(timeout=120)[0].decode()
        out0 = p0.communicate(timeout=120)[0].decode()
    finally:
        for p in (p0, p1, p1b):
            if p is not None and p.poll() is None:
                p.kill()
    assert p0.returncode == 0 and p1b.returncode == 0, (out0, out1)
    data = {}
    for r in range(2):
        npz = dict(np.load(tmp_path / f"rank{r}.npz", allow_pickle=True))
        data[r] = {"w": npz["w"], "losses": npz["losses"],
                   "report": json.loads(str(npz["report"])),
                   "metrics": json.loads(str(npz["metrics"]))}
    for r in range(2):
        rep = data[r]["report"]
        assert rep["final_step"] == rw.TOY_STEPS, rep
        # the step-4 snapshot (snapshot_every 2, killed at step 4),
        # served from memory
        assert rep["recovery_sources"][0] == [4, "peer"], rep
    assert data[0]["report"]["restarts"] == 1
    w_ref, losses_ref = _toy_reference(skip_steps={7})
    for r in range(2):
        np.testing.assert_allclose(data[r]["w"], w_ref, rtol=1e-12,
                                   atol=1e-12)
    good = [s for s in range(rw.TOY_STEPS) if s != 7]
    assert np.isnan(data[0]["losses"][7])
    np.testing.assert_allclose(data[0]["losses"][good],
                               np.asarray(losses_ref)[good], rtol=1e-9)
    m0, m1 = data[0]["metrics"], data[1]["metrics"]
    assert m0["train/restarts"] >= 1
    assert m0["train/recovery_source/peer"] >= 1
    assert m1["train/recovery_source/peer"] >= 1
    assert m1.get("faults/injected", 0) == 0


def _toy_reference(num_steps=rw.TOY_STEPS, world=2, skip_steps=()):
    """tests/resilience_worker.py::toy_reference: per-rank gradients
    averaged as the transport's host reduce does."""
    w = np.zeros(rw.TOY_DIM, dtype=np.float64)
    losses = []
    for step in range(num_steps):
        parts = [rw.toy_grad_loss(w, step, r) for r in range(world)]
        grad = parts[0][0]
        for g, _ in parts[1:]:
            grad = np.add(grad, g)
        grad = grad / world
        losses.append(float(np.mean([loss for _, loss in parts])))
        if step in skip_steps:
            continue
        w = w - rw.TOY_LR * grad
    return w, losses


CFG = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
           num_hidden_layers=1, num_attention_heads=2,
           num_key_value_heads=2, max_position_embeddings=32,
           dtype="float32")
LR = 1e-2


def _trainer_batch(step):
    r = np.random.RandomState(77 + step)
    ids = r.randint(0, 64, (2, 8)).astype(np.int64)
    return ids, np.roll(ids, -1, 1)


def test_trainer_run_elastic_holds_to_the_reference(monkeypatch):
    import jax
    from jax.sharding import Mesh

    from paddle_tpu.distributed.fleet.trainer import HybridTrainer as JT
    from paddle_tpu.models import llama as JL
    from paddle_tpu_torch.distributed.fleet import HybridTrainer
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.utils import stacked_params_from_paddle_tpu

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                    ("dp", "pp", "sharding", "sep", "mp"))
        jt = JT(JL.LlamaConfig(**CFG), mesh, learning_rate=LR)
        tt = HybridTrainer(TL.LlamaConfig(**CFG), learning_rate=LR,
                           device="cpu")
        tt.load_elastic_state(jt.elastic_state())
        # the third step's loss is NaN once on both sides: SKIPped, its
        # update undone by on_restore
        for trainer in (jt, tt):
            orig, calls = trainer.step, []

            def step(ids, labels, orig=orig, calls=calls, trainer=trainer):
                loss = orig(ids, labels)
                calls.append(trainer.step_count)
                return torch.tensor(float("nan")) if len(calls) == 3 \
                    else loss

            monkeypatch.setattr(trainer, "step", step)
        out = []
        for trainer, S, G in ((jt, Js, Jg), (tt, Ts, Tg)):
            cfg = S.SupervisorConfig(world_size=1, snapshot_every=2,
                                     guard=G.GuardConfig(warmup_steps=100))
            state, report = trainer.run_elastic(_trainer_batch, num_steps=5,
                                                config=cfg)
            out.append((trainer.elastic_state(), report))
    finally:
        torch.set_num_threads(threads)
    (sj, rj), (st, rt) = out
    assert rt["final_step"] == rj["final_step"] == 5
    assert rt["skipped"] == rj["skipped"] == 1
    assert np.isnan(rt["losses"][2]) and np.isnan(rj["losses"][2])
    good = [0, 1, 3, 4]
    np.testing.assert_allclose(np.asarray(rt["losses"])[good],
                               np.asarray(rj["losses"])[good], rtol=1e-5)
    assert sorted(sj) == sorted(st) and int(st["step"]) == int(sj["step"])
    for key in sj:
        if key == "step":
            continue
        a = np.asarray(sj[key], np.float32)
        tol = 1e-4 * float(np.abs(a).max()) + (0.1 * LR if key[0] == "p"
                                               else 0.0)
        assert float(np.abs(st[key] - a).max()) <= tol, key
