"""Process-isolated replicas in the port (paddle_tpu_torch.inference:
replica_host, the child; remote_replica, the parent), on the CPU.

One SubprocessReplicaFactory spawns one pair of CPU children
(``"device": "cpu"`` in their spec) for the whole file, in one test that
walks their life: the framed RPC surface (admit, step, results, probe,
salt pinning, a weight rollout staged over the transport), heartbeats, a
child-to-child KV migration, SIGSTOP and SIGCONT, a SIGKILL that the
parent infers from missed beats (its requests requeued onto the other
child, the dead one respawned on a fresh rank), and a teardown that leaves
no child behind. Every stream equals an in-process engine's over the same
weights (drawn from ``model_seed`` by the model's own generator) under the
same sampling identity, token for token. The unit tests around it hold
``classify_exit``, ``sweep_orphans``, the wire encoding and the fault
sites to the reference's.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference import remote_replica as JRR
from paddle_tpu.inference import replica_host as JRH

from paddle_tpu_torch.distributed.resilience import faults
from paddle_tpu_torch.inference import remote_replica as RR
from paddle_tpu_torch.inference import replica_host as RH
from paddle_tpu_torch.inference.fleet_supervisor import (
    FleetSupervisor, FleetSupervisorConfig)
from paddle_tpu_torch.inference.router import ReplicaRouter
from paddle_tpu_torch.inference.serving import (PagedCausalLM,
                                                PagedServingConfig,
                                                SamplingParams,
                                                ServingEngine)
from paddle_tpu_torch.inference.weight_publish import WeightPublisher

BASE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=40,
            max_batch=4, max_blocks_per_seq=8, token_budget=32)
MODEL_SEED = 3
SP = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
# the children beat every 0.2 s; 50 missed beats (10 s) declare one dead,
# generous for a loaded CPU box; the child the test stops or kills gets
# 10 (2 s) just before, to keep the test quick
HB = dict(hb_interval_s=0.2, hb_miss_n=50)


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    faults.disarm()


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, size=int(rng.randint(5, 20))).tolist()
            for _ in range(n)]


def _reference(prompts, keys, max_new, sampling, params=None):
    """The streams an in-process engine gives each prompt under sampling
    identity (salt_seed 0, salt_rid key), over the children's weights (or
    ``params``)."""
    cfg = PagedServingConfig(**BASE)
    model = PagedCausalLM(cfg, device="cpu", seed=MODEL_SEED)
    if params is not None:
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(torch.as_tensor(params[k]))
    eng = ServingEngine.from_model(model, cfg, seed=99, device="cpu")
    rids = []
    for p, k, sp in zip(prompts, keys, sampling):
        rid = eng.add_request(p, max_new_tokens=max_new, sampling=sp)
        eng._requests[rid].salt_rid, eng._requests[rid].salt_seed = k, 0
        rids.append(rid)
    out = eng.run_to_completion()
    return [out[r] for r in rids], eng


def _submit(router, prompts, keys, max_new, sampling):
    hs = []
    for p, k, sp in zip(prompts, keys, sampling):
        h = router.submit(p, max_new_tokens=max_new, sampling=sp)
        idx, rid = router._handles[h]
        r = router.replicas[idx].engine._requests[rid]
        r.salt_rid, r.salt_seed = k, 0     # forwarded before the next step
        hs.append(h)
    return hs


def _drive(router, until, timeout=60.0):
    """Step the fleet on the wall clock (heartbeat inference is timed)."""
    t0 = time.monotonic()
    while not until():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("the fleet did not get there in time")
        router.step_all()
        time.sleep(0.01)


def _counter(name):
    from paddle_tpu_torch.profiler import metrics

    return metrics.registry().counter(name).value


def _wait(pred, timeout=20.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.05)
    return True


def test_subprocess_fleet_lifecycle(tmp_path):
    pid_dir = str(tmp_path / "pids")
    factory = RR.SubprocessReplicaFactory(
        BASE, model_seed=MODEL_SEED, seed_base=100, pid_dir=pid_dir,
        device="cpu", ack_timeout=5, rpc_timeout=120, spawn_timeout=180,
        store_timeout=120, **HB)
    try:
        reps = [factory.build(slot) for slot in range(2)]
        router = ReplicaRouter(reps)
        sup = FleetSupervisor(router, factory.make_engine_factory(),
                              FleetSupervisorConfig(backoff_base_s=0.0))
        a, b = (r.engine for r in reps)
        assert {a.hello["device"], b.hello["device"]} == {"cpu"}
        assert a.child_rank == 1 and b.child_rank == 2
        assert a.pid != b.pid and RR._pid_alive(a.pid)

        # 1. the RPC surface: streams equal the in-process engine's
        prompts = _prompts(4, seed=1)
        keys = [10, 11, 12, 13]
        sampling = [None, SP, None, SP]
        want, ref_eng = _reference(prompts, keys, 8, sampling)
        hs = _submit(router, prompts, keys, 8, sampling)
        assert {router._handles[h][0] for h in hs} == {0, 1}
        res = router.run_to_completion()
        assert [res[h] for h in hs] == want
        np.testing.assert_array_equal(a.probe_logits([3, 4, 5]),
                                      ref_eng.probe_logits([3, 4, 5]))
        # heartbeats: fresh, counted, carrying the child's gauges
        assert _wait(lambda: (a.poll_heartbeats(), a._last_beat_n)[1] > 2)
        assert a.beat_age() <= a.beat_budget() and a.process_healthy()
        assert len(a._free_pages) == BASE["num_blocks"] - 1

        # 2. a weight rollout staged over the transport into both children
        rng = np.random.RandomState(7)
        model = PagedCausalLM(PagedServingConfig(**BASE), device="cpu",
                              seed=MODEL_SEED)
        v1 = {k: (p.detach().numpy() + rng.normal(
            0, 0.05 * (float(p.detach().std()) + 1e-6), tuple(p.shape))
                  ).astype(np.float32) for k, p in model.named_parameters()}
        rep = WeightPublisher(router, model, supervisor=sup).publish(
            params=v1)
        assert rep.committed == [a.name, b.name] and rep.missed == []
        assert [e.active_weight_version for e in (a, b)] == [1, 1]
        want1, ref1 = _reference(prompts[:2], [20, 21], 6, [SP, None],
                                 params=v1)
        np.testing.assert_array_equal(b.probe_logits([3, 4, 5]),
                                      ref1.probe_logits([3, 4, 5]))

        # 3. a child-to-child KV migration: drain a live replica
        hs = _submit(router, prompts[:2], [20, 21], 6, [SP, None])
        _drive(router, lambda: all(
            router.replicas[router._handles[h][0]].engine._requests[
                router._handles[h][1]].generated for h in hs))
        on_a = sum(router._handles[h][0] == 0 for h in hs)
        d0 = _counter("serving/drains")
        moved = sup.drain(0)
        # every live request of child a shipped its pages to child b
        assert moved == on_a >= 1 and _counter("serving/drains") - d0 == on_a
        assert all(router._handles[h][0] == 1 for h in hs)
        res = router.run_to_completion()
        assert [res[h] for h in hs] == want1

        # 4. SIGSTOP: the beats stop, the probe fails; SIGCONT: they return
        b._hb_miss = 10
        os.kill(b.pid, signal.SIGSTOP)
        try:
            assert _wait(lambda: not b.process_healthy(), 15.0)
        finally:
            os.kill(b.pid, signal.SIGCONT)
        assert _wait(lambda: b.process_healthy(), 15.0)

        # 5. SIGKILL mid-decode: inferred from missed beats, its requests
        # requeued onto the other child, the dead one respawned
        prompts = _prompts(4, seed=2)
        keys = [30, 31, 32, 33]
        sampling = [SP, None, SP, None]
        want, _ = _reference(prompts, keys, 10, sampling, params=v1)
        hs = _submit(router, prompts, keys, 10, sampling)
        _drive(router, lambda: any(
            router.replicas[i].engine._requests[r].generated
            for i, r in (router._handles[h] for h in hs)))
        victim = router.replicas[1].engine
        t_kill = time.monotonic()
        faults.arm(f"sigkill@replica#1:rank={victim.child_rank}")
        _drive(router, lambda: not router._live_pending()
               and sup.restarts[1] == 1, timeout=90.0)
        detect_s = time.monotonic() - t_kill
        assert victim.death["reason"] == "missed_heartbeats"
        assert victim.death["exit_class"] == "killed"
        assert not RR._pid_alive(victim.pid)
        assert victim.beat_budget() <= detect_s < 60.0
        res = router.run_to_completion()
        assert [res[h] for h in hs] == want
        fresh = router.replicas[1].engine
        assert fresh is not victim and fresh.child_rank == 3
        assert fresh.active_weight_version == 1      # caught up at restart
        assert _wait(lambda: (router.replicas[1].probe(),
                              router.replicas[1].healthy())[1], 15.0)
    finally:
        factory.close()
    # 6. teardown: no child, no PID file left
    assert RR.sweep_orphans(pid_dir) == []
    assert [f for f in os.listdir(pid_dir) if f.endswith(".pid")] == []
    for eng in (a, b, fresh):
        assert eng.proc.poll() is not None


def test_child_engine_defaults_to_cuda():
    spec = {"cfg": dict(BASE), "model_seed": 1, "engine_seed": 0}
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        RH._build_engine(spec)
    eng = RH._build_engine(dict(spec, device="cpu", name="n0"))
    assert eng.device.type == "cpu" and eng.name == "n0"
    assert RH._warm(eng) >= 0.0 and eng.pending() == [] \
        and eng._next_rid == 0


@pytest.mark.parametrize("rc,oom", [(0, None), (-9, 0), (-9, 950),
                                    (-15, None), (3, None), (None, 10)])
def test_classify_exit_matches_reference(rc, oom):
    assert RR.classify_exit(rc, oom) == JRR.classify_exit(rc, oom)


@pytest.mark.parametrize("doc", [{"op": "step"}, {"ok": 1, "rid": 3,
                                                  "x": [1.5, None]},
                                 {"op": "hello", "name": "proc0",
                                  "pending": 0, "done": [1, 2]}])
def test_wire_encoding_matches_reference(doc):
    assert RH.encode(doc).tobytes() == JRH.encode(doc).tobytes()
    assert RH.decode(JRH.encode(doc)) == doc
    assert (RH.DEFAULT_HB_INTERVAL, RH.DEFAULT_HB_MISS) == \
        (JRH.DEFAULT_HB_INTERVAL, JRH.DEFAULT_HB_MISS)
    assert [RH.REQ_CHANNEL, RH.RSP_CHANNEL, RH.HB_CHANNEL,
            RH.WEIGHT_CHANNEL, RH.MIGRATE_CHANNEL, RH.SPEC_ENV] == \
        [JRH.REQ_CHANNEL, JRH.RSP_CHANNEL, JRH.HB_CHANNEL,
         JRH.WEIGHT_CHANNEL, JRH.MIGRATE_CHANNEL, JRH.SPEC_ENV]


def test_sweep_orphans_kills_only_children_of_dead_parents(tmp_path):
    # a parent that already exited, and its still running child
    dead_parent = subprocess.Popen([sys.executable, "-c", "pass"])
    dead_parent.wait()
    orphan = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
    mine = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        for name, pid, ppid in (("replica_r1.pid", orphan.pid,
                                 dead_parent.pid),
                                ("replica_r2.pid", mine.pid, os.getpid())):
            with open(tmp_path / name, "w") as f:
                json.dump({"pid": pid, "ppid": ppid, "rank": 1}, f)
        (tmp_path / "junk.pid").write_text("not json")
        assert RR.sweep_orphans(str(tmp_path)) == [orphan.pid]
        assert orphan.wait(10) == -signal.SIGKILL
        assert mine.poll() is None
        assert sorted(os.listdir(tmp_path)) == ["junk.pid",
                                                "replica_r2.pid"]
    finally:
        for p in (orphan, mine):
            if p.poll() is None:
                p.kill()
                p.wait()


def test_replica_fault_sites_parse():
    from paddle_tpu.distributed.resilience import faults as JF

    for plan in ("sigkill@replica#1:rank=1,hang@replica#2",
                 "kill@spawn#1,delay@retire#1:ms=5",
                 "kill@decode#2:rank=1,drop@migrate%1.0:rank=1"):
        assert faults.parse_plan(plan).describe() == \
            JF.parse_plan(plan).describe()
    for bad in ("drop@replica#1", "sigkill@send#1", "drop@spawn#1"):
        with pytest.raises(ValueError):
            faults.parse_plan(bad)
        with pytest.raises(ValueError):
            JF.parse_plan(bad)
