"""The port's AutoScaler (paddle_tpu_torch.inference.autoscaler) over a
live CPU fleet, held to the reference's decisions.

Both packages run the same script (vocab 256, hidden 64, 2 layers, f32,
block 8; the reference's weights carried into the port): a 2-replica
fleet publishes weight version 1, a request storm scales it up through
``InProcessReplicaFactory`` (the first spawn killed by ``kill@spawn#1``,
retried after a backoff; every replica that joins is caught up to version
1 first), then the calm scales it down, each retiring replica drained
first. The advisor's timeline and the scaler read one
shared fake clock a side. The decision history (action, reason, size and
the rest of each record), the greedy streams and the replicas' weight
versions must equal the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as JF
from paddle_tpu.inference import autoscaler as JA
from paddle_tpu.inference import fleet_supervisor as JFS
from paddle_tpu.inference import router as JR
from paddle_tpu.inference import serving as JS
from paddle_tpu.inference import weight_publish as JP
from paddle_tpu.jit.functional import current_params
from paddle_tpu.profiler import headroom as JH
from paddle_tpu.profiler import metrics as JM
from paddle_tpu.profiler import timeline as JT

from paddle_tpu_torch.distributed.resilience import faults as TF
from paddle_tpu_torch.inference import autoscaler as TA
from paddle_tpu_torch.inference import fleet_supervisor as TFS
from paddle_tpu_torch.inference import router as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference import weight_publish as TP
from paddle_tpu_torch.profiler import headroom as TH
from paddle_tpu_torch.profiler import metrics as TM
from paddle_tpu_torch.profiler import timeline as TT

BASE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=40,
            max_batch=4, max_blocks_per_seq=8, token_budget=32)
REF = dict(S=JS, R=JR, FS=JFS, A=JA, P=JP, H=JH, M=JM, T=JT, F=JF)
PORT = dict(S=TS, R=TR, FS=TFS, A=TA, P=TP, H=TH, M=TM, T=TT, F=TF)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JF.disarm()
    TF.disarm()


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JS.PagedCausalLM(JS.PagedServingConfig(**BASE))
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu")
    tm.load_paddle_tpu_params(named)
    rng = np.random.RandomState(9)
    v1 = {k: (v + rng.normal(0.0, 0.05 * (np.std(v) + 1e-6), v.shape)
              ).astype(np.float32) for k, v in sorted(named.items())}
    return {"ref": jm, "port": tm, "v1": v1}


def _prompt(i):
    rng = np.random.RandomState(200 + i)
    return rng.randint(1, 250, size=int(rng.randint(6, 20))).tolist()


def _scale_run(P, model, v1, plan, spawn_fails=False, scale=True):
    cfg = P["S"].PagedServingConfig(**BASE)
    kw = {"device": "cpu"} if P is PORT else {}

    def engine(seed):
        return P["S"].ServingEngine.from_model(model, cfg, seed=seed, **kw)

    router = P["R"].ReplicaRouter(
        [P["R"].Replica(engine(10 + i), name=f"r{i}") for i in range(2)])
    sup = P["FS"].FleetSupervisor(
        router, lambda idx: engine(10 + idx),
        P["FS"].FleetSupervisorConfig(backoff_base_s=0.0))
    pub = P["P"].WeightPublisher(router, model, supervisor=sup)
    pub.publish(params=v1)
    clock = Clock()
    reg = P["M"].MetricsRegistry()
    tl = P["T"].Timeline(registry=reg, clock=clock)
    adv = P["H"].ScaleAdvisor(tl, window_s=30.0, min_windows=2,
                              high_load=0.6, low_load=0.3)
    factory = P["A"].InProcessReplicaFactory(model, cfg, seed_base=100,
                                             **kw)
    if spawn_fails:
        factory.build = _failing(factory.build)
    sc = P["A"].AutoScaler(
        router, sup, adv, factory,
        P["A"].AutoScalerConfig(min_replicas=2, max_replicas=4,
                                scale_up_after=2, scale_down_after=2,
                                cooldown_evals=1, max_spawn_failures=2,
                                spawn_backoff_base_s=0.0),
        publisher=pub, clock=clock)
    load = reg.gauge("gateway/load_score")

    def tick():
        reps = [r for r in router._snapshot() if r.placeable()]
        load.set(sum(r.load_score() for r in reps) / max(len(reps), 1))
        clock.t += 5.0
        tl.sample()
        if scale:
            sc.evaluate()
        router.step_all()

    handles, versions = [], []
    if plan:
        P["F"].arm(plan)
    try:
        for i in range(6):               # the storm
            handles.append(router.submit(_prompt(i), max_new_tokens=8))
        for _ in range(6):
            tick()
        versions.append([r.engine.active_weight_version
                         for r in router.replicas if not r.retired])
        for i in range(6, 8):            # late arrivals, then the calm
            handles.append(router.submit(_prompt(i), max_new_tokens=8))
        for _ in range(30):
            tick()
    finally:
        P["F"].disarm()
    res = router.run_to_completion()
    return {"history": sc.history, "spawn_failures": sc.spawn_failures,
            "size": router.fleet_size(), "versions": versions,
            "names": [r.name for r in router.replicas],
            "retired": [r.retired for r in router.replicas],
            "results": [res[h] for h in handles],
            "lost": [h for h in handles if len(res[h]) != 8]}


def _failing(build):
    """A factory whose first build raises (a spawn that never came up)."""
    state = {"n": 0}

    def wrapped(slot):
        state["n"] += 1
        if state["n"] == 1:
            from paddle_tpu_torch.inference.autoscaler import SpawnError
            raise SpawnError("first spawn refused")
        return build(slot)
    return wrapped


def test_decisions_match_reference_under_spawn_and_retire_chaos(models):
    plan = "kill@spawn#1,kill@retire#1"
    ref = _scale_run(REF, models["ref"], models["v1"], plan)
    port = _scale_run(PORT, models["port"], models["v1"], plan)
    assert port == ref
    acts = [h["action"] for h in port["history"]]
    assert "scale_up" in acts and "scale_down" in acts
    # the killed spawn was swept and retried; each joiner on version 1
    assert port["spawn_failures"] >= 1
    assert all(v == 1 for vs in port["versions"] for v in vs)
    assert len(port["versions"][0]) > 2
    # drain before retirement: nothing lost, the fleet back at its floor
    assert port["lost"] == [] and port["size"] == 2
    ups = [h for h in port["history"] if h["action"] == "scale_up"]
    assert ups[0]["attempts"] == 2       # one kill, then the retry


def test_streams_equal_a_fixed_fleet(models):
    # the resizes move no token: the same requests through the scaled
    # fleet and through a fixed 2-replica fleet that never resizes
    scaled = _scale_run(PORT, models["port"], models["v1"],
                        "kill@spawn#1,kill@retire#1")
    fixed = _scale_run(PORT, models["port"], models["v1"], None,
                       scale=False)
    assert fixed["history"] == [] and fixed["size"] == 2
    assert scaled["results"] == fixed["results"]


def test_failed_spawn_backs_off_and_retries(models):
    out = _scale_run(PORT, models["port"], models["v1"], None,
                     spawn_fails=True)
    ups = [h for h in out["history"] if h["action"] == "scale_up"]
    assert out["spawn_failures"] >= 1 and ups[0]["attempts"] == 2
    assert out["lost"] == []
