"""The port's fleet serving tier (paddle_tpu_torch.inference: router,
disagg, fleet_supervisor) on the CPU in f32, against the reference's.

One JAX PagedCausalLM (vocab 256, hidden 64, 2 layers, block 8) is built
from a seed and its weights carried into the port
(``load_paddle_tpu_params``). The router's placement of every handle, its
reroute count and the greedy streams must equal the reference fleet's;
so must the supervisor's restarts, drained handles and migration/requeue
split under the same chaos plan. Sampled streams cannot equal the
reference's (the port's Gumbel noise is a hash, not threefry), so the
disaggregated, drained and migrated streams are held token for token to
the port's own uninterrupted single-engine runs: a moved request keeps its
origin (salt_seed, salt_rid).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as JF
from paddle_tpu.inference import fleet_supervisor as JFS
from paddle_tpu.inference import router as JR
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params
from paddle_tpu.profiler import metrics as JM

from paddle_tpu_torch.distributed.resilience import faults as TF
from paddle_tpu_torch.inference import disagg as TD
from paddle_tpu_torch.inference import fleet_supervisor as TFS
from paddle_tpu_torch.inference import router as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.profiler import metrics as TM
from paddle_tpu_torch.profiler import tracing as TT

BASE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=40,
            max_batch=4, max_blocks_per_seq=8, token_budget=32)
SP = TS.SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
REF = dict(S=JS, R=JR, FS=JFS, F=JF, M=JM)
PORT = dict(S=TS, R=TR, FS=TFS, F=TF, M=TM)


@pytest.fixture(autouse=True)
def _one_thread():
    # one PyTorch thread while a test runs (see test_torch_serving.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JF.disarm()
    TF.disarm()


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JS.PagedCausalLM(JS.PagedServingConfig(**BASE))
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu")
    tm.load_paddle_tpu_params(named)
    return {"ref": jm, "port": tm}


def _prompts(n, seed=0, lo=5, hi=30):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, size=int(rng.randint(lo, hi))).tolist()
            for _ in range(n)]


def _engine(P, model, seed, **over):
    cfg = P["S"].PagedServingConfig(**{**BASE, **over})
    kw = {"device": "cpu"} if P is PORT else {}
    eng = P["S"].ServingEngine.from_model(model, cfg, seed=seed, **kw)
    return eng


def _counter(P, name):
    return P["M"].registry().counter(name).value


def _router_run(P, model):
    engs = [_engine(P, model, 10, max_queue=1), _engine(P, model, 11)]
    router = P["R"].ReplicaRouter(
        [P["R"].Replica(e, name=f"r{i}") for i, e in enumerate(engs)])
    rr0 = _counter(P, "serving/reroutes")
    prompts = _prompts(6, seed=1)
    hs = [router.submit(p, max_new_tokens=6) for p in prompts[:4]]
    router.step_all()
    router.step_all()
    # placed on the live load scores after two steps
    hs += [router.submit(p, max_new_tokens=6) for p in prompts[4:]]
    res = router.run_to_completion()
    return {"placement": [router.placement(h) for h in hs],
            "reroutes": _counter(P, "serving/reroutes") - rr0,
            "results": [res[h] for h in hs]}


def test_router_placement_reroutes_and_greedy_streams_match_reference(
        models):
    ref = _router_run(REF, models["ref"])
    port = _router_run(PORT, models["port"])
    assert port == ref
    assert port["reroutes"] >= 3      # r0 holds one live request
    assert {name for name, _ in port["placement"]} == {"r0", "r1"}


def _supervised_run(P, model, plan, sampled=False, n=6):
    seeds = (20, 21)

    def factory(idx):
        return _engine(P, model, seeds[idx])

    engs = [factory(0), factory(1)]
    for i, e in enumerate(engs):
        e.fault_rank = i
    router = P["R"].ReplicaRouter(
        [P["R"].Replica(e, name=f"r{i}", restore_after=1)
         for i, e in enumerate(engs)])
    sup = P["FS"].FleetSupervisor(
        router, factory, P["FS"].FleetSupervisorConfig(backoff_base_s=0.0))
    c0 = {k: _counter(P, f"serving/{k}")
          for k in ("drains", "drain_requeues", "replica_restarts")}
    if plan:
        P["F"].arm(plan)
    try:
        hs = [router.submit(p, max_new_tokens=8,
                            sampling=SP if sampled and i % 2 else None)
              for i, p in enumerate(_prompts(n, seed=2))]
        res = router.run_to_completion()
    finally:
        P["F"].disarm()
    return {"results": [res[h] for h in hs],
            "restarts": list(sup.restarts),
            "drained": sorted(sup.drained_handles),
            "moved": sorted(router.moved_handles),
            "counts": {k: _counter(P, f"serving/{k}") - v
                       for k, v in c0.items()},
            "healthy": [r.healthy() for r in router.replicas]}


def test_supervisor_kill_drain_restart_matches_reference(models):
    plan = "kill@decode#3:rank=1"
    ref = _supervised_run(REF, models["ref"], plan)
    port = _supervised_run(PORT, models["port"], plan)
    assert port == ref
    assert port["restarts"] == [0, 1] and port["drained"]
    assert port["counts"]["replica_restarts"] == 1
    assert all(port["healthy"])


def test_supervisor_drain_keeps_sampled_streams(models):
    # sampled and greedy streams through a kill mid-decode equal an
    # uninterrupted run of the same fleet
    clean = _supervised_run(PORT, models["port"], None, sampled=True)
    killed = _supervised_run(PORT, models["port"], "kill@decode#3:rank=1",
                             sampled=True)
    assert killed["results"] == clean["results"]
    assert killed["restarts"] == [0, 1] and killed["counts"]["drains"] >= 1


def test_drop_at_migrate_falls_back_to_requeue(models):
    clean = _supervised_run(PORT, models["port"], None, sampled=True)
    dropped = _supervised_run(
        PORT, models["port"],
        "kill@decode#3:rank=1,drop@migrate%1.0:rank=1", sampled=True)
    assert dropped["results"] == clean["results"]
    assert dropped["counts"]["drains"] == 0
    assert dropped["counts"]["drain_requeues"] >= 1


def test_kill_at_prefill_requeues_and_restarts(models):
    clean = _supervised_run(PORT, models["port"], None, sampled=True)
    killed = _supervised_run(PORT, models["port"], "kill@prefill#1:rank=0",
                             sampled=True)
    assert killed["results"] == clean["results"]
    assert killed["restarts"] == [1, 0]
    assert killed["counts"]["drain_requeues"] >= 1


@pytest.mark.parametrize("quant", [None, "int8"])
def test_disaggregated_streams_equal_the_single_engine(models, quant):
    m = models["port"]
    over = {"cache_quant": quant} if quant else {}
    prompts = _prompts(5, seed=3, hi=40)
    sampling = [SP if i % 2 else None for i in range(len(prompts))]
    single = _engine(PORT, m, 4, **over)
    for p, sp in zip(prompts, sampling):
        single.add_request(p, max_new_tokens=9, sampling=sp)
    want = single.run_to_completion()
    tp = TFS.LoopbackTransport()
    pw = TD.PrefillWorker(_engine(PORT, m, 4, **over), tp, decode_rank=1)
    dw = TD.DecodeWorker(_engine(PORT, m, 77, **over), tp, prefill_rank=0)
    c0 = _counter(PORT, "serving/migrations")
    for p, sp in zip(prompts, sampling):
        pw.submit(p, max_new_tokens=9, sampling=sp)
    moved = pw.pump()
    local = dw.accept(len(moved))
    got = dw.run(window=4)
    assert len(moved) == len(prompts)
    assert [got[r] for r in local] == [want[r] for r in moved]
    assert _counter(PORT, "serving/migrations") - c0 == 2 * len(moved)
    # every page of the decode engine went back to its pool
    eng = dw.engine
    assert len(eng._free_pages) == eng.cfg.num_blocks - 1


def test_window_replays_after_a_migration_with_pools_written_in_place(
        models):
    m = models["port"]
    prompts = _prompts(3, seed=5, lo=9, hi=20)
    # the single-engine stream of the request that will migrate
    single = _engine(PORT, m, 4)
    single.add_request(prompts[0], max_new_tokens=10, sampling=SP)
    want = single.run_to_completion()[0]
    # the decode engine serves two requests of its own through a
    # (2 rows, sampled) decode window first
    dec = _engine(PORT, m, 9)
    for p in prompts[1:]:
        dec.add_request(p, max_new_tokens=4, sampling=SP)
    while any(r.length - r.cached != 1 for r in dec.pending()):
        dec.step()
    ptrs = [t.data_ptr() for t in (dec._kc, dec._vc)]
    dec.decode_run(2)
    (key, win), = dec._window_fns.items()
    assert key[0] == 2
    dec.step()                   # one request finishes, one stays
    # migrate in: the pages land in the same pool storage
    src = _engine(PORT, m, 4)
    rid = src.add_request(prompts[0], max_new_tokens=10, sampling=SP)
    while src._requests[rid].length - src._requests[rid].cached != 1:
        src.step()
    tp = TFS.LoopbackTransport()
    TD.migrate_request(src, rid, tp, dst=1)
    new = TD.receive_request(dec, tp, src=0)
    assert [t.data_ptr() for t in (dec._kc, dec._vc)] == ptrs
    while dec.pending():
        if not dec.decode_run(4):
            dec.step()
    # the migrated request decoded through the window made before it
    assert dec._window_fns[key] is win
    assert dec._requests[new].generated == want
    assert src._requests[rid].done and src.pending() == []


def test_request_spans_share_one_trace_across_a_migration(models):
    m = models["port"]
    TT.clear_ring()
    src = _engine(PORT, m, 4)
    rid = src.add_request(_prompts(1, seed=6)[0], max_new_tokens=5)
    while src._requests[rid].length - src._requests[rid].cached != 1:
        src.step()
    tp = TFS.LoopbackTransport()
    TD.migrate_request(src, rid, tp, dst=1)
    dst = _engine(PORT, m, 5)
    new = TD.receive_request(dst, tp, src=0)
    dst.run_to_completion()
    spans = [s for s in TT.ring_spans() if s["name"].startswith("serving::")]
    names = [s["name"] for s in spans]
    for want in ("serving::admit", "serving::queue", "serving::prefill",
                 "serving::migrate", "serving::migrate_in",
                 "serving::decode"):
        assert want in names, names
    assert len({s["trace_id"] for s in spans}) == 1
    assert dst._requests[new].salt_rid == rid
    assert dst._requests[new].salt_seed == src.seed


def test_requeue_info_carries_identity_and_trace(models):
    eng = _engine(PORT, models["port"], 3)
    rid = eng.add_request([1, 2, 3], max_new_tokens=4, sampling=SP)
    r = eng._requests[rid]
    r.salt_rid, r.salt_seed = 41, 7
    info = eng._requeue_info(r)
    assert (info["salt_rid"], info["salt_seed"]) == (41, 7)
    assert info["trace"] == r.trace.to_dict()
    # the salts follow the origin identity
    assert eng._salt(r, 2) == TS.sampling_salt(7, 41, 2)


def test_dead_engine_refuses_every_entry(models):
    from paddle_tpu_torch.distributed.resilience.errors import \
        EngineDeadError

    eng = _engine(PORT, models["port"], 3)
    eng.add_request([1, 2, 3], max_new_tokens=4)
    TF.arm("kill@prefill#1")
    with pytest.raises(EngineDeadError):
        eng.step()
    TF.disarm()
    # consulted before any page was taken
    assert len(eng._free_pages) == eng.cfg.num_blocks - 1
    for call in (eng.step, lambda: eng.decode_run(2),
                 lambda: eng.add_request([1], max_new_tokens=1),
                 lambda: eng.probe_logits([1, 2])):
        with pytest.raises(EngineDeadError):
            call()
