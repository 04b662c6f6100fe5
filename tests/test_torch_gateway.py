"""The port's FleetGateway (paddle_tpu_torch.inference.gateway) over a
ReplicaRouter of CPU engines, held to the reference's gateway.

The same arrival script goes to both fleets (vocab 256, hidden 64, 2
layers, f32, block 8; the reference's weights carried into the port). The
gateway's token buckets read one shared fake clock a side, the SLO
classes carry no wall-clock deadline, and the brownout ladder reads the
replicas' load scores, so both sides decide on identical inputs: every
admission, throttle, shed and brownout level, every reason-coded outcome
event and every greedy stream must be equal. Tenant starvation and the
retry budget's veto are checked on the port alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import errors as JE
from paddle_tpu.distributed.resilience import faults as JF
from paddle_tpu.inference import gateway as JG
from paddle_tpu.inference import router as JR
from paddle_tpu.inference import serving as JS
from paddle_tpu.jit.functional import current_params
from paddle_tpu.profiler import metrics as JM

from paddle_tpu_torch.distributed.resilience import errors as TE
from paddle_tpu_torch.distributed.resilience import faults as TF
from paddle_tpu_torch.inference import gateway as TG
from paddle_tpu_torch.inference import router as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.profiler import metrics as TM

BASE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, ffn_size=128, block_size=8, num_blocks=40,
            max_batch=4, max_blocks_per_seq=8, token_budget=32)
REF = dict(S=JS, R=JR, G=JG, E=JE, F=JF, M=JM)
PORT = dict(S=TS, R=TR, G=TG, E=TE, F=TF, M=TM)


class Clock:
    def __init__(self, t=100.0):
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
    paddle.seed(21)
    jm = JS.PagedCausalLM(JS.PagedServingConfig(**BASE))
    jm.eval()
    named = {k: np.asarray(v) for k, v in current_params(jm).items()}
    tm = TS.PagedCausalLM(TS.PagedServingConfig(**BASE), device="cpu")
    tm.load_paddle_tpu_params(named)
    return {"ref": jm, "port": tm}


def _fleet(P, model, n=2, **over):
    cfg = P["S"].PagedServingConfig(**{**BASE, **over})
    kw = {"device": "cpu"} if P is PORT else {}
    engs = [P["S"].ServingEngine.from_model(model, cfg, seed=30 + i, **kw)
            for i in range(n)]
    return P["R"].ReplicaRouter(
        [P["R"].Replica(e, name=f"r{i}") for i, e in enumerate(engs)])


def _classes(G):
    return {"interactive": G.SLOClassConfig(deadline_s=None, priority=0,
                                            protected=True),
            "batch": G.SLOClassConfig(deadline_s=None, priority=1,
                                      deferrable=True),
            "best_effort": G.SLOClassConfig(deadline_s=None, priority=2,
                                            sheddable=True)}


def _prompt(i, n=None):
    rng = np.random.RandomState(100 + i)
    return rng.randint(1, 250, size=n or int(rng.randint(6, 24))).tolist()


def _counter(P, name):
    return P["M"].registry().counter(name).value


COUNTERS = ("gateway/admitted", "gateway/throttled", "gateway/shed",
            "gateway/clamped", "gateway/deferrals", "gateway/storm_injected",
            "gateway/retry_budget_denied", "serving/reroutes")


def _storm_run(P, model):
    """Two tenants and three classes against a 2-replica fleet whose
    engines hold 3 live requests each, under a 3x overload storm: the
    ladder climbs, sheds best effort, clamps and defers batch, then
    unwinds."""
    G = P["G"]
    clock = Clock()
    router = _fleet(P, model, max_queue=3)
    cfg = G.GatewayConfig(
        classes=_classes(G),
        tenants={"acme": G.TenantConfig(rate=1.0, burst=1.0),
                 "beta": G.TenantConfig(rate=50.0, burst=50.0, weight=2.0)},
        brownout=G.BrownoutConfig(enter_load=0.9, exit_load=0.5,
                                  hysteresis=2, clamp_max_new=3))
    gw = G.FleetGateway(router, cfg, clock=clock)
    events, submits, levels = [], [], []
    gw.outcome_listeners.append(events.append)
    c0 = {k: _counter(P, k) for k in COUNTERS}
    P["F"].arm("overload@admit%1.0:x=3")
    script = [("acme", "interactive"), ("beta", "batch"),
              ("acme", "batch"), ("beta", "best_effort"),
              ("acme", "interactive"), ("acme", "interactive"),
              ("beta", "interactive"), ("acme", "best_effort")]
    for step in range(40):
        if step < 16:
            tenant, slo = script[step % len(script)]
            try:
                t = gw.submit(_prompt(step), max_new_tokens=6,
                              tenant=tenant, slo=slo)
                submits.append(("ok", t))
            except P["E"].GatewayRejectedError as e:
                submits.append((e.reason, e.tenant, e.slo_class,
                                round(e.retry_after_s, 9)))
        if step == 16:
            P["F"].disarm()
        clock.t += 0.25
        gw.step()
        levels.append(gw.brownout.level)
        if step >= 16 and not gw.queued() and not router._live_pending():
            break
    for _ in range(8):                 # idle pumps: the ladder unwinds
        clock.t += 0.25
        gw.pump()
        levels.append(gw.brownout.level)
    P["F"].disarm()
    return {"submits": submits, "levels": levels,
            "transitions": gw.brownout.transitions,
            "max_level": gw.brownout.max_level,
            "events": events, "results": gw.results(),
            "rejected": {t: e.reason for t, e in gw.rejected().items()},
            "shed_by_class": gw.shed_by_class,
            "infos": {t: {k: v for k, v in gw.ticket_info(t).items()
                          if k not in ("submit_t", "first_tok_t",
                                       "rejected")}
                      for t in gw._tickets},
            "counters": {k: _counter(P, k) - v for k, v in c0.items()}}


def test_gateway_decisions_and_streams_match_reference(models):
    ref = _storm_run(REF, models["ref"])
    port = _storm_run(PORT, models["port"])
    # ttft_ms in the outcome events is wall time on each side
    for run in (ref, port):
        for ev in run["events"]:
            ev["ttft_ms"] = ev["ttft_ms"] is not None
    assert port == ref
    reasons = {s[0] for s in port["submits"]}
    assert "tenant_rate" in reasons
    assert port["max_level"] >= TG.L_SHED
    assert port["levels"][-1] == TG.L_NORMAL
    assert port["counters"]["gateway/storm_injected"] == 32
    assert port["shed_by_class"].get("best_effort", 0) > 0
    assert {ev["outcome"] for ev in port["events"]} >= {
        "completed", "shed", "rejected"}


def _starvation_run(model, with_burst):
    """Tenant A (weight 10): 4 interactive requests, two a step. Tenant B:
    a burst of 12 short batch requests at once, before A's first, its
    bucket sized so two thirds of it throttle. The fleet holds 8 live
    requests (2 engines, max_queue = max_batch = 4): the bucket leaves A
    its slots, and weighted-fair dispatch gives A the first of them.
    Returns the step of each A request's first token, B's throttle count
    and the results."""
    G = TG
    clock = Clock()
    router = _fleet(PORT, model, max_queue=4)
    cfg = G.GatewayConfig(
        classes=_classes(G),
        tenants={"A": G.TenantConfig(rate=100.0, burst=100.0, weight=10.0),
                 "B": G.TenantConfig(rate=0.5, burst=4.0)},
        brownout=G.BrownoutConfig(enter_load=9.0))     # ladder off
    gw = G.FleetGateway(router, cfg, clock=clock)
    throttled = 0
    if with_burst:
        for i in range(12):
            try:
                gw.submit(_prompt(50 + i, n=4), max_new_tokens=8,
                          tenant="B", slo="batch")
            except TE.GatewayRejectedError as e:
                assert e.reason == "tenant_rate"
                throttled += 1
    a_tickets, first = [], {}
    for step in range(200):
        if step < 2:
            for j in range(2):
                a_tickets.append(gw.submit(
                    _prompt(2 * step + j, n=10), max_new_tokens=6,
                    tenant="A", slo="interactive"))
        clock.t += 0.1
        for t, toks in gw.step().items():
            if toks and t not in first:
                first[t] = step
        if step >= 2 and not gw.queued() and not router._live_pending():
            break
    return [first[t] for t in a_tickets], throttled, gw.results()


def test_burst_tenant_does_not_starve_the_polite_one(models):
    alone, _, _ = _starvation_run(models["port"], False)
    burst, throttled, res = _starvation_run(models["port"], True)
    assert throttled == 8
    # every A request's first token at most one step after A alone
    assert all(b <= a + 1 for a, b in zip(alone, burst)), (alone, burst)
    assert len(res) == 4 + 12 - throttled      # every admission finished
    assert all(len(v) > 0 for v in res.values())


def test_retry_budget_vetoes_reroutes(models):
    # a fleet of two engines that hold one live request each, behind a
    # gateway whose retry budget starts and stays dry: a shed on the
    # first replica may not reroute to the second
    for P in (REF, PORT):
        G = P["G"]
        router = _fleet(P, models["ref" if P is REF else "port"],
                        max_queue=1)
        gw = G.FleetGateway(router, G.GatewayConfig(
            classes=_classes(G), retry_floor=0.0, retry_deposit=0.0,
            free_redispatches=1), clock=Clock())
        d0 = _counter(P, "gateway/retry_budget_denied")
        r0 = _counter(P, "serving/reroutes")
        ts = [gw.submit(_prompt(i), max_new_tokens=3) for i in range(3)]
        gw.pump()
        placed = [gw.ticket_info(t)["handle"] for t in ts]
        # one lands on each replica; the third is shed by its first
        # choice and its reroute vetoed, so it waits in the queue
        assert placed[:2] == [0, 1] and placed[2] is None
        assert _counter(P, "serving/reroutes") - r0 == 1
        assert _counter(P, "gateway/retry_budget_denied") - d0 == 1
        gw.run_to_completion()
        rej = {t: e.reason for t, e in gw.rejected().items()}
        assert set(rej.values()) <= {"retry_budget"}
        assert set(gw.results()) | set(rej) == set(ts)


def test_token_bucket_retry_budget_and_ladder_units():
    for P in (REF, PORT):
        G = P["G"]
        clock = Clock(0.0)
        b = G.TokenBucket(2.0, 3.0, clock=clock)
        takes = [b.try_take() for _ in range(4)]
        assert takes == [True, True, True, False]
        assert b.time_to() == pytest.approx(0.5)
        clock.t += 0.5
        assert b.try_take() and not b.try_take()
        rb = G.RetryBudget(cap=1.0, deposit=0.4, floor=0.5)
        seq = [rb.take()]
        for _ in range(4):
            rb.deposit()
        seq += [rb.take(), rb.take(), rb.balance()]
        assert seq == [False, True, False, pytest.approx(0.0)]
        bc = G.BrownoutController(G.BrownoutConfig(enter_load=1.0,
                                                   exit_load=0.5,
                                                   hysteresis=2))
        lv = [bc.observe(x) for x in (1.2, 1.3, 0.7, 0.4, 0.3, 0.2, 0.1,
                                      1.1, 1.1, 1.1, 1.1, 1.1)]
        assert lv == [1, 2, 2, 2, 1, 1, 0, 1, 2, 3, 4, 4]
