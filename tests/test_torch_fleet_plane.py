"""The profiler's serving plane in the port (paddle_tpu_torch.profiler:
timeline, aggregate, slo, headroom) held to the reference's modules.

Each case feeds the same metric, event and outcome sequence, under one
shared fake clock a side, to the reference and to the port, and compares
what each decides and reports: windows, rates and percentiles, the crash
spill, the fleet aggregator's merges and straggler report, the SLO
tracker's attainment and burn alerts, and the scale advisor's advice.
Decisions must be equal and numbers equal within 1e-12 relative.
"""
import math
import threading

import numpy as np
import pytest

from paddle_tpu.inference import fleet_supervisor as RFS
from paddle_tpu.profiler import aggregate as RA
from paddle_tpu.profiler import headroom as RH
from paddle_tpu.profiler import metrics as RM
from paddle_tpu.profiler import slo as RS
from paddle_tpu.profiler import timeline as RT

from paddle_tpu_torch.inference import fleet_supervisor as TFS
from paddle_tpu_torch.profiler import aggregate as TA
from paddle_tpu_torch.profiler import headroom as TH
from paddle_tpu_torch.profiler import metrics as TM
from paddle_tpu_torch.profiler import slo as TS
from paddle_tpu_torch.profiler import timeline as TT

REF = dict(M=RM, T=RT, A=RA, S=RS, H=RH, FS=RFS)
PORT = dict(M=TM, T=TT, A=TA, S=TS, H=TH, FS=TFS)
RTOL = 1e-12


class Clock:
    """A fake clock the test advances; every decision-making object of a
    side reads this one."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _close(a, b, path="$"):
    """Equal structure; floats within RTOL relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300), \
                (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _traffic(seed=0, n=12):
    """A seeded per-window sequence of (latencies, completions, load,
    brownout level, events)."""
    rng = np.random.RandomState(seed)
    out = []
    for w in range(n):
        lat = (rng.lognormal(3.0, 0.6, size=5 + w) * (1 + (w > 6))).tolist()
        out.append({"lat": lat, "done": int(rng.randint(1, 9)),
                    "load": float(rng.uniform(0.05, 0.3) if w < 4
                                  else rng.uniform(0.8, 1.4) if w < 8
                                  else rng.uniform(0.05, 0.2)),
                    "brown": 1 if w in (6, 7) else 0,
                    "events": [("replica_demoted", {"replica": f"r{w % 2}"})]
                    if w % 3 == 0 else []})
    return out


def _timeline_run(P, spill_dir):
    clock = Clock()
    reg = P["M"].MetricsRegistry()
    tl = P["T"].Timeline(registry=reg, clock=clock, capacity=8,
                         spill_dir=spill_dir)
    P["T"].install(tl)
    try:
        out = {"rates": [], "p95": [], "p50_all": [], "series": None}
        for w in _traffic():
            for v in w["lat"]:
                reg.histogram("serving/ttft_ms").observe(v)
            reg.counter("gateway/outcome/completed").inc(w["done"])
            reg.gauge("gateway/load_score").set(w["load"])
            for kind, payload in w["events"]:
                P["T"].emit_event(kind, **payload)
            clock.t += 5.0
            tl.sample()
            out["rates"].append(tl.rate("gateway/outcome/completed",
                                        window_s=12.0))
            out["p95"].append(tl.percentile("serving/ttft_ms", 0.95,
                                            window_s=12.0))
            out["p50_all"].append(tl.percentile("serving/ttft_ms", 0.5))
        out["series"] = tl.series("gateway/load_score", window_s=20.0)
        out["events"] = tl.events(kind="replica_demoted")
        out["windows"] = [{k: w[k] for k in ("seq", "t", "counters",
                                             "gauges", "events")}
                          for w in tl.windows()]
        out["recent"] = tl.recent(3)
        out["rate_at"] = tl.rate("gateway/outcome/completed", window_s=10.0,
                                 now=clock.t - 10.0)
        out["spill"] = [{k: w[k] for k in ("seq", "t", "counters",
                                           "events")}
                        for w in P["T"].load_spill(spill_dir)]
    finally:
        P["T"].uninstall(tl)
    return out


def test_timeline_windows_rates_percentiles_and_spill(tmp_path):
    ref = _timeline_run(REF, str(tmp_path / "ref"))
    port = _timeline_run(PORT, str(tmp_path / "port"))
    _close(ref, port)
    # the ring kept its capacity, the spill every window
    assert len(port["windows"]) == 8 and len(port["spill"]) == 12
    assert [w["seq"] for w in port["spill"]] == list(range(1, 13))
    assert port["rates"][0] is None and port["rates"][1] > 0
    assert len(port["events"]) == 2        # those the ring still holds


def test_load_spill_ignores_the_unpublished_tail(tmp_path):
    for P, d in ((REF, tmp_path / "r"), (PORT, tmp_path / "p")):
        clock = Clock()
        reg = P["M"].MetricsRegistry()
        tl = P["T"].Timeline(registry=reg, clock=clock, spill_dir=str(d))
        for _ in range(3):
            reg.counter("c").inc()
            clock.t += 1.0
            tl.sample()
        # a torn line after the last manifest publish, and no manifest at
        # all for a second directory
        with open(d / P["T"].SPILL_FILE, "a") as f:
            f.write('{"seq": 4, "t": 10')
        assert [w["seq"] for w in P["T"].load_spill(str(d))] == [1, 2, 3]
        (tmp_path / "none").mkdir(exist_ok=True)
        assert P["T"].load_spill(str(tmp_path / "none")) == []


def _aggregate_run(P):
    clock = Clock(50.0)
    agg = P["A"].FleetAggregator(clock=clock)
    rng = np.random.RandomState(4)
    for i in range(4):
        reg = P["M"].MetricsRegistry()
        for v in rng.lognormal(2.0 + (i == 2), 0.4, size=40):
            reg.histogram("train/step_ms").observe(float(v))
            reg.histogram("serving/ttft_ms").observe(float(v) * 3)
        reg.counter("serving/tokens_generated").inc(100 + i)
        reg.gauge("serving/batch_occupancy").set(0.25 * i)
        col = P["A"].MetricsCollector(None, 0, host_id=f"h{i // 2}",
                                      replica=f"r{i}", registry=reg)
        snap = col.snapshot()
        for k in ("ts", "pid"):
            snap.pop(k, None)
        agg.ingest(snap)
        clock.t += 10.0
    fleet = agg.fleet_snapshot()
    fleet.pop("ts")
    for rep in fleet["replicas"].values():
        rep.pop("ts", None)
        rep.pop("pid", None)
    return {"fleet": fleet,
            "p95": agg.percentile("serving/ttft_ms", 0.95),
            "p95_r1": agg.percentile("serving/ttft_ms", 0.95, "h0", "r1"),
            "straggler": agg.straggler_report("train/step_ms", 1.2),
            "evicted": agg.evict_stale(15.0),
            "keys": agg.keys()}


def test_fleet_aggregator_merges_and_straggler_report():
    ref, port = _aggregate_run(REF), _aggregate_run(PORT)
    _close(ref, port)
    assert port["straggler"]["stragglers"] == ["h1/r2"]
    assert port["fleet"]["n_replicas"] == 4
    assert port["fleet"]["fleet"]["counters"][
        "serving/tokens_generated"] == 406
    # ingested at t = 50, 60, 70, 80; read at 90 with a 15 s budget
    assert [list(k) for k in port["evicted"]] == [["h0", "r0"], ["h0", "r1"],
                                                  ["h1", "r2"]]


def test_metrics_collector_over_loopback_and_clock_offset():
    # the port's collector over the port's loopback transport: what the
    # aggregator ingests is the publishing registry's snapshot
    reg = TM.MetricsRegistry()
    reg.histogram("serving/ttft_ms").observe(12.5)
    tp = TFS.LoopbackTransport()
    col = TA.MetricsCollector(tp, 1, host_id="h0", replica="r0",
                              registry=reg)
    sent = col.publish()
    agg = TA.FleetAggregator()
    assert agg.poll(tp, 0) == ("h0", "r0")
    assert agg.replica_snapshot("h0", "r0")["histograms"] == \
        sent["histograms"]
    # NTP-style offset against a peer whose clock runs 2.5 s ahead
    tp = TFS.LoopbackTransport()
    th = threading.Thread(target=TA.serve_clock, args=(tp, 0),
                          kwargs={"n": 4, "skew_s": 2.5})
    th.start()
    off = TA.estimate_clock_offset(tp, 1, n=4)
    th.join(10)
    assert abs(off - 2.5) < 0.05


def _slo_events(seed=2):
    rng = np.random.RandomState(seed)
    evs = []
    for step in range(60):
        burst = 20 <= step < 30
        for _ in range(3):
            tenant = ["acme", "beta"][rng.randint(2)]
            slo = ["interactive", "batch"][rng.randint(2)]
            if burst and slo == "batch":
                outcome = ["shed", "deadline_missed", "completed"][
                    rng.randint(3)]
            else:
                outcome = "completed" if rng.rand() > 0.02 else "drained"
            evs.append((step, {"tenant": tenant, "slo": slo,
                               "outcome": outcome,
                               "ttft_ms": float(rng.uniform(20, 260)),
                               "reason": outcome,
                               "synthetic": bool(rng.rand() < 0.1)}))
    return evs


def _slo_run(P):
    clock = Clock()
    tr = P["S"].SLOTracker(
        class_objectives={"interactive": P["S"].SLOObjective(0.99,
                                                             ttft_ms=200),
                          "batch": P["S"].SLOObjective(0.9)},
        clock=clock, fast_window_s=10, slow_window_s=60,
        burn_threshold=3.0, clear_after=3)
    active, step = [], 0
    for s, ev in _slo_events():
        while step < s:
            step += 1
            clock.t += 1.0
            active.append([a.to_dict() for a in tr.evaluate()])
        tr.record(ev)
    return {"active": active, "alerts": [a.to_dict() for a in tr.alerts],
            "att": [tr.attainment(t, c) for t in ("acme", "beta")
                    for c in ("interactive", "batch")],
            "att_window": tr.attainment(slo="batch", window_s=15.0),
            "report": tr.report()}


def test_slo_tracker_attainment_and_burn_alerts():
    ref, port = _slo_run(REF), _slo_run(PORT)
    _close(ref, port)
    raised = [a for a in port["alerts"] if a["slo_class"] == "batch"]
    assert raised and all(not a["active"] for a in raised)


def _advisor_run(P):
    clock = Clock()
    reg = P["M"].MetricsRegistry()
    tl = P["T"].Timeline(registry=reg, clock=clock)
    tr = P["S"].SLOTracker(clock=clock, fast_window_s=10, slow_window_s=60)
    adv = P["H"].ScaleAdvisor(tl, tracker=tr, window_s=15.0,
                              min_windows=3)
    out = []
    for w in _traffic(seed=5, n=14):
        reg.counter("gateway/outcome/completed").inc(w["done"])
        reg.gauge("gateway/load_score").set(w["load"])
        reg.gauge("gateway/brownout_level").set(w["brown"])
        clock.t += 5.0
        tl.sample()
        out.append(adv.recommend(
            replica_loads={"r0": w["load"] / 2, "r1": w["load"] / 4,
                           "r2": w["load"] / 8}).to_dict())
    return {"advice": out, "curve": adv.curve(),
            "saturation": list(adv.saturation())}


def test_scale_advisor_recommendations():
    ref, port = _advisor_run(REF), _advisor_run(PORT)
    _close(ref, port)
    acts = [a["action"] for a in port["advice"]]
    assert "scale_up" in acts and "scale_down" in acts


@pytest.mark.parametrize("mod", ["timeline", "aggregate", "slo",
                                 "headroom"])
def test_public_names_match_the_reference(mod):
    import importlib

    ref = importlib.import_module(f"paddle_tpu.profiler.{mod}")
    port = importlib.import_module(f"paddle_tpu_torch.profiler.{mod}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in ref.__all__:
        assert hasattr(port, name), name
