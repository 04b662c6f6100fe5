"""The port's profiler package (paddle_tpu_torch.profiler) on the CPU,
against the JAX package's (paddle_tpu.profiler).

Held exactly (no tolerance: both sides run the same float arithmetic in
Python): the quantile digest's answers for one stream, its merge and its
dict round trip; the metrics registry's JSON snapshot (its "ts" and "pid"
aside) and Prometheus text for one sequence of counter, gauge and
histogram events, a child registry's roll-up included; and
``make_scheduler``'s states. The port alone: spans nest and carry one
trace id across ``inject``/``extract``, the ring exports chrome JSON, the
flight recorder dumps its ring and counter deltas; ``Profiler(targets=
[CPU])`` records ``RecordEvent`` spans through a scheduler and exports
them (with torch.profiler's own trace); ``Profiler()`` raises where CUDA
is missing, and the periodic flusher leaves a complete JSON snapshot.
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as J
import paddle_tpu_torch.profiler as T
from paddle_tpu.profiler import digest as Jd
from paddle_tpu.profiler import metrics as Jm
from paddle_tpu_torch.profiler import digest as Td
from paddle_tpu_torch.profiler import metrics as Tm
from paddle_tpu_torch.profiler import tracing as Tt


def _stream(seed, n):
    r = np.random.RandomState(seed)
    return np.concatenate([r.lognormal(1.0, 0.8, n),
                           r.uniform(0, 500, n // 4)]).tolist()


QS = (0.0, 0.01, 0.1, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


@pytest.mark.parametrize("compression", [16, 128])
def test_digest_quantiles_equal_the_reference(compression):
    a, b = _stream(0, 3000), _stream(1, 500)
    j1, t1 = Jd.QuantileDigest(compression), Td.QuantileDigest(compression)
    j2, t2 = Jd.QuantileDigest(compression), Td.QuantileDigest(compression)
    for v in a:
        j1.observe(v)
        t1.observe(v)
    j2.update_many(b)
    t2.update_many(b)
    assert t1.quantiles(QS) == j1.quantiles(QS)
    assert (t1.count, t1.min, t1.max, t1.size()) == \
        (j1.count, j1.min, j1.max, j1.size())
    j1.merge(j2)
    t1.merge(t2)
    assert t1.quantiles(QS) == j1.quantiles(QS)
    assert t1.to_dict() == j1.to_dict()
    # a dict of the reference's reads back as the reference reads it
    back = Td.QuantileDigest.from_dict(j1.to_dict())
    assert back.quantiles(QS) == \
        Jd.QuantileDigest.from_dict(j1.to_dict()).quantiles(QS)


def _feed(M):
    reg = M.MetricsRegistry()
    r = np.random.RandomState(3)
    for i in range(50):
        reg.counter("comm/all_reduce_count").inc()
        reg.counter("comm/all_reduce_bytes").inc(int(r.randint(1, 1 << 20)))
        reg.gauge("serving/batch_occupancy").set(float(i % 7) / 8)
        reg.histogram("train/step_ms").observe(float(r.lognormal(3, 1)))
        reg.histogram("comm/latency_ms", (0.5, 1.0, 5.0)).observe(
            float(r.uniform(0, 8)))
    kid = reg.child("replica0")
    kid.counter("serving/requests").inc(3)
    kid.histogram("serving/ttft_ms").observe(12.5)
    reg.gauge("elastic/last_beat_ts").inc(2)
    return reg


def _no_clock(snap):
    snap = dict(snap)
    snap.pop("ts")
    snap.pop("pid")
    return snap


def test_registry_json_and_prometheus_equal_the_reference():
    j, t = _feed(Jm), _feed(Tm)
    assert _no_clock(json.loads(t.to_json())) == \
        _no_clock(json.loads(j.to_json()))
    assert t.to_prometheus_text() == j.to_prometheus_text()
    jc, tc = j.children()["replica0"], t.children()["replica0"]
    assert _no_clock(tc.snapshot()) == _no_clock(jc.snapshot())
    assert t.histogram("train/step_ms").quantile(0.5) == \
        j.histogram("train/step_ms").quantile(0.5)


def test_periodic_flush_writes_a_complete_snapshot(tmp_path):
    reg = _feed(Tm)
    path = tmp_path / "m" / "metrics.json"
    reg.enable_periodic_flush(str(path), interval_s=0.05)
    try:
        reg.counter("train/steps").inc(7)
        for _ in range(100):
            if path.exists() and json.loads(path.read_text())[
                    "counters"].get("train/steps") == 7:
                break
            time.sleep(0.05)
        snap = json.loads(path.read_text())
    finally:
        reg.disable_periodic_flush()
    assert snap["counters"]["train/steps"] == 7
    assert snap["counters"]["comm/all_reduce_count"] == 50


@pytest.mark.parametrize("args", [(1, 1, 2, 0, 0), (2, 0, 3, 2, 1),
                                  (0, 1, 1, 0, 3)])
def test_make_scheduler_states_equal_the_reference(args):
    js, ts = J.make_scheduler(*args), T.make_scheduler(*args)
    assert [ts(s).name for s in range(20)] == [js(s).name for s in range(20)]
    assert [s.name for s in T.ProfilerState] == \
        [s.name for s in J.ProfilerState]


def test_spans_nest_and_travel_and_the_flight_recorder_dumps(tmp_path):
    Tt.clear_ring()
    with Tt.span("outer", step=1) as outer:
        with Tt.span("inner"):
            meta = Tt.inject({})
    spans = {s["name"]: s for s in Tt.ring_spans()}
    assert spans["inner"]["trace_id"] == spans["outer"]["trace_id"]
    assert spans["inner"]["parent_id"] == outer.ctx.span_id
    got = Tt.extract(meta)
    assert got.trace_id == outer.ctx.trace_id and Tt.extract({}) is None
    doc = Tt.export_chrome(str(tmp_path / "trace.json"))
    names = [e["name"] for e in doc["traceEvents"]]
    assert "outer" in names and "inner" in names
    rec = Tt.FlightRecorder(capacity=8)
    rec.configure(str(tmp_path / "flight"))
    Tm.counter("trace/test_counter").inc(2)
    rec.note("watchdog", op="all_reduce")
    path = rec.dump("test")
    dumped = json.loads(open(path).read())
    assert dumped["reason"] == "test"
    assert any(e["kind"] == "watchdog" for e in dumped["events"])


def test_cpu_profiler_records_record_event_spans(tmp_path):
    seen = []
    with T.Profiler(targets=[T.ProfilerTarget.CPU],
                    scheduler=T.make_scheduler(closed=1, ready=0, record=2,
                                               repeat=1),
                    on_trace_ready=lambda p: seen.append(p.step_num)) as prof:
        for i in range(4):
            with T.RecordEvent("train/step"):
                torch.ones(8).add_(i)
            prof.step()
    assert seen == [3]
    out = tmp_path / "trace.json"
    prof.export(str(out))
    trace = T.load_profiler_result(str(out))
    host = [e for e in trace["traceEvents"]
            if e.get("cat") == "host_span" and e["name"] == "train/step"]
    assert len(host) == 4
    # the recorded window's spans reached torch.profiler too
    annotated = [e for e in trace["traceEvents"]
                 if e.get("name") == "train/step"
                 and e.get("cat") != "host_span"]
    assert len(annotated) == 2
    assert "train/step" in prof.summary()
    assert not T.host_tracing_active()


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
def test_default_profiler_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Profiler()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Profiler(targets=[T.ProfilerTarget.CPU, T.ProfilerTarget.GPU])
    # timer_only traces nothing and needs no device
    T.Profiler(timer_only=True)
