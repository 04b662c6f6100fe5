"""The port's fault tolerance on the CPU, against the JAX package's:
the chaos plan DSL and injector (paddle_tpu_torch.distributed.resilience.
faults), the numerical StepGuard (guards.py), the CRC/ACK tensor
transport (transport.py), the comm watchdog (watchdog.py) and the comm
records of collective.py.

Held exactly to the reference: ``parse_plan``'s rules and normal form
(and its refusals), the injector's decisions over one event stream
(probability rules included, per seed), StepGuard's verdicts, reasons,
streaks and loss EMA on the same loss streams, and, for the chaos plan
"drop, corrupt, dup, delay" on an in-process transport pair of each
package, every all_reduce's result and the retry, redial, corrupt- and
duplicate-frame counters. The port's transport carries torch tensors
(bf16 arrives as bf16; its f32-widened sum equals the reference's) and
talks to the reference's over the one wire format. One 2-process world
(tests/torch_resilience_worker.py "kill") shows a rank killed
mid-collective: the survivor's watchdog marks ``__unhealthy__/0`` and
raises CommTimeoutError within its timeout. One 1-process gloo world
("group_abort") has no transport, as an NCCL trainer: the watchdog marks
the launcher's store, aborts the group's process group, and the group's
next collective raises.
"""
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import store as Js
from paddle_tpu.distributed import transport as Jtr
from paddle_tpu.distributed.resilience import faults as Jf
from paddle_tpu.distributed.resilience import guards as Jg
from paddle_tpu.profiler import metrics as Jm
from paddle_tpu_torch.distributed import store as Ts
from paddle_tpu_torch.distributed import transport as Ttr
from paddle_tpu_torch.distributed import watchdog as Twd
from paddle_tpu_torch.distributed.resilience import faults as Tf
from paddle_tpu_torch.distributed.resilience import guards as Tg
from paddle_tpu_torch.distributed.resilience.errors import CommTimeoutError
from paddle_tpu_torch.profiler import metrics as Tm

ROOT = Path(__file__).resolve().parents[1]

PLANS = [
    "seed=9,drop@send#2,corrupt@send#4:rank=1:peer=0,"
    "delay@recv#1:ms=250,kill@send#3:code=7,dup@send%0.5",
    "kill@step#5:rank=1,delay@save#1:ms=10",
    "kill@host#1:host=host1,partition@dial#1:rank=1",
    "seed=7,drop@send%0.05;overload@admit#1:x=8",
    "sigkill@replica#4:rank=1,hang@replica#2",
    "drop@migrate#1,kill@cache_save#1,corrupt@publish#2",
]
BAD = ["boom@send#1", "drop@nowhere#1", "drop#1", "drop@send#1:wat=2",
       "drop@step#1", "overload@send#1", "sigkill@send#1",
       "partition@send#1"]


@pytest.mark.parametrize("spec", PLANS)
def test_parse_plan_equals_the_reference(spec):
    j, t = Jf.parse_plan(spec), Tf.parse_plan(spec)
    assert t.describe() == j.describe() and t.seed == j.seed
    assert [vars(r) for r in t.rules] == [vars(r) for r in j.rules]


@pytest.mark.parametrize("spec", BAD)
def test_parse_plan_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as je:
        Jf.parse_plan(spec)
    with pytest.raises(ValueError) as te:
        Tf.parse_plan(spec)
    assert str(te.value) == str(je.value)


def _events():
    r = np.random.RandomState(4)
    sites = ["send", "recv", "dial", "step", "save", "host"]
    for _ in range(300):
        site = sites[r.randint(len(sites))]
        host = ["host0", "host1"][r.randint(2)] if site == "host" else None
        yield site, int(r.randint(2)), int(r.randint(2)), host


@pytest.mark.parametrize("spec", [
    "seed=3,drop@send%0.2,dup@send%0.1:rank=1,corrupt@recv%0.3:peer=0",
    "drop@send#3,delay@send#5:ms=20,kill@step#2:rank=0:code=9,"
    "partition@dial#2",
    "kill@host#2:host=host1,delay@save#1"])
def test_injector_decisions_equal_the_reference(spec):
    ji, ti = Jf.FaultInjector(), Tf.FaultInjector()
    ji.arm(spec)
    ti.arm(spec)

    def act(a):
        return None if a is None else (a.kind, a.delay_ms, a.exit_code,
                                       a.factor)

    for site, rank, peer, host in _events():
        assert act(ti.on_event(site, rank, peer, host=host)) == \
            act(ji.on_event(site, rank, peer, host=host))
    assert ti.counts() == ji.counts()
    assert ti.felled_hosts() == ji.felled_hosts()


def _loss_streams():
    r = np.random.RandomState(11)
    smooth = list(1.0 / (1 + np.arange(30)) + r.rand(30) * 0.01)
    spiky = list(r.rand(40) + 1.0)
    for i in (8, 9, 20, 33):
        spiky[i] = 50.0 * spiky[i]
    bad = list(r.rand(20) + 0.5)
    for i, v in ((3, math.nan), (4, math.inf), (5, math.nan),
                 (6, -math.inf), (12, math.nan)):
        bad[i] = v
    arrays = [np.asarray([0.5, 0.25]), np.asarray([0.5, np.inf]),
              np.asarray(0.75), np.asarray([np.nan])]
    return [("smooth", smooth, None), ("spiky", spiky, None),
            ("bad", bad, [None, math.inf] * 10), ("arrays", arrays, None)]


@pytest.mark.parametrize("cfg", [dict(), dict(max_consecutive=2,
                                             warmup_steps=2,
                                             spike_factor=5.0),
                                 dict(max_consecutive=3, warmup_steps=100)])
def test_step_guard_verdicts_equal_the_reference(cfg):
    for _, losses, norms in _loss_streams():
        jg = Jg.StepGuard(Jg.GuardConfig(**cfg))
        tg = Tg.StepGuard(Tg.GuardConfig(**cfg))
        for i, loss in enumerate(losses):
            gn = None if norms is None else norms[i]
            assert tg.observe(loss, grad_norm=gn) == \
                jg.observe(loss, grad_norm=gn)
            assert (tg.last_reason, tg.consecutive, tg.anomalies,
                    tg.ema, tg.steps_seen) == \
                (jg.last_reason, jg.consecutive, jg.anomalies, jg.ema,
                 jg.steps_seen)
    # the port's guard also judges torch losses
    tg = Tg.StepGuard(Tg.GuardConfig())
    assert tg.observe(torch.tensor(0.5)) == Tg.OK
    assert tg.observe(torch.tensor([1.0, float("nan")])) == Tg.SKIP
    a = {"w": torch.arange(6, dtype=torch.bfloat16)}
    assert Tg.grad_checksum(a) == Tg.grad_checksum(
        {"w": torch.arange(6, dtype=torch.bfloat16)})
    assert Tg.grad_checksum({"w": np.arange(4, dtype=np.float32)}) == \
        Jg.grad_checksum({"w": np.arange(4, dtype=np.float32)})


def _pair(S, TR):
    store = S.TCPStore("127.0.0.1", 0, is_master=True)
    t0 = TR.TensorTransport(0, 2, store, bind_host="127.0.0.1",
                            timeout=15.0, ack_timeout=3.0)
    t1 = TR.TensorTransport(1, 2, store, bind_host="127.0.0.1",
                            timeout=15.0, ack_timeout=3.0)
    return store, t0, t1


def _both(fn0, fn1):
    out = {}

    def side(r, fn):
        out[r] = fn()

    th = threading.Thread(target=side, args=(1, fn1), daemon=True)
    th.start()
    side(0, fn0)
    th.join(timeout=30)
    assert not th.is_alive()
    return out[0], out[1]


COUNTERS = ("faults/injected", "faults/drop", "faults/corrupt",
            "faults/dup", "faults/delay", "comm/retries", "comm/redials",
            "comm/corrupt_frames", "comm/dup_frames")
# rank 0's data-frame send attempts: #1 drop (-> retry = #2), #3 corrupt
# (-> NAK, retry = #4), #5 dup, #6 delay — one fault class a collective
CHAOS = ("drop@send#1:rank=0,corrupt@send#3:rank=0,"
         "dup@send#5:rank=0,delay@send#6:rank=0:ms=50")


def _chaos_run(S, TR, F, M):
    store, t0, t1 = _pair(S, TR)
    before = {k: M.counter(k).value for k in COUNTERS}
    F.arm(CHAOS)
    try:
        results = []
        for i in range(4):
            results.append(_both(
                lambda: t0.all_reduce(np.arange(8, dtype=np.float32)
                                      + 10 + i, "sum", [0, 1], 0),
                lambda: t1.all_reduce(np.arange(8, dtype=np.float32)
                                      + 20 + i, "sum", [0, 1], 0)))
    finally:
        F.disarm()
        t0.close()
        t1.close()
        store.close()
    return results, {k: M.counter(k).value - before[k] for k in COUNTERS}


def test_transport_chaos_results_and_counters_equal_the_reference():
    jres, jcount = _chaos_run(Js, Jtr, Jf, Jm)
    tres, tcount = _chaos_run(Ts, Ttr, Tf, Tm)
    for i, ((j0, j1), (t0, t1)) in enumerate(zip(jres, tres)):
        want = 2 * np.arange(8, dtype=np.float32) + 30 + 2 * i
        for got in (j0, j1, t0, t1):
            np.testing.assert_array_equal(got, want)
    assert tcount == jcount
    assert tcount["faults/injected"] == 4 and tcount["comm/retries"] >= 2


def test_transport_carries_torch_tensors_and_talks_to_the_reference():
    store, t0, t1 = _pair(Ts, Ttr)
    try:
        x0 = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
        x1 = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
        b0, b1 = x0.to(torch.bfloat16), x1.to(torch.bfloat16)
        r0, r1 = _both(lambda: t0.all_reduce(b0, "avg", [0, 1], 0),
                       lambda: t1.all_reduce(b1, "avg", [0, 1], 0))
        want = ((b0.float() + b1.float()) / 2).to(torch.bfloat16)
        for r in (r0, r1):
            assert r.dtype == torch.bfloat16
            assert torch.equal(r, want)
        g0, g1 = _both(lambda: t0.all_gather(x0, [0, 1], 0),
                       lambda: t1.all_gather(x1, [0, 1], 0))
        for g in (g0, g1):
            assert torch.equal(g[0], x0) and torch.equal(g[1], x1)
        t0.send(torch.tensor([], dtype=torch.int64), 1)
        assert t1.recv(0).shape == (0,)
    finally:
        t0.close()
        t1.close()
        store.close()
    # a port rank and a reference rank on one store
    import ml_dtypes

    store = Js.TCPStore("127.0.0.1", 0, is_master=True)
    tp = Ttr.TensorTransport(0, 2, store, bind_host="127.0.0.1",
                             timeout=15.0, ack_timeout=3.0)
    jp = Jtr.TensorTransport(1, 2, store, bind_host="127.0.0.1",
                             timeout=15.0, ack_timeout=3.0)
    try:
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        tp.send(a, 1)
        np.testing.assert_array_equal(jp.recv(0), a)
        jp.send(a.astype(ml_dtypes.bfloat16), 0)
        got = tp.recv(1)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, torch.from_numpy(a).to(torch.bfloat16))
        tp.send(torch.from_numpy(a).to(torch.bfloat16), 1)
        back = jp.recv(0)
        assert back.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(back.astype(np.float32), a)
    finally:
        tp.close()
        jp.close()
        store.close()


def test_watchdog_escalation_aborts_member_and_marks_store(monkeypatch):
    store, t0, t1 = _pair(Ts, Ttr)
    monkeypatch.setattr(Ttr, "_transport", t1)
    e0 = Tm.counter("comm/watchdog_escalations").value
    mgr = Twd.CommTaskManager()
    mgr.enable(0.5)
    try:
        mgr.start_task("all_reduce", 7, [0, 1], rank=1)
        caught = []

        def blocked():
            try:
                t1.recv(0)
            except BaseException as e:
                caught.append(e)

        th = threading.Thread(target=blocked, daemon=True)
        th.start()
        th.join(timeout=10)
        assert caught and isinstance(caught[0], CommTimeoutError)
        assert caught[0].op == "all_reduce" and caught[0].group_id == 7
        assert Tm.counter("comm/watchdog_escalations").value >= e0 + 1
        dump = json.loads(store.get_nowait("__unhealthy__/7"))
        assert dump["op"] == "all_reduce"
        assert Twd.clear_unhealthy(store, 7) is True
        assert Twd.read_unhealthy(store, 7) is None
    finally:
        mgr.disable()
        t0.close()
        t1.close()
        store.close()


class _Probe:
    """A stand-in for a CUDA event (``query``) or a torch Work
    (``is_completed``), flipped by the test."""

    def __init__(self, attr):
        self.ready = False
        setattr(self, attr, lambda: self.ready)


@pytest.mark.parametrize("attr", ["query", "is_completed"])
def test_comm_records_count_and_the_watchdog_polls_without_blocking(attr):
    from paddle_tpu_torch.distributed import collective as C

    c0 = Tm.counter("comm/all_reduce_count").value
    b0 = Tm.counter("comm/all_reduce_bytes").value
    rec = C.record_collective("all_reduce", 0, [0], torch.ones(4, 2))
    rec.issued(torch.ones(4, 2))            # a CPU collective: done
    assert Tm.counter("comm/all_reduce_count").value == c0 + 1
    assert Tm.counter("comm/all_reduce_bytes").value == b0 + 32
    mgr = Twd.comm_task_manager
    mgr.escalate = False
    mgr.enable(60.0)
    try:
        rec = C.record_collective("broadcast", 3, [0, 1], torch.ones(2))
        probe = _Probe(attr)
        rec.issued(None, probe)            # watched through its probe
        assert rec.task is not None and not rec.task.poll()
        assert rec.task in mgr.pending()
        probe.ready = True
        assert rec.task.poll() and rec.task not in mgr.pending()
        assert mgr.group_stats()[3]["broadcast"]["count"] >= 1
    finally:
        mgr.disable()
        mgr.escalate = True
    # with the watchdog off a record holds no task
    assert C.record_collective("barrier", 0, [0]).task is None


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_killed_rank_escalates_on_the_survivor(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM="2",
                   PADDLE_MASTER=f"127.0.0.1:{port}",
                   PADDLE_STORE_TIMEOUT="60", RESILIENCE_MODE="kill",
                   RESILIENCE_OUT_DIR=str(tmp_path), WATCHDOG_TIMEOUT="2",
                   PT_FAULT_PLAN="kill@send#2:rank=1")
        procs.append(subprocess.Popen(
            [sys.executable,
             str(ROOT / "tests" / "torch_resilience_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode())
    assert procs[1].returncode == 1, outs[1]         # the plan's kill
    assert procs[0].returncode == 0, outs[0]
    marker = json.loads((tmp_path / "rank0.json").read_text())
    assert marker["error"] == "CommTimeoutError", (marker, outs[0])
    assert 1.5 < marker["elapsed"] < 10.0
    assert marker["op"] == "ar_sum"
    assert marker["unhealthy"]["op"] == "ar_sum"
    assert not (tmp_path / "rank1.json").exists()


def test_watchdog_escalation_without_transport_marks_and_aborts(tmp_path):
    store = Ts.TCPStore("127.0.0.1", 0, is_master=True)
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1",
                   PADDLE_MASTER=f"127.0.0.1:{store.port}",
                   RESILIENCE_MODE="group_abort",
                   RESILIENCE_OUT_DIR=str(tmp_path))
        env.pop("PADDLE_TRAINER_ENDPOINTS", None)
        p = subprocess.run(
            [sys.executable,
             str(ROOT / "tests" / "torch_resilience_worker.py")],
            env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stdout + p.stderr
        marker = json.loads((tmp_path / "rank0.json").read_text())
        gid = marker["gid"]
        assert gid != 0 and marker["transport"] is False
        assert marker["error"] == "CommTimeoutError", (marker, p.stderr)
        assert marker["op"] == "all_reduce" and marker["group_id"] == gid
        assert marker["aborted_after_s"] < 5.0
        c = marker["counters"]
        assert c.get("comm/watchdog_escalations") == 1
        assert c.get("comm/pg_aborts") == 1
        assert "comm/escalation_store_errors" not in c
        assert "comm/escalation_errors" not in c
        # the group's own mark, and the world's, which the launcher reads
        for key in (gid, 0):
            dump = Twd.read_unhealthy(store, key)
            assert dump["op"] == "all_reduce" and dump["group_id"] == gid
    finally:
        store.close()


def test_guard_installs_the_tensor_checker_on_the_op_funnel():
    """check_numerics=True puts amp.debugging's checker on the funnel for
    the guarded region: an eager op with a non-finite output raises
    FloatingPointError there (the reference's
    tests/test_supervisor.py:86-103)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import debugging as dbg

    g = Tg.StepGuard(Tg.GuardConfig(check_numerics=True))
    assert dbg._checker is None
    x = paddle.to_tensor(np.asarray([-1.0, 4.0], np.float32), place="cpu")
    with g:
        assert dbg._checker.debug_mode == \
            dbg.DebugMode.CHECK_NAN_INF_AND_ABORT
        assert float(paddle.log(x[1:]).numpy()[0]) == \
            float(np.log(np.float32(4.0)))
        with pytest.raises(FloatingPointError, match="NaN"):
            paddle.log(x)
    assert dbg._checker is None
    paddle.log(x)                       # uninstalled: no raise
    assert dbg.nonfinite_counts(torch.tensor([1.0, float("inf")])) == (0, 1)


def test_publish_chaos_site_and_the_serving_series():
    """The engine's ``publish`` chaos site (reference serving.py:1134-1152)
    and the serving/* series it writes: a corrupted transfer fails its CRC
    check, a kill fells the engine, a clean one commits and moves the
    weight-version gauge."""
    from paddle_tpu_torch.distributed.resilience.errors import (
        EngineDeadError, WeightTransferError)
    from paddle_tpu_torch.inference import serving as TS
    from paddle_tpu_torch.inference.weight_publish import build_weight_set

    cfg = TS.PagedServingConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=2, ffn_size=64, block_size=8, num_blocks=48,
        max_batch=3, max_blocks_per_seq=6, token_budget=32)
    model = TS.PagedCausalLM(cfg, device="cpu", seed=3)
    params = {k: v.detach().numpy() for k, v in model.named_parameters()}
    names = ("serving/requests", "serving/tokens_generated",
             "serving/steps", "serving/weight_swaps")
    before = {k: Tm.counter(k).value for k in names}
    eng = TS.ServingEngine.from_model(model, cfg, device="cpu")
    eng.add_request([1, 2, 3, 4], max_new_tokens=3)
    eng.run_to_completion()
    arrays, crcs = build_weight_set(model, params, cfg)
    Tf.arm("corrupt@publish#1,kill@publish#2")
    try:
        with pytest.raises(WeightTransferError, match="CRC"):
            eng.stage_weight_set(1, arrays, crcs)
        with pytest.raises(EngineDeadError, match="publish"):
            eng.stage_weight_set(1, arrays, crcs)
        assert eng.dead
    finally:
        Tf.disarm()
    eng = TS.ServingEngine.from_model(model, cfg, device="cpu")
    eng.stage_weight_set(1, arrays, crcs)
    eng.commit_weight_set(1)
    got = {k: Tm.counter(k).value - before[k] for k in names}
    assert got["serving/requests"] == 1
    assert got["serving/tokens_generated"] == 3
    assert got["serving/steps"] >= 1 and got["serving/weight_swaps"] == 1
    assert Tm.gauge("serving/weight_version").value == 1
    assert Tm.histogram("serving/ttft_ms").count >= 1
