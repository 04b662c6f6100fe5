"""Worker process hosting one ServingEngine behind the CRC/ACK
TensorTransport — the child half of process-isolated replicas (port of
paddle_tpu/inference/replica_host.py).

The parent (``remote_replica.SubprocessReplicaFactory``) starts
``python -m paddle_tpu_torch.inference.replica_host`` in a fresh
interpreter with a JSON spec in ``PT_REPLICA_SPEC`` and the usual
``PADDLE_*`` transport env; the child builds the engine (a torch
``ServingEngine.from_model`` over a ``PagedCausalLM`` drawn from the
spec's ``model_seed``, on the spec's ``device``: "cuda" when the spec
names none, which raises on a host without a card), warms it (the first
call builds or loads the kernels), then sends its hello, answers framed
RPCs, and beats a heartbeat the parent's liveness inference runs on.

Protocol (all frames are uint8-encoded JSON unless noted):

- ``rh_req`` parent->child: one JSON doc per RPC, ``{"op": ...}``.
- ``rh_rsp`` child->parent: exactly one reply per RPC, in order.
  ``{"ok": 1, ...}`` or ``{"err": "<kind>", "msg": ...}`` — the parent
  maps ``err`` kinds back onto the engine's exception taxonomy.
- ``rh_hb``  child->parent: heartbeat beats at
  ``PT_REPLICA_HEARTBEAT_INTERVAL`` seconds (default 0.25), each
  carrying live gauges (pending, free pages, active weight version,
  ``/proc/self/oom_score``).  Liveness is INFERRED by the parent from
  beat staleness — a SIGSTOPped child looks exactly like a dead one
  until a SIGCONT resumes its beats.
- ``rh_w``   parent->child: raw weight-set frames
  (``weight_publish.send_weight_set`` wire format) announced by a
  ``stage_weights`` RPC.
- ``rh_mig`` child->child: KV hand-off frames (``disagg`` wire
  format) for parent-orchestrated drains: the parent sends the source
  child ``migrate_out`` and the destination child ``migrate_in``, and
  the pages travel DIRECTLY between the children over the shared
  transport world — retransmitted on drop/corrupt like any frame.

Ops: ``admit``, ``step``, ``state``, ``results``, ``probe``,
``set_req`` (salt identity pinning — the gateway writes
``salt_rid``/``salt_seed`` on the parent's request mirror and the
mirror forwards here), ``pin_wv``, ``release``, ``migrate_out``,
``migrate_in``, ``stage_weights``, ``commit_weights``,
``publish_metrics`` (``MetricsCollector.publish`` — full registry
snapshot to the parent's ``FleetAggregator``), ``launch_counts`` (the
child's kernel launch counts, ``paddle_tpu_torch.launch_counts``),
``shutdown``.

Orphan safety: the heartbeat thread watches ``os.getppid()`` — when
the parent vanishes the child exits on its own; the parent-side
PID-file sweep (``remote_replica.sweep_orphans``) is the backstop for
children that never got that far.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

REQ_CHANNEL = "rh_req"
RSP_CHANNEL = "rh_rsp"
HB_CHANNEL = "rh_hb"
WEIGHT_CHANNEL = "rh_w"
MIGRATE_CHANNEL = "rh_mig"
SPEC_ENV = "PT_REPLICA_SPEC"

# heartbeat cadence: the child beats every INTERVAL seconds; the parent
# declares the child dead after MISS consecutive intervals with no beat
HB_INTERVAL_ENV = "PT_REPLICA_HEARTBEAT_INTERVAL"
HB_MISS_ENV = "PT_REPLICA_HEARTBEAT_MISS"
DEFAULT_HB_INTERVAL = 0.25
DEFAULT_HB_MISS = 6


def encode(doc: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(doc).encode("utf-8"), dtype=np.uint8)


def decode(arr) -> dict:
    return json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode(
        "utf-8"))


def hb_interval() -> float:
    return float(os.environ.get(HB_INTERVAL_ENV, "") or
                 DEFAULT_HB_INTERVAL)


def hb_miss() -> int:
    return int(os.environ.get(HB_MISS_ENV, "") or DEFAULT_HB_MISS)


def encode_sampling(sp) -> Optional[list]:
    if sp is None:
        return None
    return [float(sp.temperature), int(sp.top_k), float(sp.top_p)]


def decode_sampling(s):
    from .serving import SamplingParams

    if s is None:
        return None
    return SamplingParams(temperature=s[0], top_k=s[1], top_p=s[2])


def _oom_score() -> Optional[int]:
    try:
        with open("/proc/self/oom_score") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _status(engine) -> dict:
    return {"pending": len(engine.pending()),
            "free_pages": len(engine._free_pages),
            "next_rid": int(engine._next_rid),
            "active_wv": int(engine.active_weight_version),
            "retained": sorted(int(v) for v in engine._weight_sets),
            "done": sorted(rid for rid, r in engine._requests.items()
                           if r.done),
            "timed_out": sorted(rid for rid, r in
                                engine._requests.items() if r.timed_out)}


def _req_meta(r) -> dict:
    """Everything the parent mirror needs about one child request."""
    return {"rid": int(r.rid), "prompt": list(r.prompt),
            "generated": list(r.generated), "max_new": int(r.max_new),
            "sampling": encode_sampling(r.sampling),
            "eos_token_id": r.eos_token_id, "tenant": r.tenant,
            "salt_rid": int(r.salt_rid),
            "salt_seed": r.salt_seed, "done": bool(r.done),
            "cached": int(r.cached), "pages": len(r.pages),
            "weight_version": int(r.weight_version)}


class _HeartbeatThread(threading.Thread):
    """Beats gauges to the parent; exits the PROCESS when the parent
    vanishes (first line of orphan defense — the parent's PID-file
    sweep is the backstop)."""

    def __init__(self, tp, engine, interval: float):
        super().__init__(daemon=True)
        self.tp = tp
        self.engine = engine
        self.interval = interval
        self.stop = threading.Event()
        self._boot_ppid = os.getppid()
        self._n = 0

    def run(self):
        from ..distributed.resilience.errors import TransportError

        while not self.stop.wait(self.interval):
            if os.getppid() != self._boot_ppid:
                os._exit(0)            # orphaned: the parent is gone
            self._n += 1
            beat = {"beat": self._n, "ts": time.time(),
                    "oom_score": _oom_score()}
            try:
                beat.update(_status(self.engine))
                self.tp.send(encode(beat), 0, channel=HB_CHANNEL)
            except (TransportError, OSError, RuntimeError):
                return                 # transport is down: host exiting


def _build_engine(spec: dict):
    """The child's engine: from the spec's artifact, or over a
    ``PagedCausalLM`` whose weights are drawn from ``model_seed`` by the
    model's own ``torch.Generator`` on ``device`` (so a restarted child
    rebuilds the same weights). ``device`` defaults to "cuda"."""
    from .serving import PagedCausalLM, PagedServingConfig, ServingEngine

    cfg = PagedServingConfig(**spec["cfg"])
    device = spec.get("device") or "cuda"
    if spec.get("artifact"):
        engine = ServingEngine(spec["artifact"], cfg, device=device,
                               seed=int(spec.get("engine_seed", 0)))
    else:
        model = PagedCausalLM(cfg, device=device,
                              seed=int(spec.get("model_seed", 0)))
        model.eval()
        engine = ServingEngine.from_model(
            model, cfg, seed=int(spec.get("engine_seed", 0)),
            weight_stream=spec.get("weight_stream"), device=device)
    engine.name = spec.get("name") or engine.name
    return engine


def _warm(engine) -> float:
    """Run one stateless probe through the engine before the hello: the
    kernels build (or load) and the first-use costs of the device are paid
    here, not inside an RPC the parent's heartbeat budget is timing. No
    request, page, counter or rid of the engine changes (``probe_logits``
    writes only the trash page). Returns the seconds it took."""
    t0 = time.perf_counter()
    if engine._model is not None:
        engine.probe_logits([1] * min(4, engine.cfg.token_budget))
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def serve(tp, engine, collector=None) -> int:
    """Answer RPCs until ``shutdown`` (clean exit) or transport loss."""
    from ..distributed.resilience.errors import (EngineDeadError,
                                                 PeerUnreachableError,
                                                 TransportClosedError,
                                                 TransportTimeoutError,
                                                 WeightTransferError)
    from .serving import EngineOverloadedError

    evicted: list = []
    engine.requeue_hook = lambda info: evicted.append(int(info["rid"]))

    def _reply(doc: dict):
        tp.send(encode(doc), 0, channel=RSP_CHANNEL)

    while True:
        tag = tp.reserve_recv(0, REQ_CHANNEL)
        while True:
            try:
                req = decode(tp._mailbox.take(tag, 5.0))
                break
            except TransportTimeoutError:
                continue               # idle: keep waiting on this tag
            except TransportClosedError:
                return 0
        op = req.get("op")
        try:
            if op == "shutdown":
                _reply({"ok": 1})
                return 0
            elif op == "admit":
                rid = engine.add_request(
                    req["prompt"], max_new_tokens=req["max_new"],
                    sampling=decode_sampling(req.get("sampling")),
                    eos_token_id=req.get("eos_token_id"),
                    deadline_s=req.get("deadline_s"),
                    tenant=req.get("tenant"))
                _reply({"ok": 1, "rid": rid, **_status(engine)})
            elif op == "step":
                produced = engine.step() if engine.pending() else []
                ev, evicted[:] = list(evicted), []
                _reply({"ok": 1,
                        "produced": [[int(rid), int(t)]
                                     for rid, t in produced],
                        "evicted": ev, **_status(engine)})
            elif op == "state" or op == "probe":
                _reply({"ok": 1, **_status(engine)})
            elif op == "results":
                r = engine._requests[int(req["rid"])]
                _reply({"ok": 1, **_req_meta(r)})
            elif op == "set_req":
                r = engine._requests[int(req["rid"])]
                for k, v in req["fields"].items():
                    if k not in ("salt_rid", "salt_seed"):
                        raise KeyError(f"set_req field {k!r}")
                    setattr(r, k, v)
                _reply({"ok": 1})
            elif op == "pin_wv":
                engine.pin_weight_version(int(req["rid"]),
                                          int(req["version"]))
                _reply({"ok": 1})
            elif op == "release":
                r = engine._requests[int(req["rid"])]
                r.done = True
                engine._release(r)
                _reply({"ok": 1, **_status(engine)})
            elif op == "migrate_out":
                from . import disagg

                disagg.migrate_request(
                    engine, int(req["rid"]), tp, int(req["dst"]),
                    channel=req.get("channel", MIGRATE_CHANNEL))
                _reply({"ok": 1, **_status(engine)})
            elif op == "migrate_in":
                from . import disagg

                rid = disagg.receive_request(
                    engine, tp, int(req["src"]),
                    channel=req.get("channel", MIGRATE_CHANNEL))
                _reply({"ok": 1,
                        **_req_meta(engine._requests[rid]),
                        **_status(engine)})
            elif op == "probe_logits":
                logits = engine.probe_logits(
                    req["prompt"],
                    version=req.get("version"))
                _reply({"ok": 1,
                        "logits": [float(x) for x in
                                   np.asarray(logits).ravel()]})
            elif op == "stage_weights":
                from .weight_publish import receive_weight_set

                v = receive_weight_set(engine, tp, 0,
                                       channel=WEIGHT_CHANNEL)
                _reply({"ok": 1, "version": v, **_status(engine)})
            elif op == "commit_weights":
                engine.commit_weight_set(int(req["version"]))
                _reply({"ok": 1, **_status(engine)})
            elif op == "launch_counts":
                from .. import launch_counts

                _reply({"ok": 1, "counts": dict(launch_counts())})
            elif op == "publish_metrics":
                if collector is None:
                    raise KeyError("no metrics collector configured")
                collector.publish()
                _reply({"ok": 1})
            else:
                _reply({"err": "unknown_op", "msg": str(op)})
        except EngineOverloadedError as e:
            _reply({"err": "overloaded", "msg": str(e)})
        except EngineDeadError as e:
            # an in-child chaos kill (kill@decode) fells the ENGINE;
            # the host stays up to report it, the parent demotes
            _reply({"err": "engine_dead", "msg": str(e)})
        except PeerUnreachableError as e:
            _reply({"err": "peer_unreachable", "msg": str(e)})
        except WeightTransferError as e:
            _reply({"err": "weight_transfer", "msg": str(e)})
        except (KeyError, ValueError) as e:
            _reply({"err": "bad_request",
                    "msg": f"{type(e).__name__}: {e}"})


def main() -> int:
    from ..distributed.transport import init_transport
    from ..profiler.aggregate import MetricsCollector

    spec = json.loads(os.environ[SPEC_ENV])
    tp = init_transport()
    assert tp is not None, "replica host needs a multi-process world"
    engine = _build_engine(spec)
    warm_s = _warm(engine)
    engine.fault_rank = tp.rank
    if spec.get("metrics_namespace"):
        engine.set_metrics_namespace(spec["metrics_namespace"])
    collector = MetricsCollector(
        tp, 0, host_id=spec.get("host_id"),
        replica=spec.get("name"), channel="metrics")
    hb = _HeartbeatThread(tp, engine, hb_interval())
    hb.start()
    # hello: the spawn handshake the parent blocks on
    tp.send(encode({"op": "hello", "ok": 1, "pid": os.getpid(),
                    "name": engine.name, "warm_s": warm_s,
                    "device": str(engine.device),
                    "weight_stream_mode": engine._weight_stream_mode,
                    **_status(engine)}), 0, channel=RSP_CHANNEL)
    try:
        rc = serve(tp, engine, collector)
    finally:
        hb.stop.set()
        try:
            tp.close()
        except Exception:  # the last line of the worker's life: the
            # parent learns of any problem from the exit code, not from a
            # traceback racing process teardown
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())
