"""Process-isolated replicas: the parent half (port of
paddle_tpu/inference/remote_replica.py).

``replica_host.py`` is the child: one ``ServingEngine`` in its own
process, answering framed RPCs over the CRC/ACK ``TensorTransport``.
This module is everything the PARENT needs to treat that process as a
fleet member:

- ``RemoteEngine`` — an engine-shaped proxy.  It satisfies the exact
  surface ``ReplicaRouter`` / ``FleetSupervisor`` / ``AutoScaler`` /
  ``WeightPublisher.catch_up`` already consume from in-process engines
  (``add_request``/``step``/``pending``/``_requests``/``_release``/
  ``has_weight_version``/``pin_weight_version``/``stage_weight_set``/
  ``commit_weight_set``/``seed``/``requeue_hook``), so every existing
  fleet behavior — drain, requeue, restart, rollout catch-up, SLO
  routing — works unchanged across a real process boundary.
- ``RemoteReplica`` — a ``Replica`` whose health probe is PROCESS
  liveness: heartbeat staleness (the primary detector — a SIGSTOPped
  child looks exactly like a dead one), plus the waitpid status for
  the death taxonomy the flight dump carries.
- ``SubprocessReplicaFactory`` — the ``AutoScaler`` seam: spawn a
  child, handshake, register atomically; teardown against a real PID.

Liveness is INFERRED, never assumed: the parent declares a child dead
after ``PT_REPLICA_HEARTBEAT_MISS`` beat intervals of silence
(``EngineDeadError`` out of the next ``step``/RPC — the same exception
an in-process engine death raises, so the router demotes and the
supervisor drains through the code paths that already exist).  A child
that is unresponsive but still has a live PID (hung, SIGSTOPped) is
SIGKILLed at declaration — a zombie engine must not outlive its slot.

Request state is MIRRORED, not shared: the parent keeps a
``_MirrorRequest`` per in-flight request (parent-side rid namespace —
child rids never leak into router handles), appends tokens from step
replies, and forwards gateway salt-identity writes (``salt_rid``/
``salt_seed``) to the child before the next step so pinned streams
stay bitwise-deterministic across the process boundary.

Rank hygiene: the transport's per-source dedup and rx-sequence state
live for the life of the parent's transport, so a respawned child MUST
get a fresh rank — ``SubprocessReplicaFactory`` allocates ranks
monotonically and never reuses one.

Orphan safety is layered: the child's heartbeat thread self-exits when
``getppid`` changes (first line); the factory's ``atexit`` hook kills
its live children (second); ``sweep_orphans`` kills any child whose
PID file names a parent that no longer exists (backstop, e.g. after a
SIGKILLed parent).

Chaos: the ``replica`` fault site fires here, in the parent, against
the child's real PID — ``sigkill@replica`` delivers SIGKILL,
``hang@replica`` delivers SIGSTOP (see ``resilience/faults.py``).
After delivering a signal the parent stops issuing RPCs to that child
and lets heartbeat inference declare the death, exactly as it would
for a pod-level kill it didn't cause.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..distributed.resilience import faults as _faults
from ..distributed.resilience.errors import (EngineDeadError,
                                             PeerUnreachableError,
                                             TransportClosedError,
                                             TransportError,
                                             TransportTimeoutError,
                                             WeightTransferError)
from ..profiler import metrics as _metrics
from ..profiler import timeline as _timeline
from ..profiler import tracing as _tracing
from .autoscaler import ReplicaFactory, SpawnError
from .replica_host import (DEFAULT_HB_INTERVAL, DEFAULT_HB_MISS,
                           HB_CHANNEL, HB_INTERVAL_ENV, HB_MISS_ENV,
                           MIGRATE_CHANNEL, REQ_CHANNEL, RSP_CHANNEL,
                           SPEC_ENV, WEIGHT_CHANNEL, decode,
                           decode_sampling, encode, encode_sampling,
                           hb_interval, hb_miss)
from .router import Replica
from .serving import EngineOverloadedError, PagedServingConfig

__all__ = ["RemoteEngine", "RemoteReplica", "SubprocessReplicaFactory",
           "sweep_orphans", "classify_exit"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_m_process_deaths = _metrics.counter("serving/replica_process_deaths")
_m_spawns = _metrics.counter("serving/replica_spawns")
_m_orphans = _metrics.counter("serving/orphans_reaped")

# oom_score at/above this at the last beat makes a SIGKILL death
# "oom_kill_suspect" rather than plain "killed" (the kernel OOM killer
# delivers SIGKILL; /proc/<pid>/oom_score ~1000 means next in line)
_OOM_SUSPECT_SCORE = 900


def classify_exit(returncode: Optional[int],
                  oom_score: Optional[int] = None) -> dict:
    """Map a child's waitpid status onto the death taxonomy the flight
    dump speaks: ``clean`` (exit 0), ``killed``
    (SIGKILL), ``oom_kill_suspect`` (SIGKILL with a near-terminal
    ``oom_score`` at the last beat), ``signal_N`` (any other signal),
    ``nonzero`` (crashed with an exit code), ``unresponsive`` (the PID
    still exists — hung or SIGSTOPped)."""
    if returncode is None:
        cls = "unresponsive"
    elif returncode == 0:
        cls = "clean"
    elif returncode == -signal.SIGKILL:
        cls = "oom_kill_suspect" \
            if (oom_score or 0) >= _OOM_SUSPECT_SCORE else "killed"
    elif returncode < 0:
        cls = f"signal_{-returncode}"
    else:
        cls = "nonzero"
    return {"exit_class": cls, "exit_code": returncode,
            "oom_score": oom_score}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _remove_pid_file(path: Optional[str]):
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


def sweep_orphans(pid_dir: str) -> List[int]:
    """SIGKILL replica-host children whose PID file names a parent that
    no longer exists, and remove their PID files.  The backstop behind
    the child's own getppid watch and the factory's atexit hook: run it
    at process start (or from a janitor) to clean up after a parent
    that died too hard to run either.  Children whose recorded parent
    is still alive — this process or another — are left alone."""
    killed: List[int] = []
    try:
        names = os.listdir(pid_dir)
    except OSError:
        return killed
    for fn in names:
        if not fn.endswith(".pid"):
            continue
        path = os.path.join(pid_dir, fn)
        try:
            with open(path) as f:
                doc = json.load(f)
            pid, ppid = int(doc["pid"]), int(doc["ppid"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if ppid == os.getpid() or _pid_alive(ppid):
            continue               # owner still runs: not ours to reap
        if _pid_alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)
                _m_orphans.inc()
            except OSError:
                pass
        _remove_pid_file(path)
    if killed:
        _tracing.flight_note("replica_orphans_reaped", pids=killed,
                             pid_dir=pid_dir)
    return killed


class _MirrorRequest:
    """Parent-side mirror of one child request.  Carries the exact
    attribute surface the router/gateway/supervisor read and write on
    ``serving._Request``; ``salt_rid``/``salt_seed`` writes are marked
    dirty and forwarded to the child before its next step, so identity
    pinned on the mirror lands before the first token samples."""

    _FORWARDED = ("salt_rid", "salt_seed")

    def __init__(self, engine: "RemoteEngine", rid: int, child_rid: int,
                 fields: dict):
        d = self.__dict__
        d["_engine"] = engine
        d["_live"] = False
        self.rid = rid
        self.child_rid = child_rid
        self.trace = None
        self.requeues = 0
        self.timed_out = False
        for k, v in fields.items():
            setattr(self, k, v)
        d["_live"] = True

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def pages(self):
        # The supervisor sizes migrations by ``len(r.pages)``; the real
        # page ids live in the child, so expose a placeholder list of
        # the same cardinality the child would hold for this length.
        eng = self.__dict__["_engine"]
        return list(range(eng._pages_for(self.length)))

    def __setattr__(self, key, value):
        self.__dict__[key] = value
        if key in self._FORWARDED and self.__dict__.get("_live"):
            eng = self.__dict__.get("_engine")
            if eng is not None:
                eng._note_dirty(self)


class RemoteEngine:
    """Engine-shaped proxy for one replica-host child process."""

    def __init__(self, transport, child_rank: int, proc, cfg, spec: dict,
                 hello: dict, *, pid_file: Optional[str] = None,
                 rpc_timeout: float = 120.0,
                 hb_interval_s: Optional[float] = None,
                 hb_miss_n: Optional[int] = None, on_exit=None):
        self._tp = transport
        self.child_rank = int(child_rank)
        self.proc = proc
        self.pid = int(hello.get("pid") or proc.pid)
        self.cfg = cfg
        self.spec = spec
        self.name = hello.get("name") or spec.get("name") \
            or f"proc{child_rank}"
        # the CHILD engine's seed: origin salt identity for requeues
        # (supervisor._requeue_one reads src.seed when salt_seed is
        # unpinned — it must be the seed the child salted with)
        self.seed = int(spec.get("engine_seed", 0))
        self.host_id = spec.get("host_id")
        self.fault_rank = int(child_rank)
        self.dead = False
        self.death: Optional[dict] = None
        self.requeue_hook = None
        self.metrics_namespace = spec.get("metrics_namespace")
        self._requests: Dict[int, _MirrorRequest] = {}
        self._by_child: Dict[int, int] = {}
        self._next_rid = 0
        self._free_pages = list(range(1, cfg.num_blocks))
        self._prefix_cache = None
        self._weight_stream_mode = hello.get("weight_stream_mode")
        self._active_wv = int(hello.get("active_wv", 0))
        self._retained = set(int(v) for v in hello.get("retained", ()))
        self._lock = threading.RLock()
        self._signalled: Optional[str] = None
        self._dirty: List[_MirrorRequest] = []
        self._pid_file = pid_file
        self._rpc_timeout = float(rpc_timeout)
        self._hb_interval = float(hb_interval_s) \
            if hb_interval_s is not None else hb_interval()
        self._hb_miss = int(hb_miss_n) if hb_miss_n is not None \
            else hb_miss()
        self._last_beat = time.monotonic()
        self._last_beat_n = 0
        self._last_oom: Optional[int] = None
        self._hb_tag = transport.reserve_recv(child_rank, HB_CHANNEL)
        self._on_exit = on_exit
        # the child's hello (its warm-up seconds, device, first gauges)
        self.hello = dict(hello)

    # -- liveness inference ------------------------------------------------
    def poll_heartbeats(self):
        """Drain every beat the child has landed; each refreshes the
        staleness clock and the mirrored gauges (free pages, weight
        versions, last known oom_score)."""
        with self._lock:
            while True:
                try:
                    raw = self._tp._mailbox.take(self._hb_tag, 0.0)
                except (TransportTimeoutError, TransportClosedError):
                    return
                self._hb_tag = self._tp.reserve_recv(self.child_rank,
                                                     HB_CHANNEL)
                beat = decode(raw)
                self._last_beat = time.monotonic()
                self._last_beat_n = int(beat.get("beat",
                                                 self._last_beat_n))
                self._last_oom = beat.get("oom_score")
                self._apply_gauges(beat)

    def beat_age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last_beat

    def beat_budget(self) -> float:
        return self._hb_interval * self._hb_miss

    def process_healthy(self) -> bool:
        """The Replica health probe: alive PID + fresh beats."""
        if self.dead:
            return False
        self.poll_heartbeats()
        if self.proc is not None and self.proc.poll() is not None:
            return False
        return self.beat_age() <= self.beat_budget()

    def _check_alive(self, site: Optional[str] = None):
        if self.dead:
            raise EngineDeadError(self.name, site)
        self.poll_heartbeats()
        if self.beat_age() > self.beat_budget():
            self._declare_dead("missed_heartbeats", site)

    def _declare_dead(self, reason: str, site: Optional[str] = None):
        """Point of no return: classify the exit (BEFORE reaping, so
        the taxonomy reflects what the world did, not what we do next),
        reap a still-live PID, flight-note the death, raise."""
        if self.dead:
            raise EngineDeadError(self.name, site)
        self.dead = True
        rc = self.proc.poll() if self.proc is not None else None
        with self._lock:
            note = classify_exit(rc, self._last_oom)
            note.update(reason=reason, replica=self.name, pid=self.pid,
                        child_rank=self.child_rank,
                        beat_age_s=round(self.beat_age(), 3),
                        last_beat=self._last_beat_n,
                        signalled=self._signalled)
        if rc is None and self.proc is not None:
            # unresponsive with a live PID (hung / SIGSTOPped): a
            # declared-dead child must not keep the slot's pages warm
            try:
                self.proc.kill()
                self.proc.wait(timeout=10)
                note["reaped"] = True
            except (OSError, subprocess.TimeoutExpired):
                pass
        self.death = note
        _m_process_deaths.inc()
        _tracing.flight_note("replica_process_dead", **note)
        _timeline.emit_event("replica_process_dead",
                             replica=self.name,
                             exit_class=note["exit_class"])
        _remove_pid_file(self._pid_file)
        if self._on_exit is not None:
            try:
                self._on_exit(self)
            except Exception as e:  # the exit callback is factory
                # bookkeeping; a failure there must not mask the
                # EngineDeadError this method exists to raise, so note it
                # and continue to the raise
                _tracing.flight_note("replica_on_exit_error",
                                     replica=self.name, error=repr(e))
        raise EngineDeadError(self.name, site)

    # -- framed RPC --------------------------------------------------------
    def _send(self, doc: dict, site: Optional[str]):
        try:
            self._tp.send(encode(doc), self.child_rank,
                          channel=REQ_CHANNEL)
        except TransportError:
            self._declare_dead("send_failed", site)

    def _await(self, tag: str, site: Optional[str],
               timeout: Optional[float] = None) -> dict:
        deadline = time.monotonic() + (timeout or self._rpc_timeout)
        while True:
            try:
                rsp = decode(self._tp._mailbox.take(tag, 0.5))
                break
            except TransportTimeoutError:
                self._check_alive(site)
                if time.monotonic() > deadline:
                    self._declare_dead("rpc_timeout", site)
            except TransportClosedError:
                self._declare_dead("transport_closed", site)
        # a reply is as good as a beat (long compiles in the child can
        # outlast an interval; its answer proves it lives)
        self._last_beat = time.monotonic()
        err = rsp.get("err")
        if err:
            self._raise_err(err, rsp.get("msg", ""), site)
        return rsp

    def _rpc(self, doc: dict, site: Optional[str] = None,
             timeout: Optional[float] = None) -> dict:
        self._check_alive(site)
        with self._lock:
            tag = self._tp.reserve_recv(self.child_rank, RSP_CHANNEL)
            self._send(doc, site)
            return self._await(tag, site, timeout)

    def _raise_err(self, err: str, msg: str, site: Optional[str]):
        if err == "overloaded":
            raise EngineOverloadedError(msg)
        if err == "engine_dead":
            # the CHILD's engine died in-process (an in-child chaos
            # kill); the host still answers but the slot is dead —
            # same drain/restart path as a process death
            self._declare_dead("child_engine_dead", site)
        if err == "peer_unreachable":
            raise PeerUnreachableError(self.child_rank, None, 0,
                                       RuntimeError(msg))
        if err == "weight_transfer":
            raise WeightTransferError(0, self.name, msg)
        if err == "bad_request":
            if msg.startswith("KeyError"):
                raise KeyError(msg)
            raise ValueError(msg)
        raise RuntimeError(f"replica host {self.name}: {err}: {msg}")

    # -- mirrored state ----------------------------------------------------
    def _apply_gauges(self, doc: dict):
        if "free_pages" in doc:
            n = int(doc["free_pages"])
            if n != len(self._free_pages):
                self._free_pages = list(range(n))
        if "active_wv" in doc:
            self._active_wv = int(doc["active_wv"])
        if "retained" in doc:
            self._retained = set(int(v) for v in doc["retained"])

    def _pages_for(self, length: int) -> int:
        bs = max(int(self.cfg.block_size), 1)
        return min(-(-max(length, 1) // bs),
                   int(self.cfg.max_blocks_per_seq))

    def _adopt(self, child_rid: int, fields: dict) -> int:
        rid = self._next_rid
        self._next_rid += 1
        r = _MirrorRequest(self, rid, int(child_rid), fields)
        self._requests[rid] = r
        self._by_child[int(child_rid)] = rid
        return rid

    def _note_dirty(self, r: _MirrorRequest):
        if r not in self._dirty:
            self._dirty.append(r)

    def _flush_dirty(self):
        """Forward pinned salt identity before the child's next step —
        the gateway writes ``salt_rid``/``salt_seed`` on the mirror
        right after admission, and the pin must land before the first
        token samples."""
        while self._dirty:
            r = self._dirty.pop(0)
            if r.done or r.child_rid not in self._by_child:
                continue
            self._rpc({"op": "set_req", "rid": r.child_rid,
                       "fields": {k: getattr(r, k)
                                  for k in _MirrorRequest._FORWARDED}},
                      site="set_req")

    # -- engine surface ----------------------------------------------------
    def pending(self):
        return [r for r in self._requests.values() if not r.done]

    def add_request(self, prompt_tokens, max_new_tokens: int = 8,
                    sampling=None, eos_token_id=None, deadline_s=None,
                    tenant=None) -> int:
        prompt = [int(t) for t in prompt_tokens]
        rsp = self._rpc({"op": "admit", "prompt": prompt,
                         "max_new": int(max_new_tokens),
                         "sampling": encode_sampling(sampling),
                         "eos_token_id": eos_token_id,
                         "deadline_s": deadline_s, "tenant": tenant},
                        site="admit")
        crid = int(rsp["rid"])
        self._apply_gauges(rsp)
        return self._adopt(crid, dict(
            prompt=prompt, generated=[], max_new=int(max_new_tokens),
            sampling=sampling, eos_token_id=eos_token_id, tenant=tenant,
            salt_rid=crid, salt_seed=None, done=False, cached=0,
            weight_version=int(rsp.get("active_wv", self._active_wv))))

    def step(self):
        act = _faults.injector.on_event("replica", self.fault_rank)
        if act is not None:
            self._deliver(act)
        self._check_alive("step")
        if self._signalled:
            # we delivered a real signal: no more RPCs to this child —
            # heartbeat inference owns its fate now, exactly as it
            # would for a pod kill we didn't cause
            return []
        self._flush_dirty()
        rsp = self._rpc({"op": "step"}, site="step")
        return self._apply_step(rsp)

    def _deliver(self, act):
        kind = getattr(act, "kind", None)
        if kind == "sigkill":
            self._signalled = "sigkill"
            try:
                os.kill(self.pid, signal.SIGKILL)
            except OSError:
                pass
        elif kind == "hang":
            self._signalled = "hang"
            try:
                os.kill(self.pid, signal.SIGSTOP)
            except OSError:
                pass
        elif kind == "delay":
            time.sleep(float(getattr(act, "delay_ms", 0.0)) / 1e3)

    def _apply_step(self, rsp: dict):
        out = []
        for crid, tok in rsp.get("produced", ()):
            rid = self._by_child.get(int(crid))
            if rid is None:
                continue
            r = self._requests[rid]
            r.generated.append(int(tok))
            # the child is at this stream's decode tip at every step
            # boundary: everything but the newest token is cached
            r.cached = r.length - 1
            out.append((rid, int(tok)))
        for crid in rsp.get("done", ()):
            rid = self._by_child.get(int(crid))
            if rid is not None:
                self._requests[rid].done = True
        for crid in rsp.get("timed_out", ()):
            rid = self._by_child.get(int(crid))
            if rid is not None:
                self._requests[rid].timed_out = True
        for crid in rsp.get("evicted", ()):
            self._requeue_evicted(int(crid))
        self._apply_gauges(rsp)
        return out

    def _requeue_evicted(self, crid: int):
        """The child's deadline sweep evicted a request: surface it
        through the parent's requeue hook with the same info dict an
        in-process engine builds (serving._requeue_info)."""
        rid = self._by_child.get(crid)
        if rid is None:
            return
        r = self._requests[rid]
        r.done = True
        r.timed_out = True
        hook = self.requeue_hook
        if hook is None:
            return
        hook({"rid": r.rid, "prompt": list(r.prompt),
              "generated": list(r.generated), "max_new": r.max_new,
              "sampling": r.sampling, "eos_token_id": r.eos_token_id,
              "timed_out": True, "requeues": r.requeues,
              "tenant": r.tenant, "salt_rid": r.salt_rid,
              "salt_seed": r.salt_seed,
              "weight_version": getattr(r, "weight_version", 0),
              "trace": r.trace.to_dict()
              if getattr(r, "trace", None) is not None else None})

    def _release(self, r: _MirrorRequest):
        r.done = True
        if self.dead or self._signalled:
            return                 # parent bookkeeping only: no RPC
        try:
            rsp = self._rpc({"op": "release", "rid": r.child_rid},
                            site="release")
            self._apply_gauges(rsp)
        except (EngineDeadError, KeyError, ValueError):
            pass
        self._by_child.pop(r.child_rid, None)

    def set_metrics_namespace(self, namespace: str):
        # the CHILD binds its serving/* series to the namespace from
        # the spawn spec; the parent just remembers the label so
        # Replica.__init__ / FleetSupervisor.restart don't rebind
        self.metrics_namespace = namespace

    # -- weight publishing surface ----------------------------------------
    @property
    def active_weight_version(self) -> int:
        return self._active_wv

    def has_weight_version(self, version: int) -> bool:
        v = int(version)
        return v == self._active_wv or v in self._retained

    def pin_weight_version(self, rid: int, version: int):
        r = self._requests[int(rid)]
        self._rpc({"op": "pin_wv", "rid": r.child_rid,
                   "version": int(version)}, site="pin_wv")
        r.weight_version = int(version)

    def stage_weight_set(self, version: int, arrays, crcs):
        """Ship a staged weight set to the child: announce with a
        ``stage_weights`` RPC, stream the tensors on the weight
        channel, await the child's CRC-verified ack.  This is what
        ``weight_publish.receive_weight_set`` calls, so a fleet
        rollout — and ``WeightPublisher.catch_up`` after a respawn —
        reaches subprocess replicas unchanged."""
        from .weight_publish import send_weight_set

        self._check_alive("stage_weights")
        with self._lock:
            tag = self._tp.reserve_recv(self.child_rank, RSP_CHANNEL)
            self._send({"op": "stage_weights"}, "stage_weights")
            try:
                send_weight_set(self._tp, self.child_rank, int(version),
                                arrays, crcs, channel=WEIGHT_CHANNEL)
            except TransportError:
                self._declare_dead("send_failed", "stage_weights")
            rsp = self._await(tag, "stage_weights")
        self._retained.add(int(version))
        self._apply_gauges(rsp)

    def probe_logits(self, prompt, version=None):
        """Stateless canary probe, answered by the child (the publish
        canary scores a staged version on a subprocess replica exactly
        as it would in-process)."""
        import numpy as np

        rsp = self._rpc({"op": "probe_logits",
                         "prompt": [int(t) for t in prompt],
                         "version": version}, site="probe_logits")
        return np.asarray(rsp["logits"], dtype=np.float32)

    def commit_weight_set(self, version: int):
        rsp = self._rpc({"op": "commit_weights",
                         "version": int(version)},
                        site="commit_weights")
        self._active_wv = int(version)
        self._apply_gauges(rsp)

    # -- parent-orchestrated child-to-child drain --------------------------
    def migrate_out(self, rid: int, dst: "RemoteEngine"):
        """Tell the child to ship one decode-tip request's KV pages
        DIRECTLY to ``dst``'s child over the shared transport world
        (disagg wire format — retransmitted on drop/corrupt like any
        frame).  The source copy finishes as its last act."""
        r = self._requests[int(rid)]
        rsp = self._rpc({"op": "migrate_out", "rid": r.child_rid,
                         "dst": dst.child_rank,
                         "channel": MIGRATE_CHANNEL},
                        site="migrate_out")
        r.done = True
        self._by_child.pop(r.child_rid, None)
        self._apply_gauges(rsp)

    def migrate_in(self, src: "RemoteEngine") -> int:
        """Adopt the request ``src``'s child just shipped; returns the
        parent-side rid of the new mirror."""
        rsp = self._rpc({"op": "migrate_in", "src": src.child_rank,
                         "channel": MIGRATE_CHANNEL},
                        site="migrate_in")
        self._apply_gauges(rsp)
        return self._adopt(int(rsp["rid"]), dict(
            prompt=list(rsp["prompt"]), generated=list(rsp["generated"]),
            max_new=int(rsp["max_new"]),
            sampling=decode_sampling(rsp.get("sampling")),
            eos_token_id=rsp.get("eos_token_id"),
            tenant=rsp.get("tenant"), salt_rid=int(rsp["salt_rid"]),
            salt_seed=rsp.get("salt_seed"), done=bool(rsp.get("done")),
            cached=int(rsp.get("cached", 0)),
            weight_version=int(rsp.get("weight_version", 0))))

    # -- results / metrics / teardown --------------------------------------
    def publish_metrics(self):
        """Ask the child to ship its full registry snapshot to the
        parent's FleetAggregator (profiler/aggregate.py wire)."""
        self._rpc({"op": "publish_metrics"}, site="publish_metrics")

    def launch_counts(self) -> dict:
        """The child's kernel launch counts (its own process's
        ``paddle_tpu_torch.launch_counts``)."""
        return self._rpc({"op": "launch_counts"},
                         site="launch_counts")["counts"]

    def exit_status(self) -> dict:
        rc = self.proc.poll() if self.proc is not None else None
        with self._lock:
            return classify_exit(rc, self._last_oom)

    def shutdown(self, timeout: float = 10.0):
        """Graceful teardown: shutdown RPC, wait, SIGKILL backstop."""
        if not self.dead and self._signalled is None \
                and self.proc is not None and self.proc.poll() is None:
            try:
                self._rpc({"op": "shutdown"}, site="shutdown",
                          timeout=timeout)
            except (EngineDeadError, RuntimeError, KeyError, ValueError):
                pass
        self.dead = True
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except (subprocess.TimeoutExpired, OSError):
                try:
                    self.proc.kill()
                    self.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        _remove_pid_file(self._pid_file)


class RemoteReplica(Replica):
    """A ``Replica`` whose engine lives in a child process.  The health
    probe consults the CURRENT engine's process liveness (heartbeat
    staleness + PID), so half-open probes keep working after the fleet
    supervisor swaps in a respawned engine."""

    def __init__(self, engine: RemoteEngine, name: Optional[str] = None,
                 restore_after: int = 3, host_id: Optional[str] = None,
                 **kwargs):
        super().__init__(engine, name=name or engine.name,
                         restore_after=restore_after,
                         host_id=host_id if host_id is not None
                         else engine.host_id, **kwargs)

    def _probe_raw(self) -> bool:
        if self.retired:
            return False
        probe = getattr(self.engine, "process_healthy", None)
        if probe is not None:
            try:
                return bool(probe())
            except Exception:
                return False
        return super()._probe_raw()

    @property
    def pid(self) -> Optional[int]:
        return getattr(self.engine, "pid", None)

    @property
    def death(self) -> Optional[dict]:
        return getattr(self.engine, "death", None)


class SubprocessReplicaFactory(ReplicaFactory):
    """Spawn ``replica_host`` children and wrap them as fleet members.

    Owns the parent end of the transport world (rank 0 + the rendezvous
    store) and the child-rank counter.  Ranks are allocated
    monotonically and NEVER reused — the transport's per-source dedup
    and rx-sequence state outlive any one child, so a respawn on a
    recycled rank would have its frames dropped as duplicates.

    Plugs into ``AutoScaler`` as-is (``build``/``teardown``) and into
    ``FleetSupervisor`` via ``make_engine_factory()`` (respawn on
    restart).  ``close()`` tears down every child and the transport;
    an ``atexit`` hook SIGKILLs whatever is still alive if the parent
    exits without closing.

    Each child is a fresh interpreter (``subprocess.Popen``, never a fork
    of a process that may have touched CUDA), and builds its engine on
    ``device`` ("cuda" when None: a child on a host without a card
    raises before its hello, and the spawn fails)."""

    def __init__(self, cfg_kwargs: dict, *, model_seed: int = 0,
                 seed_base: int = 100, name_prefix: str = "proc",
                 host_pattern: str = "prochost{rank}",
                 world_size: int = 17, store_timeout: float = 120.0,
                 ack_timeout: float = 5.0, rpc_timeout: float = 120.0,
                 spawn_timeout: float = 180.0,
                 pid_dir: Optional[str] = None, weight_stream=None,
                 artifact: Optional[str] = None,
                 env_extra: Optional[dict] = None,
                 backend_kind: str = "gpu", cost_weight: float = 1.0,
                 hb_interval_s: Optional[float] = None,
                 hb_miss_n: Optional[int] = None,
                 restore_after: int = 3, device: Optional[str] = None):
        self.cfg_kwargs = dict(cfg_kwargs)
        self.device = device
        self.model_seed = int(model_seed)
        self.seed_base = int(seed_base)
        self.name_prefix = name_prefix
        self.host_pattern = host_pattern
        self.world_size = int(world_size)
        self.store_timeout = float(store_timeout)
        self.ack_timeout = float(ack_timeout)
        self.rpc_timeout = float(rpc_timeout)
        self.spawn_timeout = float(spawn_timeout)
        self.weight_stream = weight_stream
        self.artifact = artifact
        self.env_extra = dict(env_extra) if env_extra else {}
        self.backend_kind = backend_kind
        self.cost_weight = float(cost_weight)
        self._hb_interval = hb_interval_s
        self._hb_miss = hb_miss_n
        self.restore_after = int(restore_after)
        self._tp = None
        self._store = None
        self._job = f"rh{os.getpid()}_{id(self) & 0xffff:x}"
        self._next_rank = 1
        self.children: Dict[int, RemoteEngine] = {}
        self.pid_dir = pid_dir or os.path.join(
            tempfile.gettempdir(), f"pt_replicas_{os.getpid()}")
        os.makedirs(self.pid_dir, exist_ok=True)
        atexit.register(self._atexit_reap)

    # -- transport world ---------------------------------------------------
    def transport(self):
        """The parent's rank-0 transport (lazily hosts the store).
        ``world_size`` is the RANK SPACE, not a membership count — the
        store never blocks on it, children join on demand."""
        if self._tp is None:
            from ..distributed.store import connect_store
            from ..distributed.transport import TensorTransport

            self._store = connect_store("127.0.0.1", 0, is_master=True,
                                        world_size=self.world_size,
                                        timeout=self.store_timeout)
            self._tp = TensorTransport(0, self.world_size, self._store,
                                       bind_host="127.0.0.1",
                                       timeout=self.store_timeout,
                                       ack_timeout=self.ack_timeout,
                                       job=self._job)
        return self._tp

    def _child_env(self, rank: int, spec: dict) -> dict:
        env = dict(os.environ)
        env["PADDLE_TRAINER_ID"] = str(rank)
        env["PADDLE_TRAINERS_NUM"] = str(self.world_size)
        env["PADDLE_MASTER"] = f"127.0.0.1:{self._store.port}"
        env["PADDLE_CURRENT_ENDPOINT"] = "127.0.0.1:0"
        env["PADDLE_STORE_TIMEOUT"] = str(self.store_timeout)
        env["PADDLE_JOB_ID"] = self._job
        env[SPEC_ENV] = json.dumps(spec)
        if self._hb_interval is not None:
            env[HB_INTERVAL_ENV] = str(self._hb_interval)
        if self._hb_miss is not None:
            env[HB_MISS_ENV] = str(self._hb_miss)
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        env.update(self.env_extra)
        return env

    def _write_pid(self, rank: int, pid: int) -> str:
        path = os.path.join(self.pid_dir, f"replica_r{rank}.pid")
        with open(path, "w") as f:
            json.dump({"pid": int(pid), "ppid": os.getpid(),
                       "rank": int(rank), "job": self._job}, f)
        return path

    # -- lifecycle ---------------------------------------------------------
    def spawn(self, slot) -> RemoteEngine:
        """Spawn one child, block on its hello, return its proxy."""
        tp = self.transport()
        if self._next_rank >= self.world_size:
            raise SpawnError(
                f"replica rank space exhausted ({self.world_size}): "
                f"ranks are never reused — build the factory with a "
                f"larger world_size")
        rank = self._next_rank
        self._next_rank += 1
        name = f"{self.name_prefix}{slot}"
        spec = {"cfg": dict(self.cfg_kwargs),
                "model_seed": self.model_seed,
                "engine_seed": self.seed_base + int(slot),
                "name": name,
                "host_id": self.host_pattern.format(rank=rank,
                                                    slot=slot),
                "weight_stream": self.weight_stream,
                "artifact": self.artifact,
                "metrics_namespace": name,
                "device": self.device}
        hello_tag = tp.reserve_recv(rank, RSP_CHANNEL)
        log_path = os.path.join(self.pid_dir, f"replica_r{rank}.log")
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.inference.replica_host"],
                env=self._child_env(rank, spec), stdout=logf,
                stderr=logf, cwd=_REPO_ROOT)
        pid_file = self._write_pid(rank, proc.pid)
        hello = self._await_hello(tp, hello_tag, proc, rank, log_path,
                                  pid_file)
        engine = RemoteEngine(
            tp, rank, proc, PagedServingConfig(**self.cfg_kwargs),
            spec, hello, pid_file=pid_file,
            rpc_timeout=self.rpc_timeout,
            hb_interval_s=self._hb_interval, hb_miss_n=self._hb_miss,
            on_exit=self._forget)
        self.children[rank] = engine
        _m_spawns.inc()
        _timeline.emit_event("replica_spawned", replica=name,
                             pid=proc.pid, rank=rank)
        return engine

    def _await_hello(self, tp, tag: str, proc, rank: int,
                     log_path: str, pid_file: str) -> dict:
        deadline = time.monotonic() + self.spawn_timeout
        while True:
            try:
                return decode(tp._mailbox.take(tag, 1.0))
            except TransportTimeoutError:
                rc = proc.poll()
                if rc is not None:
                    _remove_pid_file(pid_file)
                    raise SpawnError(
                        f"replica host rank {rank} died before hello "
                        f"({classify_exit(rc)['exit_class']}, "
                        f"rc={rc}): {self._log_tail(log_path)}")
                if time.monotonic() > deadline:
                    try:
                        proc.kill()
                        proc.wait(timeout=10)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                    _remove_pid_file(pid_file)
                    raise SpawnError(
                        f"replica host rank {rank} sent no hello "
                        f"within {self.spawn_timeout:.0f}s: "
                        f"{self._log_tail(log_path)}")
            except TransportClosedError:
                raise SpawnError(
                    f"parent transport closed while spawning rank "
                    f"{rank}")

    @staticmethod
    def _log_tail(log_path: str, n: int = 400) -> str:
        try:
            with open(log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode("utf-8", "replace").strip() \
                    or "(empty log)"
        except OSError:
            return "(no log)"

    def build(self, slot) -> RemoteReplica:
        engine = self.spawn(slot)
        kwargs = {}
        # backend/cost-aware routing fields when the Replica carries
        # them (heterogeneous fleets: cpu overflow behind gpu)
        kwargs["backend_kind"] = self.backend_kind
        kwargs["cost_weight"] = self.cost_weight
        return RemoteReplica(engine, name=engine.name,
                             restore_after=self.restore_after, **kwargs)

    def teardown(self, replica: Replica) -> None:
        engine = replica.engine
        if isinstance(engine, RemoteEngine):
            self.retire_engine(engine)

    def retire_engine(self, engine: RemoteEngine):
        self.children.pop(engine.child_rank, None)
        engine.shutdown()

    def make_engine_factory(self):
        """``engine_factory`` for ``FleetSupervisor``: restart replica
        ``idx`` as a FRESH child process on a fresh rank."""
        def factory(idx):
            return self.spawn(idx)
        return factory

    def _forget(self, engine: RemoteEngine):
        self.children.pop(engine.child_rank, None)

    def close(self):
        for engine in list(self.children.values()):
            try:
                self.retire_engine(engine)
            except Exception as e:  # teardown must visit EVERY child;
                # one refusing a graceful shutdown cannot be allowed to
                # orphan the rest
                _tracing.flight_note("replica_retire_error",
                                     replica=engine.name, error=repr(e))
        if self._tp is not None:
            try:
                self._tp.close()
            except Exception as e:  # the orphan sweep below still has
                # to run even when the transport's sockets die mid-close
                _tracing.flight_note("factory_transport_close_error",
                                     error=repr(e))
            self._tp = None
        sweep_orphans(self.pid_dir)

    def _atexit_reap(self):
        for engine in list(self.children.values()):
            proc = engine.proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
            _remove_pid_file(engine._pid_file)
