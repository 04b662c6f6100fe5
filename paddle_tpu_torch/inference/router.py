"""Health-aware admission + routing across ServingEngine replicas
(port of paddle_tpu/inference/router.py).

The fleet front door: N single-host engines (possibly disaggregated
pairs) serve behind one router that (1) scores each replica by its LIVE
engine gauges — batch occupancy, KV-pool utilization — and admits every
request on the least-loaded healthy replica, (2) turns
``EngineOverloadedError`` from a hard failure into a REROUTE to the
next replica (``serving/reroutes``), (3) demotes replicas whose health
probe fails (watchdog ``__unhealthy__`` mark, aborted/closed transport,
or any caller-supplied predicate) so traffic drains away from a sick
host without dropping in-flight work elsewhere, and (4) installs each
engine's ``requeue_hook`` so a deadline-evicted request is retried on
another replica (``serving/requeues``) instead of dying with a 504 —
BOUNDED: each request carries a requeue count and stops retrying after
``max_requeues`` (``serving/requeue_exhausted``), so an expired request
cannot ping-pong between overloaded replicas forever; an installed
``retry_gate`` (the FleetGateway's fleet-wide retry budget) can veto
any reroute/requeue before the per-request cap is reached.

Demotion is a CIRCUIT BREAKER, not a death sentence: a demoted replica
stops receiving admissions but keeps earning half-open recovery probes
(``Replica.probe``, run by ``step_all`` and the fleet supervisor);
``restore_after`` consecutive passing probes restore it to rotation
(``serving/replica_restored``) — a replica that heals, or is restarted
by ``inference/fleet_supervisor.py``, rejoins instead of staying out
for the process lifetime.  A replica whose engine raises
``EngineDeadError`` mid-step is demoted on the spot
(``serving/replica_failures``) and surfaced through the router's
``failure_hook`` so the supervisor can drain + restart it.

This is the same decision loop a production LB runs off a metrics
scrape, shrunk to process-local method calls: the scores read the
exact values the ``serving/*`` gauges export.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..distributed.resilience import faults as _faults
from ..profiler import metrics as _metrics
from ..profiler import timeline as _timeline
from ..profiler import tracing as _tracing
from .serving import EngineOverloadedError, ServingEngine

__all__ = ["Replica", "ReplicaRouter", "transport_healthy",
           "watchdog_healthy"]

_m_reroutes = _metrics.counter("serving/reroutes")
_m_requeues = _metrics.counter("serving/requeues")
_m_restored = _metrics.counter("serving/replica_restored")
_m_failures = _metrics.counter("serving/replica_failures")
_m_requeue_exhausted = _metrics.counter("serving/requeue_exhausted")


def transport_healthy(tp) -> bool:
    """A TensorTransport is healthy while it is open and un-poisoned
    (watchdog escalation aborts it with a structured error)."""
    return tp is not None and not tp._closed and tp._abort_exc is None


def watchdog_healthy(store, group_id: int) -> bool:
    """True while the comm watchdog has NOT marked ``group_id``
    unhealthy in the store (distributed/watchdog.py escalation)."""
    from ..distributed.watchdog import read_unhealthy

    try:
        return read_unhealthy(store, group_id) is None
    except Exception:
        return False          # unreadable store: assume the worst


class Replica:
    """One routable engine + its health probe.

    ``health_fn`` is any zero-arg predicate — compose it from
    ``transport_healthy`` / ``watchdog_healthy`` for real deployments;
    a probe that raises counts as unhealthy.  ``mark_unhealthy`` is the
    manual demotion lever (ops taking a replica out of rotation).

    Demotion is half-open: ``probe()`` (called by the router's
    ``step_all`` and the fleet supervisor) re-evaluates a demoted
    replica, and ``restore_after`` CONSECUTIVE passing probes restore
    it to rotation (``serving/replica_restored``).  A dead engine
    (``engine.dead``) always probes unhealthy until replaced."""

    def __init__(self, engine: ServingEngine, name: Optional[str] = None,
                 health_fn: Optional[Callable[[], bool]] = None,
                 restore_after: int = 3, host_id: Optional[str] = None,
                 backend_kind: str = "gpu", cost_weight: float = 1.0):
        self.engine = engine
        self.name = name or f"replica{id(engine) & 0xffff:04x}"
        # heterogeneous fleets: ``backend_kind`` tags the accelerator
        # class ("gpu"/"cpu"/...), ``cost_weight`` scales its load score
        # in routing order (a CPU replica serving the same batch is
        # "more loaded" per request — weight > 1 makes the router prefer
        # GPU slots of equal raw load).  Non-GPU replicas are OVERFLOW:
        # they absorb new placements only once every GPU replica is at
        # or past the router's ``tpu_saturation`` load (the reference's
        # name for the accelerator tier's saturation)
        self.backend_kind = backend_kind
        self.cost_weight = float(cost_weight)
        # failure-domain label: replicas sharing it die together under
        # host loss, and the fleet supervisor drains AWAY from it first
        self.host_id = host_id if host_id is not None \
            else getattr(engine, "host_id", None)
        self.health_fn = health_fn
        self.restore_after = max(int(restore_after), 1)
        self._demoted = False
        self._streak = 0       # consecutive passing half-open probes
        # elastic lifecycle (inference/autoscaler.py): a DRAINING
        # replica keeps stepping its in-flight work but stops receiving
        # placements (router ordering and gateway affinity skip it); a
        # RETIRED replica left the fleet for good — its slot stays in
        # the replica list so every handle/index minted before the
        # resize stays valid, but it never serves, probes, or restores
        # again.  Finished requests on the retained engine keep
        # answering results().
        self.draining = False
        self.retired = False
        # bind the engine's serving/* writes to this replica's child
        # registry (rolls up to the global one) so co-hosted replicas
        # stop conflating their series; restarted engines re-bind to
        # the SAME namespace in FleetSupervisor.restart
        if hasattr(engine, "set_metrics_namespace") \
                and getattr(engine, "metrics_namespace", None) is None:
            engine.set_metrics_namespace(self.name)

    def _probe_raw(self) -> bool:
        if self.retired or getattr(self.engine, "dead", False):
            return False
        if self.health_fn is not None:
            try:
                return bool(self.health_fn())
            except Exception:
                return False
        return True

    def healthy(self) -> bool:
        if self._demoted or self.retired:
            return False
        return self._probe_raw()

    def placeable(self) -> bool:
        """Eligible for NEW work: healthy and not draining.  A draining
        replica stays healthy (it finishes in-flight streams) but the
        router stops placing on it and affinity probes skip it."""
        return self.healthy() and not self.draining

    def probe(self) -> bool:
        """One health probe with half-open accounting: while demoted,
        each passing probe extends the streak and ``restore_after`` in a
        row restore the replica; any failing probe resets the streak."""
        ok = self._probe_raw()
        if not self._demoted:
            return ok
        if ok:
            self._streak += 1
            if self._streak >= self.restore_after:
                self._demoted = False
                self._streak = 0
                _m_restored.inc()
                _timeline.emit_event("replica_restored", replica=self.name)
        else:
            self._streak = 0
        return ok

    def mark_unhealthy(self):
        self._demoted = True
        self._streak = 0
        _timeline.emit_event("replica_demoted", replica=self.name)

    def mark_healthy(self):
        self._demoted = False
        self._streak = 0

    def load_score(self) -> float:
        """Live load from the same values the serving gauges export:
        batch occupancy + KV-pool utilization (0..2; lower = idler)."""
        eng, cfg = self.engine, self.engine.cfg
        occ = len(eng.pending()) / max(cfg.max_batch, 1)
        live = cfg.num_blocks - 1 - len(eng._free_pages)
        return occ + live / max(cfg.num_blocks - 1, 1)


class ReplicaRouter:
    """Admission + routing over a replica set.

    ``submit`` returns a router-level handle (stable across requeues —
    the handle follows the request to whichever replica finally serves
    it); ``run_to_completion``/``results`` collect generations by
    handle."""

    def __init__(self, replicas, requeue_deadline_s: Optional[float] = None,
                 max_requeues: int = 3, tpu_saturation: float = 1.0):
        self.replicas: List[Replica] = [
            r if isinstance(r, Replica) else Replica(r) for r in replicas]
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        # heterogeneous overflow threshold: non-GPU replicas receive
        # NEW placements only once every placeable GPU replica's load
        # score is >= this (load_score is 0..2: 1.0 ~= full batch
        # occupancy OR a full KV pool).  With an all-GPU (or all-CPU)
        # fleet the gate is vacuous and ordering is pure load/cost.
        self.tpu_saturation = float(tpu_saturation)
        # replica-list mutation guard (autoscaler resizes a live fleet):
        # add_replica/remove_replica mutate under this lock, and every
        # traversal (_ordered/step_all/_live_pending) iterates a
        # SNAPSHOT taken under it — a resize landing mid-step can never
        # skip or double-step a replica.  Indices are append-only
        # stable: adds append, removes tombstone in place (Replica.
        # retired), so a handle's (idx, rid) survives any resize.
        self._lock = threading.Lock()
        # a requeued request gets this fresh deadline (None: no deadline
        # on the retry — it already burned its first one)
        self.requeue_deadline_s = requeue_deadline_s
        # bounded deadline-requeue: a request that keeps expiring stops
        # retrying after this many requeues (serving/requeue_exhausted)
        # instead of ping-ponging between overloaded replicas forever
        self.max_requeues = max(int(max_requeues), 0)
        self._handles: Dict[int, Tuple[int, int]] = {}   # h -> (idx, rid)
        self._by_engine: Dict[Tuple[int, int], int] = {}
        # handles that hopped replicas (requeue/drain): the gateway
        # reason-codes their completion "drained", not "completed"
        self.moved_handles: set = set()
        self._next_handle = 0
        # called with the replica index when an engine dies mid-step
        # (EngineDeadError): the fleet supervisor installs its drain +
        # restart here
        self.failure_hook: Optional[Callable[[int], None]] = None
        # fleet-wide retry budget: called with the retry flavor
        # ("requeue" | "reroute" | "drain") before each retry attempt;
        # False vetoes it.  The FleetGateway installs its token-bucket
        # budget here so overload cannot amplify into a retry storm.
        self.retry_gate: Optional[Callable[[str], bool]] = None
        for idx, rep in enumerate(self.replicas):
            rep.engine.requeue_hook = self._make_requeue_hook(idx)

    # -- elastic fleet membership ------------------------------------------
    def _snapshot(self) -> List[Replica]:
        """Point-in-time copy of the replica list for lock-free
        iteration; indices in the copy equal live indices (the list is
        append-only — removals tombstone in place)."""
        with self._lock:
            return list(self.replicas)

    def add_replica(self, replica) -> int:
        """Admit a new replica (or bare engine) into rotation; returns
        its stable index.  The replica starts taking traffic on the
        NEXT ordering pass — callers (the autoscaler) must bring its
        engine to the fleet's committed weight version first."""
        rep = replica if isinstance(replica, Replica) \
            else Replica(replica)
        with self._lock:
            idx = len(self.replicas)
            rep.engine.requeue_hook = self._make_requeue_hook(idx)
            self.replicas.append(rep)
        _timeline.emit_event("replica_added", replica=rep.name,
                             idx=idx)
        return idx

    def remove_replica(self, idx: int) -> Replica:
        """Retire replica ``idx`` for good: its slot stays (handles and
        indices minted before the resize stay valid, finished requests
        keep answering ``results()``) but it never places, probes, or
        restores again.  The caller is responsible for draining its
        in-flight work FIRST (``FleetSupervisor.drain``)."""
        with self._lock:
            rep = self.replicas[idx]
            rep.retired = True
            rep.draining = False
            rep._demoted = True
            rep._streak = 0
        _timeline.emit_event("replica_retired", replica=rep.name,
                             idx=idx)
        return rep

    def fleet_size(self) -> int:
        """Replicas still in the fleet (draining counts, retired does
        not) — the autoscaler's notion of current size."""
        return sum(1 for r in self._snapshot() if not r.retired)

    # -- admission ---------------------------------------------------------
    def _ordered(self, exclude: Optional[int] = None,
                 prefer_off_host: Optional[str] = None) -> List[int]:
        reps = self._snapshot()
        healthy = [i for i, r in enumerate(reps)
                   if i != exclude and r.placeable()]
        # heterogeneous gate: while ANY GPU replica still has headroom
        # (load below tpu_saturation), non-GPU replicas sort behind all
        # GPU ones — they are overflow capacity, not peers.  Once the
        # GPU tier saturates the gate opens and pure cost-weighted load
        # decides.  Vacuously open for homogeneous fleets.
        accel_open = any(
            getattr(reps[i], "backend_kind", "gpu") == "gpu"
            and reps[i].load_score() < self.tpu_saturation
            for i in healthy)

        def overflow(i: int) -> int:
            if not accel_open:
                return 0
            return 0 if getattr(reps[i], "backend_kind", "gpu") == "gpu" \
                else 1

        def cost_load(i: int) -> float:
            return reps[i].load_score() * getattr(reps[i],
                                                  "cost_weight", 1.0)
        if prefer_off_host is not None:
            # drain ordering under host loss: peers OFF the failing host
            # first (they do not share its fate), load-sorted within
            # each group
            return sorted(healthy, key=lambda i: (
                reps[i].host_id == prefer_off_host,
                overflow(i), cost_load(i)))
        return sorted(healthy, key=lambda i: (overflow(i), cost_load(i)))

    def submit(self, prompt_tokens, max_new_tokens=8, sampling=None,
               eos_token_id=None, deadline_s=None, tenant=None,
               prefer: Optional[int] = None) -> int:
        """Admit on the least-loaded healthy replica; an overloaded
        replica is skipped (counted as a reroute) instead of failing the
        request.  ``prefer`` tries that replica index first regardless
        of load (the gateway's prefix-affinity placement); ``tenant``
        scopes the request's prefix-cache namespace.  Raises
        EngineOverloadedError only when EVERY healthy replica sheds (the
        fleet is genuinely saturated — or fully demoted), or when the
        ``retry_gate`` vetoes rerouting past a shed."""
        reps = self._snapshot()
        order = self._ordered()
        if prefer is not None and prefer in order:
            order.remove(prefer)
            order.insert(0, prefer)
        for idx in order:
            try:
                rid = reps[idx].engine.add_request(
                    prompt_tokens, max_new_tokens=max_new_tokens,
                    sampling=sampling, eos_token_id=eos_token_id,
                    deadline_s=deadline_s, tenant=tenant)
            except EngineOverloadedError:
                _m_reroutes.inc()
                if self.retry_gate is not None \
                        and not self.retry_gate("reroute"):
                    break      # retry budget spent: stop fanning out
                continue
            h = self._next_handle
            self._next_handle += 1
            self._handles[h] = (idx, rid)
            self._by_engine[(idx, rid)] = h
            return h
        raise EngineOverloadedError(
            f"all {len(reps)} replicas saturated or unhealthy "
            f"({sum(r.healthy() for r in reps)} healthy)")

    # -- deadline requeue --------------------------------------------------
    def _make_requeue_hook(self, src_idx: int):
        def hook(info):
            _m_requeues.inc()
            handle = self._by_engine.pop((src_idx, info["rid"]), None)
            n_prior = int(info.get("requeues", 0))
            if n_prior >= self.max_requeues \
                    or (self.retry_gate is not None
                        and not self.retry_gate("requeue")):
                # the request burned its retry allowance (per-request
                # cap, or the fleet-wide budget said no): stop the
                # ping-pong — the handle keeps pointing at the
                # timed-out request so results() reports it honestly
                _m_requeue_exhausted.inc()
                if handle is not None:
                    self._by_engine[(src_idx, info["rid"])] = handle
                return
            wv = int(info.get("weight_version", 0) or 0)
            reps = self._snapshot()
            for idx in self._ordered(exclude=src_idx):
                eng = reps[idx].engine
                # version-bitwise identity across the requeue: the
                # retry must resume under the version its stream
                # STARTED on, so replicas not serving (or retaining)
                # that version are skipped mid-rollout
                if hasattr(eng, "has_weight_version") \
                        and not eng.has_weight_version(wv):
                    continue
                try:
                    rid = eng.add_request(
                        info["prompt"],
                        max_new_tokens=info["max_new"],
                        sampling=info["sampling"],
                        eos_token_id=info["eos_token_id"],
                        deadline_s=self.requeue_deadline_s,
                        tenant=info.get("tenant"))
                except EngineOverloadedError:
                    _m_reroutes.inc()
                    continue
                if hasattr(eng, "pin_weight_version"):
                    eng.pin_weight_version(rid, wv)
                retry_req = eng._requests[rid]
                retry_req.requeues = n_prior + 1
                # carry the sampling-salt identity: the retry
                # regenerates the ORIGINAL stream bitwise (same
                # drain/migrate semantics as the fleet supervisor)
                if "salt_rid" in info:
                    retry_req.salt_rid = info["salt_rid"]
                    salt_seed = info.get("salt_seed")
                    if salt_seed is None:
                        salt_seed = reps[src_idx].engine.seed
                    retry_req.salt_seed = salt_seed
                # the retry joins the original request's trace: a
                # requeue span bridges the evicted request to its new
                # replica, and the new request's lifecycle spans parent
                # under it instead of opening a disconnected trace
                src_trace = info.get("trace")
                if src_trace is not None:
                    now = _time.perf_counter()
                    new_req = eng._requests[rid]
                    new_req.trace = _tracing.record_span(
                        "serving::requeue", now, now, parent=src_trace,
                        args={"rid": rid, "engine": eng.name,
                              "from": reps[src_idx].name})
                if handle is not None:
                    self._handles[handle] = (idx, rid)
                    self._by_engine[(idx, rid)] = handle
                    self.moved_handles.add(handle)
                return
            # nowhere to retry: the handle keeps pointing at the
            # timed-out request so results() reports it honestly
            if handle is not None:
                self._by_engine[(src_idx, info["rid"])] = handle
        return hook

    # -- driving -----------------------------------------------------------
    def step_all(self) -> Dict[int, List[int]]:
        """One scheduling step on every replica with pending work;
        returns {handle: [tokens produced this step]}.  Demoted replicas
        get a half-open recovery probe instead of traffic; an engine
        that dies mid-step (EngineDeadError) is demoted on the spot and
        reported through ``failure_hook``."""
        from ..distributed.resilience.errors import EngineDeadError

        produced: Dict[int, List[int]] = {}
        for idx, rep in enumerate(self._snapshot()):
            if rep.retired:
                continue
            if rep._demoted:
                rep.probe()
                if rep._demoted:
                    continue
            act = _faults.injector.on_event(
                "host", getattr(rep.engine, "fault_rank", idx),
                host=rep.host_id)
            if act is not None and act.kind == "kill" \
                    and not getattr(rep.engine, "dead", False):
                # chaos host loss: every replica sharing the felled
                # host_id dies (sticky — the injector keeps answering
                # kill for this host), through the same demote +
                # failure_hook path a mid-step EngineDeadError takes
                rep.engine.dead = True
                rep.mark_unhealthy()
                _m_failures.inc()
                if self.failure_hook is not None:
                    self.failure_hook(idx)
                continue
            if getattr(rep.engine, "dead", False) \
                    or not rep.engine.pending():
                continue
            try:
                stepped = rep.engine.step()
            except EngineDeadError:
                rep.mark_unhealthy()
                _m_failures.inc()
                if self.failure_hook is not None:
                    self.failure_hook(idx)
                continue
            for rid, tok in stepped:
                h = self._by_engine.get((idx, rid))
                if h is not None:
                    produced.setdefault(h, []).append(tok)
        return produced

    def _live_pending(self) -> bool:
        return any(rep.engine.pending() for rep in self._snapshot()
                   if not rep.retired
                   and not getattr(rep.engine, "dead", False))

    def run_to_completion(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self._live_pending():
                break
            self.step_all()
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        reps = self._snapshot()
        out = {}
        for h, (idx, rid) in self._handles.items():
            out[h] = list(reps[idx].engine._requests[rid].generated)
        return out

    def timed_out(self) -> List[int]:
        """Handles whose FINAL placement still timed out (requeue also
        failed or re-expired)."""
        reps = self._snapshot()
        out = []
        for h, (idx, rid) in self._handles.items():
            if reps[idx].engine._requests[rid].timed_out:
                out.append(h)
        return out

    def placement(self, handle: int) -> Tuple[str, int]:
        idx, rid = self._handles[handle]
        return self._snapshot()[idx].name, rid
