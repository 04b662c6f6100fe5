"""Elastic fleet resizing: drain-safe retirement, catch-up-gated
scale-up, and flap-proof hysteresis over ``ScaleAdvisor`` advisories
(port of paddle_tpu/inference/autoscaler.py).

The last mile of ROADMAP item 1: ``ScaleAdvisor`` (profiler/headroom)
already answers *"grow, hold, or shrink — and if shrink, who drains
first"* from recorded telemetry; this module is the control loop that
EXECUTES those advisories against a live ``ReplicaRouter`` fleet
without ever trading away the properties the rest of the serving
stack fought for:

* **Catch-up gates entry** (scale-up).  A freshly spawned replica
  comes up at its factory's build-time weight version.  It is brought
  to the fleet's COMMITTED version — ``supervisor.weight_catchup``,
  i.e. ``WeightPublisher.catch_up`` — *before* ``router.add_replica``
  puts it in rotation, so a mid-rollout spawn can never serve stale
  weights and every stream it ever touches is version-bitwise
  consistent with the fleet.  A spawn that fails to converge within
  ``catchup_timeout_s`` is torn down (the partial replica is swept,
  never registered) and retried under bounded exponential backoff
  (``resilience/backoff``), at most ``max_spawn_failures`` attempts;
  the serving fleet keeps stepping throughout.
* **Drain precedes retirement** (scale-down).  A retiring replica is
  first marked DRAINING — the router stops placing on it
  (``Replica.placeable``), gateway affinity probes skip it, but its
  in-flight streams keep stepping.  Its remaining work then moves
  through the existing ``FleetSupervisor.drain`` path: decode-tip
  requests migrate their KV pages verbatim, the rest requeue under
  their origin sampling-salt identity — either way the final token
  streams are BITWISE identical to an uninterrupted run.  Its prefix
  cache is snapshotted for the next spawn to warm from, then the slot
  is tombstoned (``router.remove_replica``) so every handle and index
  minted before the resize stays valid.
* **Flap-proof hysteresis.**  Both directions require
  ``scale_up_after`` / ``scale_down_after`` CONSECUTIVE advisories
  before acting, any action starts a ``cooldown_evals`` cooldown, and
  the fleet never leaves ``[min_replicas, max_replicas]``.  Resizes
  are FROZEN outright while a weight-publish epoch is in flight
  (``WeightPublisher.in_flight`` — membership must not change under a
  fence) or an SLO burn alert is active (the alert is the SLO
  machinery mid-judgment; resizing under it confounds attribution —
  when the alert clears and load is still high, the very next
  evaluation scales up).  Frozen evaluations are themselves counted
  (``autoscale/frozen_evals``) and land on the timeline, so a
  post-incident review can see the scaler *choosing* not to act.
* **Pressure beyond the advisor.**  The advisor reads recorded
  windows; the scaler additionally reads the gateway's LIVE brownout
  ladder level and queued-entry depth, so a burst that engages the
  ladder between timeline samples still counts as an up-vote
  (``queue_depth_high``) instead of waiting a full window.

Chaos sites (``resilience/faults``): ``kill@spawn`` fells the
half-built replica mid-catch-up — it is swept and the attempt retried
under the same ``max_spawn_failures`` budget while the fleet keeps
serving; ``kill@retire`` fells the draining engine mid-drain — the KV
hand-off degrades to the requeue path with zero lost requests.
``delay@spawn:ms=...`` stretches the catch-up against
``catchup_timeout_s``.

Wire-up::

    advisor = ScaleAdvisor(timeline, tracker=tracker)
    scaler = AutoScaler(router, sup, advisor,
                        InProcessReplicaFactory(model, cfg),
                        AutoScalerConfig(min_replicas=2, max_replicas=6),
                        gateway=gw, publisher=pub, tracker=tracker)
    ...
    scaler.evaluate()          # one tick of the control loop

The loop is deliberately SYNCHRONOUS — one ``evaluate()`` per caller
tick (the same cadence that samples the timeline), no background
thread: resize actions interleave deterministically with serving
steps, which is what makes the chaos acceptance tests (and the PT7xx
race scan) tractable.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..distributed.resilience import backoff as _backoff
from ..distributed.resilience import faults as _faults
from ..distributed.resilience.errors import (EngineDeadError,
                                             TransportError,
                                             WeightTransferError)
from ..profiler import metrics as _metrics
from ..profiler import timeline as _timeline
from ..profiler import tracing as _tracing
from .router import Replica, ReplicaRouter
from .serving import ServingEngine

__all__ = ["AutoScaler", "AutoScalerConfig", "ReplicaFactory",
           "InProcessReplicaFactory", "SpawnError"]

_m_actions = _metrics.counter("autoscale/actions")
_m_spawn_failures = _metrics.counter("autoscale/spawn_failures")
_m_frozen = _metrics.counter("autoscale/frozen_evals")
_m_catchup_ms = _metrics.histogram("autoscale/catchup_ms")
_m_drain_ms = _metrics.histogram("autoscale/drain_ms")
_m_size = _metrics.gauge("autoscale/fleet_size")


class SpawnError(RuntimeError):
    """A ReplicaFactory failed to produce a servable replica."""


# ---------------------------------------------------------------------------
# replica factories
# ---------------------------------------------------------------------------
class ReplicaFactory:
    """Pluggable spawn/teardown seam for the autoscaler.

    ``build(slot)`` returns a ``Replica`` (or a bare engine — the
    scaler wraps it) that is NOT yet registered anywhere; the scaler
    owns bringing it to the committed weight version and admitting it.
    ``teardown(replica)`` disposes a partial replica whose spawn
    failed (died mid-catch-up, never converged) — it was never
    registered, so teardown must not touch router/supervisor state.

    The in-process default below builds co-hosted engines.
    ``remote_replica.SubprocessReplicaFactory`` builds process-isolated
    ones: the child process builds the engine from the shared config +
    seed and the parent drives it over the CRC/ACK ``TensorTransport``.
    Nothing in the scaler changes — ``build`` just returns a Replica
    whose engine proxies over the transport."""

    def build(self, slot: int) -> Replica:
        raise NotImplementedError

    def teardown(self, replica: Replica) -> None:   # pragma: no cover
        """Dispose a partial replica (spawn failure). Default: mark
        the engine dead so any stray reference refuses to serve."""
        replica.engine.dead = True


class InProcessReplicaFactory(ReplicaFactory):
    """Default factory: engines over one shared live model
    (``ServingEngine.from_model`` — engines over one model share its
    cast weights, so a spawn costs the KV pools, its decode windows'
    captures and the catch-up).  Each slot gets a deterministic seed
    (``seed_base + slot``) so a fixed-fleet reference run can
    reproduce any spawned replica's placement streams bitwise.
    ``device``: as ``from_model``'s (None: cfg.backend, else "cuda")."""

    def __init__(self, model, cfg, seed_base: int = 0,
                 name_prefix: str = "auto", host_id: Optional[str] = None,
                 weight_stream: Optional[str] = None,
                 prefix_snapshot_root: Optional[str] = None, device=None):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.seed_base = int(seed_base)
        self.name_prefix = name_prefix
        self.host_id = host_id
        self.weight_stream = weight_stream
        # spawned engines warm their prefix cache from the newest
        # snapshot a retired predecessor left here
        self.prefix_snapshot_root = prefix_snapshot_root
        self.built = 0

    def build(self, slot: int) -> Replica:
        eng = ServingEngine.from_model(
            self.model, self.cfg, seed=self.seed_base + slot,
            weight_stream=self.weight_stream, device=self.device)
        eng.name = f"{self.name_prefix}{slot}"
        if self.prefix_snapshot_root and eng._prefix_cache is not None:
            try:
                eng.restore_prefix_cache(root=self.prefix_snapshot_root)
            except Exception:  # a missing or torn snapshot must never
                # block a spawn: a cold prefix cache is correct, slower
                pass
        self.built += 1
        return Replica(eng, name=eng.name, host_id=self.host_id)


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------
@dataclass
class AutoScalerConfig:
    """Knobs for the resize control loop.

    ``scale_up_after``/``scale_down_after`` are the consecutive-eval
    hysteresis gates (advisories must agree that many evaluations in a
    row); ``cooldown_evals`` freezes the loop after ANY action so one
    resize settles before the next is considered; ``catchup_timeout_s``
    bounds how long a spawned replica may take to reach the committed
    weight version before it is torn down; ``max_spawn_failures``
    bounds teardown-and-retry attempts per scale-up decision, spaced
    by ``spawn_backoff_base_s``/``spawn_backoff_cap_s`` bounded
    exponential backoff; ``queue_depth_high`` is the live gateway
    backlog that counts as scale-up pressure even when the recorded
    windows look calm."""

    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_after: int = 2
    scale_down_after: int = 3
    cooldown_evals: int = 3
    catchup_timeout_s: float = 5.0
    max_spawn_failures: int = 3
    spawn_backoff_base_s: float = 0.01
    spawn_backoff_cap_s: float = 0.25
    queue_depth_high: int = 8


class AutoScaler:
    """Synchronous resize control loop over a live serving fleet.

    One ``evaluate()`` per tick: read the advisory (plus live gateway
    pressure), run the freeze/hysteresis gates, and execute at most
    ONE resize action.  Construction wires nothing — the scaler only
    acts through the seams the fleet already exposes
    (``router.add_replica``/``remove_replica``, ``supervisor.drain``/
    ``adopt_replica``/``weight_catchup``,
    ``gateway.notify_fleet_changed``)."""

    def __init__(self, router: ReplicaRouter, supervisor, advisor,
                 factory: ReplicaFactory,
                 cfg: Optional[AutoScalerConfig] = None,
                 gateway=None, publisher=None, tracker=None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.supervisor = supervisor
        self.advisor = advisor
        self.factory = factory
        self.cfg = cfg or AutoScalerConfig()
        self.gateway = gateway
        # publisher: freeze source (in_flight) + committed-version
        # oracle for the catch-up gate.  Defaults to the advisor's
        # tracker so callers wiring a ScaleAdvisor(tracker=...) get
        # the alert freeze for free.
        self.publisher = publisher
        self.tracker = tracker if tracker is not None \
            else getattr(advisor, "tracker", None)
        self.clock = clock
        # naming counter for factory slots: strictly increasing across
        # the scaler's lifetime so a retired slot's name is never
        # reused (timeline events stay unambiguous)
        self._next_slot = len(router.replicas)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self.spawn_failures = 0          # lifetime total, all decisions
        self.last_action: Optional[Dict] = None
        self.history: List[Dict] = []    # recent decision records

    # -- live pressure beyond the advisor ---------------------------------
    def _gateway_pressure(self) -> Optional[str]:
        """A live scale-up signal the recorded windows may not show
        yet: the brownout ladder engaged, or the tenant queues backed
        up past ``queue_depth_high``."""
        gw = self.gateway
        if gw is None:
            return None
        lvl = getattr(getattr(gw, "brownout", None), "level", 0)
        if lvl and lvl >= 1:
            return f"gateway brownout level {lvl}"
        depth = sum(len(q) for queues in getattr(gw, "_queues", {}).values()
                    for q in queues.values())
        if depth >= self.cfg.queue_depth_high:
            return f"gateway queue depth {depth} >= " \
                   f"{self.cfg.queue_depth_high}"
        return None

    def _replica_loads(self) -> Dict[str, float]:
        return {rep.name: rep.load_score()
                for rep in self.router._snapshot() if rep.placeable()}

    # -- freeze gates ------------------------------------------------------
    def _frozen_reason(self) -> Optional[str]:
        if self.publisher is not None \
                and getattr(self.publisher, "in_flight", False):
            return "publish_in_flight"
        if self.tracker is not None and self.tracker.active_alerts():
            return "slo_alert_active"
        if self._cooldown > 0:
            return "cooldown"
        return None

    # -- the tick ----------------------------------------------------------
    def evaluate(self) -> Dict:
        """One control-loop tick.  Returns the decision record (also
        appended to ``history`` and mirrored to the timeline): at
        minimum ``action`` (``hold`` / ``frozen`` / ``scale_up`` /
        ``scale_down`` / ``scale_up_failed``), ``reason``, and the
        fleet ``size`` after the tick."""
        size = self.router.fleet_size()
        _m_size.set(size)
        frozen = self._frozen_reason()
        if frozen is not None:
            if self._cooldown > 0:
                self._cooldown -= 1
            _m_frozen.inc()
            _timeline.emit_event("autoscale_frozen", reason=frozen,
                                 size=size)
            return self._record("frozen", frozen, size)

        loads = self._replica_loads()
        advice = self.advisor.recommend(replica_loads=loads)
        pressure = self._gateway_pressure()
        action, reason = advice.action, advice.reason
        if action == "hold" and pressure is not None:
            # live gateway pressure outvotes a stale-calm advisory
            action, reason = "scale_up", pressure

        # consecutive-eval hysteresis: both directions must persist
        if action == "scale_up":
            self._up_streak += 1
            self._down_streak = 0
        elif action == "scale_down":
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0

        if action == "scale_up":
            if size >= self.cfg.max_replicas:
                return self._record("hold", "at max_replicas", size)
            if self._up_streak < self.cfg.scale_up_after:
                return self._record(
                    "hold", f"scale_up streak {self._up_streak}/"
                            f"{self.cfg.scale_up_after}", size)
            return self._scale_up(reason)
        if action == "scale_down":
            if size <= self.cfg.min_replicas:
                return self._record("hold", "at min_replicas", size)
            if self._down_streak < self.cfg.scale_down_after:
                return self._record(
                    "hold", f"scale_down streak {self._down_streak}/"
                            f"{self.cfg.scale_down_after}", size)
            return self._scale_down(advice, reason)
        return self._record("hold", reason, size)

    # -- scale-up ----------------------------------------------------------
    def _committed_version(self) -> int:
        return int(getattr(self.publisher, "version", 0) or 0)

    def _catch_up(self, rep: Replica) -> bool:
        """Bring the spawned engine to the committed version under
        ``catchup_timeout_s``.  True = converged (or nothing to
        converge to); False = teardown-worthy."""
        catchup = getattr(self.supervisor, "weight_catchup", None)
        committed = self._committed_version()
        t0 = self.clock()
        if catchup is not None:
            try:
                catchup(rep.engine)
            except (TransportError, EngineDeadError, WeightTransferError,
                    ValueError, KeyError):
                return False
        if self.clock() - t0 > self.cfg.catchup_timeout_s:
            # converged too late: the fleet moved on while this
            # replica was still streaming weights — treat as failed
            return False
        if committed > 0 and getattr(rep.engine, "active_weight_version",
                                     0) < committed:
            return False
        _m_catchup_ms.observe((self.clock() - t0) * 1000.0)
        return True

    def _sweep(self, rep: Replica) -> None:
        """Dispose a partial replica that never entered rotation."""
        try:
            self.factory.teardown(rep)
        except Exception:
            rep.engine.dead = True
        _tracing.flight_note("autoscale_spawn_swept", replica=rep.name)

    def _scale_up(self, reason: str) -> Dict:
        slot = self._next_slot
        for attempt in range(self.cfg.max_spawn_failures):
            if attempt > 0:
                time.sleep(_backoff.delay(
                    attempt - 1, base=self.cfg.spawn_backoff_base_s,
                    cap=self.cfg.spawn_backoff_cap_s))
            try:
                built = self.factory.build(slot)
            except (SpawnError, EngineDeadError, ValueError) as e:
                self._spawn_failed(slot, attempt, f"build: {e}")
                continue
            rep = built if isinstance(built, Replica) else Replica(built)
            # chaos: the spawn site fires between build and catch-up —
            # a kill here is the new process dying mid-catch-up; the
            # fleet must keep serving with the partial replica swept
            act = _faults.injector.on_event("spawn", slot,
                                            host=rep.host_id)
            if act is not None and act.kind == "kill":
                rep.engine.dead = True
            elif act is not None and act.kind == "delay":
                time.sleep(act.delay_ms / 1000.0)
            if getattr(rep.engine, "dead", False) \
                    or not self._catch_up(rep):
                self._sweep(rep)
                self._spawn_failed(slot, attempt, "catch_up")
                continue
            # admission is atomic from the fleet's point of view: the
            # replica becomes placeable only once the router holds it,
            # and supervisor/gateway adopt it before the next step can
            # route to it (synchronous loop: no step interleaves here)
            idx = self.router.add_replica(rep)
            self.supervisor.adopt_replica(idx)
            if self.gateway is not None:
                self.gateway.notify_fleet_changed()
            self._next_slot = slot + 1
            self._acted()
            _m_actions.inc()
            size = self.router.fleet_size()
            _m_size.set(size)
            _timeline.emit_event("autoscale_action", action="scale_up",
                                 replica=rep.name, idx=idx, size=size,
                                 reason=reason, attempt=attempt)
            return self._record("scale_up", reason, size,
                                replica=rep.name, attempts=attempt + 1)
        # every attempt burned: hold at current size, cool down so the
        # loop does not spin on a persistently failing factory
        self._acted()
        size = self.router.fleet_size()
        _timeline.emit_event("autoscale_spawn_failed", slot=slot,
                             attempts=self.cfg.max_spawn_failures,
                             reason=reason)
        _tracing.flight_note("autoscale_spawn_failed", slot=slot,
                             attempts=self.cfg.max_spawn_failures)
        return self._record("scale_up_failed",
                            f"{self.cfg.max_spawn_failures} spawn "
                            f"attempts failed", size)

    def _spawn_failed(self, slot: int, attempt: int, why: str) -> None:
        self.spawn_failures += 1
        _m_spawn_failures.inc()
        _timeline.emit_event("autoscale_spawn_retry", slot=slot,
                             attempt=attempt, why=why)

    # -- scale-down --------------------------------------------------------
    def _pick_victim(self, advice) -> Optional[int]:
        """Map the advisor's first live drain candidate to its router
        index (falling back to the least-loaded placeable replica when
        the advisor named none)."""
        reps = self.router._snapshot()
        by_name = {r.name: i for i, r in enumerate(reps)
                   if r.placeable()}
        for name in getattr(advice, "drain_candidates", []) or []:
            if name in by_name:
                return by_name[name]
        order = self.router._ordered()
        if order:
            # least-loaded last-resort victim: _ordered sorts ascending
            return order[0]
        return None

    def _scale_down(self, advice, reason: str) -> Dict:
        idx = self._pick_victim(advice)
        size = self.router.fleet_size()
        if idx is None:
            return self._record("hold", "no drainable candidate", size)
        rep = self.router.replicas[idx]
        t0 = self.clock()
        # draining first: placement and affinity stop IMMEDIATELY, the
        # in-flight streams keep stepping until the drain moves them
        rep.draining = True
        _timeline.emit_event("autoscale_draining", replica=rep.name,
                             idx=idx)
        if self.gateway is not None:
            self.gateway.notify_fleet_changed()
        # chaos: the retire site fires as the hand-off starts — a kill
        # fells the draining engine, so migration degrades to the
        # requeue path (origin salt identity: still bitwise)
        act = _faults.injector.on_event("retire", idx, host=rep.host_id)
        if act is not None and act.kind == "kill":
            rep.engine.dead = True
        elif act is not None and act.kind == "delay":
            time.sleep(act.delay_ms / 1000.0)
        # a retiring replica that DIED mid-drain has no live source end
        # to ship KV pages: force the requeue path (origin salt
        # identity keeps the regenerated streams bitwise)
        moved = self.supervisor.drain(
            idx, migrate=not getattr(rep.engine, "dead", False))
        # the retiring cache is tomorrow's warm start: snapshot it for
        # the next spawn (factory prefix_snapshot_root) before retiring
        eng = rep.engine
        snapshot = None
        if eng._prefix_cache is not None \
                and eng.cfg.prefix_snapshot_root \
                and not getattr(eng, "dead", False):
            try:
                snapshot = eng.save_prefix_cache(
                    root=eng.cfg.prefix_snapshot_root,
                    keep=getattr(self.supervisor.cfg, "snapshot_keep", 2))
            except EngineDeadError:
                snapshot = None
        self.router.remove_replica(idx)
        if self.gateway is not None:
            self.gateway.notify_fleet_changed()
        self._acted()
        _m_actions.inc()
        _m_drain_ms.observe((self.clock() - t0) * 1000.0)
        size = self.router.fleet_size()
        _m_size.set(size)
        _timeline.emit_event("autoscale_action", action="scale_down",
                             replica=rep.name, idx=idx, size=size,
                             reason=reason, drained=moved)
        return self._record("scale_down", reason, size,
                            replica=rep.name, drained=moved,
                            snapshot=bool(snapshot))

    # -- bookkeeping -------------------------------------------------------
    def _acted(self) -> None:
        self._cooldown = self.cfg.cooldown_evals
        self._up_streak = 0
        self._down_streak = 0

    def _record(self, action: str, reason: str, size: int,
                **extra) -> Dict:
        rec = {"action": action, "reason": reason, "size": size}
        rec.update(extra)
        self.last_action = rec if action not in ("hold", "frozen") \
            else self.last_action
        self.history.append(rec)
        if len(self.history) > 256:
            del self.history[:-256]
        return rec
