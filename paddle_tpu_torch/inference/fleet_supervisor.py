"""Self-healing serving fleet: drain, restart, and re-admit replicas
(port of paddle_tpu/inference/fleet_supervisor.py).

The serving analog of ``distributed/resilience/supervisor.py``'s
elastic training loop.  The training supervisor answers a killed RANK
with re-form + snapshot restore; the fleet supervisor answers a killed
REPLICA (an engine that raised ``EngineDeadError`` — chaos
``kill@prefill``/``kill@decode``/``kill@cache_save``, or a real crash
surfaced the same way) with a three-step recovery:

1. **Drain**: every in-flight request on the dead replica moves to a
   healthy peer.  Requests at their decode tip migrate VERBATIM over
   the existing ``disagg.migrate_request`` KV hand-off (an in-process
   ``LoopbackTransport`` carries the frames between co-hosted engines;
   cross-host fleets pass a real ``TensorTransport``), so the peer
   resumes mid-generation without re-prefilling.  Requests the dying
   engine cannot ship — mid-prefill, or the hand-off itself fails
   (``drop@migrate`` -> ``PeerUnreachableError``) — fall back to a
   REQUEUE on a peer that re-decodes from the prompt.
2. **Identity**: both paths preserve the request's ORIGIN sampling-salt
   identity (``salt_seed``/``salt_rid``), and ownership is single at
   every instant (the source request finishes before the peer copy
   runs), so a drained request is never decoded twice and its final
   token stream is BITWISE-identical to an uninterrupted run —
   migration resumes the exact stream, and a requeued request
   deterministically regenerates the same tokens from the prompt.
3. **Restart**: the replica's engine is rebuilt through the caller's
   factory under bounded exponential backoff (``resilience/backoff``),
   inherits the dead engine's finished results and rid namespace (the
   router's handles stay valid), restores its prefix cache from the
   newest complete snapshot (``cfg.prefix_snapshot_root``), and rejoins
   rotation through the router's half-open probes
   (``Replica.probe`` — ``serving/replica_restored``).

Wire-up::

    router = ReplicaRouter([eng_a, eng_b])
    sup = FleetSupervisor(router, engine_factory=make_engine)
    ...
    router.run_to_completion()     # deaths drain+restart transparently

The supervisor installs itself as the router's ``failure_hook`` (fires
the moment ``step_all`` catches a dead engine) and ``pump()`` is the
poll-style equivalent for deaths that happen outside a router step
(e.g. during a cache snapshot).  ``snapshot_caches()`` runs the
periodic prefix-cache persistence pass for every replica configured
with a snapshot root.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.resilience import backoff as _backoff
from ..distributed.resilience.errors import (EngineDeadError,
                                             PeerUnreachableError,
                                             TransportClosedError,
                                             TransportError,
                                             WeightTransferError)
from ..profiler import metrics as _metrics
from ..profiler import timeline as _timeline
from ..profiler import tracing as _tracing
from .router import ReplicaRouter
from .serving import EngineOverloadedError, ServingEngine

__all__ = ["FleetSupervisor", "FleetSupervisorConfig",
           "LoopbackTransport"]

_m_restarts = _metrics.counter("serving/replica_restarts")
_m_drains = _metrics.counter("serving/drains")
_m_drain_requeues = _metrics.counter("serving/drain_requeues")
_m_cross_drains = _metrics.counter("serving/cross_host_drains")
_m_cross_migrations = _metrics.counter("serving/cross_host_migrations")


class LoopbackTransport:
    """In-process stand-in for ``TensorTransport`` between co-hosted
    engines: same ``send(arr, dst, channel)`` / ``recv(src, channel)``
    surface, frames carried through a FIFO per channel, each a copy (a
    tensor stays a tensor of its dtype, bf16 included; anything else
    becomes a numpy array).  One instance per hand-off, so an aborted
    migration can never leave stale frames for the next one."""

    def __init__(self):
        self._q: Dict[str, deque] = {}

    def send(self, arr, dst: int, channel: str = "") -> None:
        frame = arr.detach().clone() if isinstance(arr, torch.Tensor) \
            else np.array(arr, copy=True)
        self._q.setdefault(channel, deque()).append(frame)

    def recv(self, src: int, channel: str = ""):
        q = self._q.get(channel)
        if not q:
            raise TransportClosedError(
                f"loopback channel {channel!r} has no pending frame")
        return q.popleft()


@dataclass
class FleetSupervisorConfig:
    """Knobs for the drain + restart loop.

    ``max_restarts`` bounds restarts PER REPLICA (a crash-looping
    replica eventually stays demoted rather than flapping);
    ``backoff_base_s``/``backoff_cap_s`` shape the bounded exponential
    restart delay; ``migrate=False`` forces the requeue-only drain
    (operationally: the fleet has no KV hand-off path);
    ``snapshot_keep`` is the retention for ``snapshot_caches``."""

    max_restarts: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 2.0
    migrate: bool = True
    restart: bool = True
    snapshot_keep: int = 2


class FleetSupervisor:
    """Watches a ``ReplicaRouter``'s replicas and self-heals engine
    death: drain in-flight requests to healthy peers, restart the dead
    engine under backoff, let half-open probes re-admit it."""

    def __init__(self, router: ReplicaRouter,
                 engine_factory: Callable[[int], ServingEngine],
                 cfg: Optional[FleetSupervisorConfig] = None,
                 handoff_factory: Optional[
                     Callable[[int, int],
                              Tuple[object, object, int, int]]] = None):
        self.router = router
        self.engine_factory = engine_factory
        self.cfg = cfg or FleetSupervisorConfig()
        # cross-host KV hand-off: called with (src_idx, dst_idx), returns
        # (send_tp, recv_tp, dst_rank, src_rank) — a real TensorTransport
        # pair for fleets spanning hosts.  None keeps the in-process
        # LoopbackTransport default for co-hosted engines.
        self.handoff_factory = handoff_factory
        self.restarts: List[int] = [0] * len(router.replicas)
        # handles drained (migrated or requeued) across this
        # supervisor's lifetime — the observable idempotency record
        self.drained_handles: set = set()
        # live weight publishing: a WeightPublisher installs its
        # catch_up here so a replica rebuilt by restart() (which comes
        # back at the factory's build-time version) is brought to the
        # fleet's committed version epoch BEFORE it rejoins rotation —
        # a replica offline during a rollout converges on restart
        self.weight_catchup: Optional[Callable[[ServingEngine],
                                               None]] = None
        router.failure_hook = self.on_failure

    # -- elastic fleet membership ------------------------------------------
    def _ensure_slot(self, idx: int) -> None:
        # the autoscaler appends replicas after construction: grow the
        # per-replica restart ledger to cover them
        while len(self.restarts) <= idx:
            self.restarts.append(0)

    def adopt_replica(self, idx: int) -> None:
        """Take a replica spawned AFTER construction (autoscaler
        scale-up) into the supervision cadence: restart budget,
        cache-snapshot pass, and pump() recovery all cover it from
        here on."""
        self._ensure_slot(idx)
        _tracing.flight_note(
            "replica_adopted", replica=self.router.replicas[idx].name,
            idx=idx)

    # -- failure entry points --------------------------------------------
    def on_failure(self, idx: int) -> None:
        """Full recovery for replica ``idx``: dump the flight recorder
        (the killed engine's black box: recent spans, notes, counter
        deltas, full metrics snapshot), drain, then restart."""
        rep = self.router.replicas[idx]
        _tracing.flight_dump(
            "engine_dead", replica=rep.name,
            engine=getattr(rep.engine, "name", "?"),
            host=rep.host_id, replica_idx=idx)
        _timeline.emit_event("replica_failed", replica=rep.name,
                             host=rep.host_id)
        self.drain(idx)
        if self.cfg.restart:
            self.restart(idx)

    def pump(self) -> List[int]:
        """One supervision pass outside the router's step loop: recover
        replicas whose engine died elsewhere (e.g. mid-snapshot) and
        probe demoted ones.  Returns the indices recovered."""
        recovered = []
        for idx, rep in enumerate(self.router._snapshot()):
            if getattr(rep, "retired", False):
                continue       # left the fleet: never restarted
            if getattr(rep.engine, "dead", False):
                rep.mark_unhealthy()
                self.on_failure(idx)
                recovered.append(idx)
            elif rep._demoted:
                rep.probe()
        return recovered

    # -- drain ------------------------------------------------------------
    def _capacity(self, engine: ServingEngine) -> int:
        cap = len(engine._free_pages)
        if engine._prefix_cache is not None:
            cap += engine._prefix_cache.evictable_count()
        return cap

    def _remap(self, handle: Optional[int], src_idx: int, src_rid: int,
               dst_idx: int, dst_rid: int) -> None:
        if handle is None:
            return
        self.router._by_engine.pop((src_idx, src_rid), None)
        self.router._handles[handle] = (dst_idx, dst_rid)
        self.router._by_engine[(dst_idx, dst_rid)] = handle
        self.drained_handles.add(handle)
        self.router.moved_handles.add(handle)

    def _off_host(self, src_idx: int, dst_idx: int) -> bool:
        src_h = self.router.replicas[src_idx].host_id
        dst_h = self.router.replicas[dst_idx].host_id
        return src_h is not None and dst_h is not None and src_h != dst_h

    def _migrate_one(self, src_idx: int, rid: int,
                     targets: List[int]) -> bool:
        """Ship one decode-tip request's KV pages to the least-loaded
        peer with pool room.  True on success (handle remapped)."""
        from . import disagg

        src = self.router.replicas[src_idx].engine
        r = src._requests[rid]
        for dst_idx in targets:
            dst = self.router.replicas[dst_idx].engine
            if self._capacity(dst) < len(r.pages):
                continue
            # check the peer can serve this stream's pinned version
            # BEFORE shipping: migrate_request finishes the source copy
            # as its last act, so a version refusal at the receiver
            # would orphan the request
            if hasattr(dst, "has_weight_version") \
                    and not dst.has_weight_version(
                        int(getattr(r, "weight_version", 0) or 0)):
                continue
            if hasattr(src, "migrate_out") and hasattr(dst,
                                                       "migrate_in"):
                # process-isolated pair (remote_replica.RemoteEngine):
                # the parent orchestrates but the KV pages travel
                # CHILD-TO-CHILD over the shared transport world —
                # CRC-checked and retransmitted on drop/corrupt like
                # any frame
                try:
                    src.migrate_out(rid, dst)
                    new_rid = dst.migrate_in(src)
                except (PeerUnreachableError, EngineDeadError):
                    # a dead source process has no end to ship from;
                    # the requeue fallback rebuilds from the parent's
                    # admission mirror instead
                    return False
            else:
                if self.handoff_factory is not None:
                    send_tp, recv_tp, dst_rank, src_rank = \
                        self.handoff_factory(src_idx, dst_idx)
                else:
                    tp = LoopbackTransport()
                    send_tp, recv_tp, dst_rank, src_rank = tp, tp, 1, 0
                try:
                    disagg.migrate_request(src, rid, send_tp,
                                           dst=dst_rank)
                except (PeerUnreachableError, EngineDeadError):
                    # the dying engine cannot ship its pages at all
                    # (the drop@migrate failure mode): no peer will do
                    # better
                    return False
                new_rid = disagg.receive_request(dst, recv_tp,
                                                 src=src_rank)
            h = self.router._by_engine.get((src_idx, rid))
            self._remap(h, src_idx, rid, dst_idx, new_rid)
            _m_drains.inc()
            if self._off_host(src_idx, dst_idx):
                _m_cross_drains.inc()
                _m_cross_migrations.inc()
            return True
        return False

    def _requeue_one(self, src_idx: int, rid: int,
                     targets: List[int]) -> bool:
        """Fallback drain: re-admit the request's PROMPT on a peer under
        its origin salt identity.  Sampling salts depend only on (seed,
        rid, token index), so the peer deterministically regenerates the
        same stream the dead engine was producing — token-bitwise equal
        to an uninterrupted run, just re-paying the prefill."""
        src = self.router.replicas[src_idx].engine
        r = src._requests[rid]
        # the fleet-wide retry budget covers drain-requeues too (each
        # re-pays a full prefill); migrations are exempt — they ship
        # work already done instead of redoing it
        gate = getattr(self.router, "retry_gate", None)
        if gate is not None and not gate("drain"):
            return False
        origin_seed = src.seed if r.salt_seed is None else r.salt_seed
        wv = int(getattr(r, "weight_version", 0) or 0)
        for dst_idx in targets:
            dst = self.router.replicas[dst_idx].engine
            # version-bitwise identity across the drain: the peer must
            # serve (or retain) the version this stream started on
            if hasattr(dst, "has_weight_version") \
                    and not dst.has_weight_version(wv):
                continue
            try:
                new_rid = dst.add_request(
                    list(r.prompt), max_new_tokens=r.max_new,
                    sampling=r.sampling, eos_token_id=r.eos_token_id,
                    tenant=r.tenant)
            except (EngineOverloadedError, EngineDeadError):
                continue
            if hasattr(dst, "pin_weight_version"):
                dst.pin_weight_version(new_rid, wv)
            req = dst._requests[new_rid]
            req.salt_rid = r.salt_rid
            req.salt_seed = int(origin_seed)
            if r.trace is not None:
                # the drained request keeps its trace: a requeue span
                # bridges the dead engine's spans to the peer's
                now = time.perf_counter()
                req.trace = _tracing.record_span(
                    "serving::requeue", now, now, parent=r.trace,
                    args={"rid": new_rid, "engine": dst.name,
                          "from": getattr(src, "name", "?")})
            h = self.router._by_engine.get((src_idx, rid))
            self._remap(h, src_idx, rid, dst_idx, new_rid)
            # single ownership: the source copy finishes NOW, before the
            # peer copy takes a step — never decoded twice
            r.done = True
            src._release(r)
            _m_drain_requeues.inc()
            if self._off_host(src_idx, dst_idx):
                _m_cross_drains.inc()
            return True
        return False

    def drain(self, idx: int, migrate: Optional[bool] = None) -> int:
        """Move every in-flight request off replica ``idx``: KV
        migration for decode-tip requests, requeue for the rest (and
        for hand-offs the dying engine fails to ship).  Returns how
        many requests found a new home.  ``migrate`` overrides
        ``cfg.migrate`` for this drain only — the autoscaler passes
        False when the retiring replica's PROCESS died mid-drain
        (kill@retire): an in-process engine fault leaves its KV pages
        readable in host memory, but a dead process has no source end
        to ship them, so only the requeue path (which rebuilds from
        admission metadata) is honest there."""
        use_migrate = self.cfg.migrate if migrate is None else migrate
        src = self.router.replicas[idx].engine
        targets = self.router._ordered(
            exclude=idx,
            prefer_off_host=self.router.replicas[idx].host_id)
        moved = 0
        for rid, r in list(src._requests.items()):
            if r.done or r.timed_out:
                continue       # finished/evicted before death: nothing live
            migrated = False
            if use_migrate and targets \
                    and r.length - r.cached == 1:
                try:
                    migrated = self._migrate_one(idx, rid, targets)
                except (TransportError, ValueError):
                    migrated = False
            if not migrated and targets:
                migrated = self._requeue_one(idx, rid, targets)
            if migrated:
                moved += 1
            # else: no healthy peer with room — the request stays on the
            # dead engine and results() reports it honestly as stuck
        return moved

    # -- restart ----------------------------------------------------------
    def restart(self, idx: int) -> bool:
        """Rebuild replica ``idx``'s engine under bounded exponential
        backoff.  The new engine inherits the dead one's name/rank,
        finished results, and rid namespace (router handles stay
        valid); with a snapshot root configured it restores its prefix
        cache during construction.  The replica stays demoted until the
        half-open probes pass.  False once ``max_restarts`` is spent —
        the replica is left out of rotation for good."""
        self._ensure_slot(idx)
        if self.restarts[idx] >= self.cfg.max_restarts:
            return False
        rep = self.router.replicas[idx]
        if getattr(rep, "retired", False):
            return False       # retired replicas are not rebuilt
        old = rep.engine
        time.sleep(_backoff.delay(self.restarts[idx],
                                  base=self.cfg.backoff_base_s,
                                  cap=self.cfg.backoff_cap_s))
        self.restarts[idx] += 1
        new = self.engine_factory(idx)
        new.name = getattr(old, "name", new.name)
        new.fault_rank = getattr(old, "fault_rank", 0)
        # a factory may rebuild the replica on a DIFFERENT host (the
        # old one is gone): adopt the new engine's failure domain
        new_host = getattr(new, "host_id", None)
        if new_host is not None:
            rep.host_id = new_host
        # rid continuity: finished requests keep answering results(),
        # and fresh rids never collide with handles minted pre-death
        new._next_rid = max(new._next_rid, old._next_rid)
        for rid, r in old._requests.items():
            if r.done and rid not in new._requests:
                new._requests[rid] = r
        new.requeue_hook = self.router._make_requeue_hook(idx)
        # the replacement engine keeps writing the replica's per-replica
        # metric series, not a fresh (or the global) one
        if hasattr(new, "set_metrics_namespace"):
            new.set_metrics_namespace(
                getattr(old, "metrics_namespace", None) or rep.name)
        # weight catch-up: the factory rebuilt the engine at its
        # build-time weight version — replay the fleet's committed
        # version onto it before it takes traffic, so a replica that
        # missed a rollout (offline, drop@publish) converges here
        if self.weight_catchup is not None:
            try:
                self.weight_catchup(new)
            except (TransportError, EngineDeadError,
                    WeightTransferError, ValueError, KeyError):
                _tracing.flight_note("weight_catchup_failed",
                                     replica=rep.name)
        rep.engine = new
        _m_restarts.inc()
        _tracing.flight_note("replica_restart", replica=rep.name,
                             attempt=self.restarts[idx])
        return True

    # -- cache persistence cadence ----------------------------------------
    def snapshot_caches(self, root_override: Optional[str] = None):
        """Persist every replica's prefix cache (those with a snapshot
        root configured, or all under ``root_override``).  Returns
        {replica name: snapshot path} for the snapshots written.  A
        replica felled mid-snapshot (``kill@cache_save``) is recovered
        like any other death — the torn directory is swept at its next
        restore."""
        out = {}
        for idx, rep in enumerate(self.router._snapshot()):
            eng = rep.engine
            root = root_override or eng.cfg.prefix_snapshot_root
            if eng._prefix_cache is None or not root \
                    or getattr(eng, "dead", False) \
                    or getattr(rep, "retired", False):
                continue
            try:
                path = eng.save_prefix_cache(
                    root=root, keep=self.cfg.snapshot_keep)
            except EngineDeadError:
                rep.mark_unhealthy()
                self.on_failure(idx)
                continue
            if path is not None:
                out[rep.name] = path
        return out
