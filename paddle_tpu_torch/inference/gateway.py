"""FleetGateway: the overload-safe traffic tier above ReplicaRouter (port
of paddle_tpu/inference/gateway.py).

Below the load balancer sit the replicas, the prefix cache, the disagg
hand-off, supervision, cross-host failover and fleet tracing.  This
module is the front door that defends that fleet against
its own traffic, turning overload from a failure mode into a degraded-
but-correct mode:

1. **SLO classes.**  Every request carries a class —
   ``interactive`` / ``batch`` / ``best_effort`` by default — mapped
   onto the engine's existing ``deadline_s``/requeue machinery: the
   class's deadline is applied at DISPATCH (router admission), not at
   gateway enqueue, so a deferred batch request does not burn its
   engine deadline sitting in the gateway queue.

2. **Per-tenant admission.**  Each tenant has a token bucket
   (``rate``/``burst``) at submit and a weighted-fair virtual-time
   dequeue across tenants, replacing the engines' flat ``max_queue``
   shed: a 10x burst from one tenant is throttled and queued against
   that tenant's own share — it cannot starve a polite tenant's
   interactive traffic (``gateway/throttled``).

3. **Retry budget.**  A fleet-wide deposit/withdraw budget
   (``RetryBudget`` — each successful admission deposits a fraction of
   a retry token; every reroute/requeue/drain-requeue and every
   gateway re-dispatch withdraws one) is installed as the router's
   ``retry_gate``, so overload can never amplify into a retry storm:
   once the budget is dry, retries stop (``serving/requeue_exhausted``)
   and re-dispatches reject with a structured ``GatewayRejectedError``
   carrying ``retry_after_s`` (``gateway/retry_budget_denied``).

4. **Brownout ladder.**  Live pressure — mean replica ``load_score``
   (the same occupancy + KV-utilization the ``serving/*`` gauges
   export) and the per-replica digest p95 TTFT from the replicas'
   child registries — drives an explicit degradation ladder::

       0 normal
       1 defer_batch        batch class held in the gateway queue
       2 clamp              non-interactive max_new_tokens clamped
       3 shed_best_effort   best-effort shed with retry-after
       4 reject             non-interactive admission rejected

   Each measure engages one level per evaluation while pressure holds
   above the ENTER threshold, and unwinds hysteretically — one level
   per ``hysteresis`` CONSECUTIVE calm evaluations below the (lower)
   EXIT threshold — so the ladder cannot flap.  Interactive traffic is
   protected at every rung: it is never deferred, clamped, or shed.

5. **Session affinity + tenant cache namespaces.**  Multi-turn
   sessions route to the replica whose prefix cache already holds
   their prefix chain (``PrefixCache.probe`` — a non-acquiring
   coverage score), turning ``serving/prefix_hit_rate`` into a
   placement signal (``gateway/affinity_hits``).  Each tenant's cache
   reads/writes live in its own namespace with a page quota, so
   tenants never hit each other's prompts and one tenant cannot squat
   the shared page pool.

Determinism: the gateway pins every admitted request's sampling-salt
identity to its ``stream_key`` (caller-supplied, default the ticket
id) and the gateway's ``salt_seed`` — device-side salts depend only on
(seed, key, position), so a stream's tokens are bitwise-identical
across placements, requeues, drains, and load levels.  The ``overload``
chaos pattern (``PT_FAULT_PLAN="overload@admit%1.0:x=4"``, consulted
once per arriving request) turns each arrival into ``x`` by injecting
synthetic best-effort clones under the ``_storm`` tenant; completed
streams stay identical to an unloaded run while interactive TTFT holds.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..distributed.resilience import faults as _faults
from ..distributed.resilience.errors import GatewayRejectedError
from ..profiler import metrics as _metrics
from ..profiler import timeline as _timeline
from ..profiler import tracing as _tracing
from .router import ReplicaRouter
from .serving import EngineOverloadedError

__all__ = ["FleetGateway", "GatewayConfig", "SLOClassConfig",
           "TenantConfig", "BrownoutConfig", "BrownoutController",
           "TokenBucket", "RetryBudget", "BROWNOUT_LEVELS",
           "L_NORMAL", "L_DEFER_BATCH", "L_CLAMP", "L_SHED", "L_REJECT"]

# the brownout ladder, least to most degraded
BROWNOUT_LEVELS = ("normal", "defer_batch", "clamp",
                   "shed_best_effort", "reject")
L_NORMAL, L_DEFER_BATCH, L_CLAMP, L_SHED, L_REJECT = range(5)

_m_admitted = _metrics.counter("gateway/admitted")
_m_rejected = _metrics.counter("gateway/rejected")
_m_throttled = _metrics.counter("gateway/throttled")
_m_shed = _metrics.counter("gateway/shed")
_m_clamped = _metrics.counter("gateway/clamped")
_m_deferrals = _metrics.counter("gateway/deferrals")
_m_budget_denied = _metrics.counter("gateway/retry_budget_denied")
_m_affinity = _metrics.counter("gateway/affinity_hits")
_m_storm = _metrics.counter("gateway/storm_injected")
_m_level = _metrics.gauge("gateway/brownout_level")
_m_transitions = _metrics.counter("gateway/brownout_transitions")
_m_depth = _metrics.gauge("gateway/queue_depth")
_m_load = _metrics.gauge("gateway/load_score")

# reason-coded terminal outcomes: every request the gateway touches
# resolves to EXACTLY ONE of these (the SLO engine's attainment input)
_OUTCOME_COUNTERS = {
    "completed": _metrics.counter("gateway/outcome/completed"),
    "deadline_missed": _metrics.counter("gateway/outcome/deadline_missed"),
    "shed": _metrics.counter("gateway/outcome/shed"),
    "rejected": _metrics.counter("gateway/outcome/rejected"),
    "drained": _metrics.counter("gateway/outcome/drained"),
}


@dataclass
class SLOClassConfig:
    """One SLO class: the engine deadline its requests dispatch with,
    its intra-tenant priority (lower dispatches first), and which
    brownout measures may touch it.  ``protected`` traffic is never
    deferred, clamped, shed, or rejected by the ladder."""

    deadline_s: Optional[float] = None
    priority: int = 1
    deferrable: bool = False   # level >= 1 holds it in the gateway queue
    sheddable: bool = False    # level >= 3 sheds it with retry-after
    protected: bool = False    # immune to every brownout measure


def default_classes() -> Dict[str, SLOClassConfig]:
    return {
        "interactive": SLOClassConfig(deadline_s=2.0, priority=0,
                                      protected=True),
        "batch": SLOClassConfig(deadline_s=30.0, priority=1,
                                deferrable=True),
        "best_effort": SLOClassConfig(deadline_s=None, priority=2,
                                      sheddable=True),
    }


@dataclass
class TenantConfig:
    """One tenant's admission contract: token-bucket ``rate``
    (requests/s) and ``burst`` capacity at submit, weighted-fair
    ``weight`` at dequeue, a bound on how many of its requests may sit
    queued, and its prefix-cache page quota per replica."""

    rate: float = 100.0
    burst: float = 20.0
    weight: float = 1.0
    max_queued: int = 1024
    page_quota: Optional[int] = None


@dataclass
class BrownoutConfig:
    """Ladder thresholds.  ``enter_load``/``exit_load`` are mean
    replica ``load_score`` (0..2: batch occupancy + KV utilization);
    ``enter_ttft_ms``/``exit_ttft_ms`` gate on the fleet's digest p95
    TTFT when set.  Exit thresholds sit BELOW enter thresholds and
    step-down needs ``hysteresis`` consecutive calm evaluations —
    classic hysteresis, so the ladder never flaps on a noisy signal."""

    enter_load: float = 1.5
    exit_load: float = 1.0
    enter_ttft_ms: Optional[float] = None
    exit_ttft_ms: Optional[float] = None
    hysteresis: int = 3
    clamp_max_new: int = 4
    retry_after_s: float = 1.0
    # sustained-overload postmortem trigger: after this many
    # CONSECUTIVE evaluations holding the reject rung, the flight
    # recorder dumps once per episode (symmetric with the engine-death
    # and quorum-loss triggers)
    reject_dump_after: int = 3


@dataclass
class GatewayConfig:
    classes: Dict[str, SLOClassConfig] = field(
        default_factory=default_classes)
    tenants: Dict[str, TenantConfig] = field(default_factory=dict)
    default_tenant: TenantConfig = field(default_factory=TenantConfig)
    brownout: BrownoutConfig = field(default_factory=BrownoutConfig)
    # retry budget: each admission deposits `retry_deposit` of a token
    # (capped at `retry_cap`); every retry withdraws one; `retry_floor`
    # seeds the budget so a cold gateway can still absorb a blip
    retry_cap: float = 20.0
    retry_deposit: float = 0.1
    retry_floor: float = 2.0
    # waiting in the gateway queue is NOT retrying: an entry's first
    # `free_redispatches` saturation backoffs are free (normal queue
    # drain); only an entry that STILL cannot place after that burns
    # budget per further attempt — and rejects, structured, when the
    # budget is dry
    free_redispatches: int = 8
    # sampling-salt seed pinned on every admitted request (with the
    # request's stream_key) — the fleet-wide determinism identity
    salt_seed: int = 0
    # tenant name synthetic overload-chaos clones are booked under
    storm_tenant: str = "_storm"


class TokenBucket:
    """Deterministic token bucket (injectable clock for tests)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def _refill(self):
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def time_to(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens exist (the Retry-After hint)."""
        self._refill()
        if self._tokens >= n:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self._tokens) / self.rate


class RetryBudget:
    """Fleet-wide retry budget (the Finagle retryBudget shape): each
    successful admission DEPOSITS a fraction of a retry token, each
    retry WITHDRAWS one, and a small floor keeps a cold/quiet fleet
    able to absorb a blip.  Once dry, retries are vetoed until fresh
    admissions re-fund it — retries can never outnumber
    ``deposit_ratio`` of real traffic, so overload cannot compound
    itself."""

    def __init__(self, cap: float = 20.0, deposit: float = 0.1,
                 floor: float = 2.0):
        self.cap = float(cap)
        self.deposit_ratio = float(deposit)
        self.floor = float(floor)
        self._tokens = float(floor)

    def deposit(self):
        self._tokens = min(self.cap, self._tokens + self.deposit_ratio)

    def take(self, n: float = 1.0) -> bool:
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def balance(self) -> float:
        return self._tokens


class BrownoutController:
    """The ladder's state machine, separated from the gateway so the
    transition/hysteresis behavior unit-tests on synthetic pressure.
    ``observe(load, ttft_p95_ms)`` moves at most one level per call:
    UP whenever pressure is at/above an enter threshold, DOWN one level
    only after ``hysteresis`` consecutive observations at/below every
    exit threshold."""

    def __init__(self, cfg: Optional[BrownoutConfig] = None):
        self.cfg = cfg or BrownoutConfig()
        self.level = L_NORMAL
        self.max_level = L_NORMAL
        self.transitions: List[Tuple[int, int]] = []
        self._calm = 0
        self._reject_held = 0     # consecutive evals AT the reject rung
        self._reject_dumped = False

    def observe(self, load: float,
                ttft_p95_ms: Optional[float] = None) -> int:
        cfg = self.cfg
        hot = load >= cfg.enter_load or (
            cfg.enter_ttft_ms is not None and ttft_p95_ms is not None
            and ttft_p95_ms >= cfg.enter_ttft_ms)
        calm = load <= cfg.exit_load and (
            cfg.exit_ttft_ms is None or ttft_p95_ms is None
            or ttft_p95_ms <= cfg.exit_ttft_ms)
        if hot:
            self._calm = 0
            self._move(min(self.level + 1, L_REJECT))
        elif calm and self.level > L_NORMAL:
            self._calm += 1
            if self._calm >= cfg.hysteresis:
                self._calm = 0
                self._move(self.level - 1)
        else:
            self._calm = 0
        if self.level >= L_REJECT:
            # reaching AND HOLDING the reject rung is the sustained-
            # overload incident worth a black box: dump once per
            # episode with the pre-storm timeline windows attached
            self._reject_held += 1
            if self._reject_held >= cfg.reject_dump_after \
                    and not self._reject_dumped:
                self._reject_dumped = True
                _tracing.flight_dump(
                    "brownout_reject_sustained",
                    held_evals=self._reject_held, load=load,
                    ttft_p95_ms=ttft_p95_ms)
        else:
            self._reject_held = 0
            self._reject_dumped = False
        # refresh every observe, not just on transitions: the gauge is
        # module-global and a fresh controller must not inherit a
        # previous gateway's last level
        _m_level.set(self.level)
        return self.level

    def _move(self, to: int):
        if to == self.level:
            return
        now = time.perf_counter()
        _tracing.record_span(
            "gateway::brownout", now, now,
            args={"from": BROWNOUT_LEVELS[self.level],
                  "to": BROWNOUT_LEVELS[to]})
        self.transitions.append((self.level, to))
        _timeline.emit_event("gateway_brownout",
                             frm=BROWNOUT_LEVELS[self.level],
                             to=BROWNOUT_LEVELS[to])
        self.level = to
        self.max_level = max(self.max_level, to)
        _m_transitions.inc()
        _m_level.set(to)


class _Pending:
    __slots__ = ("ticket", "prompt", "max_new", "sampling",
                 "eos_token_id", "tenant", "slo", "session",
                 "stream_key", "submit_t", "attempts", "synthetic")

    def __init__(self, ticket, prompt, max_new, sampling, eos_token_id,
                 tenant, slo, session, stream_key, synthetic=False):
        self.ticket = ticket
        self.prompt = list(int(t) for t in prompt)
        self.max_new = max_new
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.tenant = tenant
        self.slo = slo
        self.session = session
        self.stream_key = stream_key
        self.submit_t = time.perf_counter()
        self.attempts = 0          # dispatch attempts so far
        self.synthetic = synthetic  # injected by the overload chaos


class _Ticket:
    __slots__ = ("tenant", "slo", "handle", "stream_key", "session",
                 "rejected", "clamped", "deferred", "submit_t",
                 "first_tok_t", "synthetic", "outcome", "outcome_reason")

    def __init__(self, tenant, slo, stream_key, session, synthetic):
        self.tenant = tenant
        self.slo = slo
        self.handle = None
        self.stream_key = stream_key
        self.session = session
        self.rejected: Optional[GatewayRejectedError] = None
        self.clamped = False
        self.deferred = False
        self.submit_t = time.perf_counter()
        self.first_tok_t = None
        self.synthetic = synthetic
        # exactly-once terminal outcome (the SLO engine's input)
        self.outcome: Optional[str] = None
        self.outcome_reason: Optional[str] = None


class FleetGateway:
    """SLO-class admission, per-tenant fairness, retry budgeting, and
    brownout degradation over a ``ReplicaRouter``.

    gw = FleetGateway(router, GatewayConfig(...))
    t = gw.submit(prompt, tenant="acme", slo="interactive",
                  session="chat-42")      # -> ticket (or raises
                                          #    GatewayRejectedError)
    gw.run_to_completion()
    gw.results()[t]                       # generated tokens
    """

    def __init__(self, router: ReplicaRouter,
                 cfg: Optional[GatewayConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.cfg = cfg or GatewayConfig()
        self._clock = clock
        self.brownout = BrownoutController(self.cfg.brownout)
        self.retry_budget = RetryBudget(self.cfg.retry_cap,
                                        self.cfg.retry_deposit,
                                        self.cfg.retry_floor)
        # the fleet-wide budget gates the router's reroute/requeue and
        # the supervisor's drain-requeue paths
        router.retry_gate = self._retry_gate
        self._buckets: Dict[str, TokenBucket] = {}
        # tenant -> slo -> FIFO of _Pending, plus weighted-fair vtime
        self._queues: Dict[str, Dict[str, deque]] = {}
        self._vtime: Dict[str, float] = {}
        self._tickets: Dict[int, _Ticket] = {}
        self._by_handle: Dict[int, int] = {}
        self._next_ticket = 0
        # (tenant, session) -> replica idx of the session's last turn
        self._sessions: Dict[Tuple[str, Optional[str]], int] = {}
        self.shed_by_class: Dict[str, int] = {}
        # outcome listeners: called with one reason-coded event dict
        # per terminal outcome (profiler.slo.SLOTracker.attach
        # subscribes here); pre-queue rejections carry ticket=None
        self.outcome_listeners: List[Callable[[dict], None]] = []
        self._apply_page_quotas()

    # -- config plumbing ---------------------------------------------------
    def _tenant_cfg(self, tenant: str) -> TenantConfig:
        if tenant == self.cfg.storm_tenant \
                and tenant not in self.cfg.tenants:
            # chaos clones model EXTERNAL load: they are not rate-
            # limited at the bucket (the ladder is what sheds them)
            return TenantConfig(rate=float("inf"), burst=float("inf"),
                                weight=1.0, max_queued=1 << 30)
        return self.cfg.tenants.get(tenant, self.cfg.default_tenant)

    def _class_cfg(self, slo: str) -> SLOClassConfig:
        try:
            return self.cfg.classes[slo]
        except KeyError:
            raise ValueError(
                f"unknown SLO class {slo!r} (configured: "
                f"{', '.join(sorted(self.cfg.classes))})") from None

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            tc = self._tenant_cfg(tenant)
            b = TokenBucket(tc.rate, tc.burst, clock=self._clock)
            self._buckets[tenant] = b
        return b

    def _apply_page_quotas(self):
        """Push each configured tenant's prefix-cache page quota onto
        every replica's cache (per-replica namespaced quotas)."""
        for rep in self.router.replicas:
            cache = getattr(rep.engine, "_prefix_cache", None)
            if cache is None:
                continue
            for name, tc in self.cfg.tenants.items():
                if tc.page_quota is not None:
                    cache.set_quota(name, tc.page_quota)

    def notify_fleet_changed(self):
        """The placement set changed under live traffic (autoscaler
        resize): push tenant page quotas onto any replica that joined
        since construction, and forget session affinity pointing at
        replicas that can no longer take placements — the next turn
        re-homes on whatever the prefix probe finds."""
        self._apply_page_quotas()
        reps = self.router._snapshot()
        stale = [k for k, idx in self._sessions.items()
                 if idx >= len(reps) or not reps[idx].placeable()]
        for k in stale:
            del self._sessions[k]

    # -- retry budget ------------------------------------------------------
    def _retry_gate(self, flavor: str) -> bool:
        ok = self.retry_budget.take()
        if not ok:
            _m_budget_denied.inc()
        return ok

    # -- admission ---------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens: int = 8,
               sampling=None, eos_token_id=None, tenant: str = "default",
               slo: str = "interactive", session: Optional[str] = None,
               stream_key: Optional[int] = None) -> int:
        """Admit one request into the gateway queue; returns a ticket.
        Raises ``GatewayRejectedError`` (with ``retry_after_s``) when
        the tenant's token bucket is dry, its queue is full, or the
        brownout ladder refuses the class.  ``stream_key`` is the
        request's deterministic sampling identity (default: the
        ticket) — keep it stable across runs for bitwise-reproducible
        streams."""
        act = _faults.injector.on_event("admit", 0)
        if act is not None:
            if act.kind == "delay":
                time.sleep(act.delay_ms / 1e3)
            elif act.kind == "drop":
                # the client vanished between SYN and request body
                self._count_reject(tenant, slo)
                self._emit_outcome("rejected", tenant, slo,
                                   reason="injected_drop")
                raise GatewayRejectedError("injected_drop",
                                           tenant=tenant, slo_class=slo)
            elif act.kind == "overload":
                self._inject_storm(prompt_tokens, max_new_tokens,
                                   sampling, eos_token_id,
                                   act.factor - 1)
        return self._admit(prompt_tokens, max_new_tokens, sampling,
                           eos_token_id, tenant, slo, session,
                           stream_key, synthetic=False)

    def _inject_storm(self, prompt, max_new, sampling, eos, n: int):
        """The overload chaos pattern: ``n`` synthetic best-effort
        clones of the arriving request, booked under the storm tenant.
        Clones that the ladder sheds are counted, not raised."""
        for i in range(n):
            _m_storm.inc()
            try:
                self._admit(prompt, max_new, sampling, eos,
                            self.cfg.storm_tenant, "best_effort",
                            session=None, stream_key=None,
                            synthetic=True)
            except GatewayRejectedError:
                pass           # already counted by _count_reject

    def _admit(self, prompt, max_new, sampling, eos, tenant, slo,
               session, stream_key, synthetic) -> int:
        cls = self._class_cfg(slo)
        lvl = self.brownout.level
        retry_after = self.cfg.brownout.retry_after_s
        if not cls.protected:
            if cls.sheddable and lvl >= L_SHED:
                self._count_reject(tenant, slo, shed=True)
                self._emit_outcome("shed", tenant, slo,
                                   reason="brownout_shed",
                                   synthetic=synthetic)
                raise GatewayRejectedError(
                    "brownout_shed", tenant=tenant, slo_class=slo,
                    retry_after_s=retry_after)
            if lvl >= L_REJECT:
                self._count_reject(tenant, slo, shed=True)
                self._emit_outcome("rejected", tenant, slo,
                                   reason="brownout_reject",
                                   synthetic=synthetic)
                raise GatewayRejectedError(
                    "brownout_reject", tenant=tenant, slo_class=slo,
                    retry_after_s=retry_after)
        bucket = self._bucket(tenant)
        if not bucket.try_take():
            _m_throttled.inc()
            self._count_reject(tenant, slo)
            self._emit_outcome("rejected", tenant, slo,
                               reason="tenant_rate", synthetic=synthetic)
            raise GatewayRejectedError(
                "tenant_rate", tenant=tenant, slo_class=slo,
                retry_after_s=bucket.time_to())
        queues = self._queues.setdefault(
            tenant, {name: deque() for name in self.cfg.classes})
        tc = self._tenant_cfg(tenant)
        if sum(len(q) for q in queues.values()) >= tc.max_queued:
            self._count_reject(tenant, slo)
            self._emit_outcome("rejected", tenant, slo,
                               reason="tenant_queue_full",
                               synthetic=synthetic)
            raise GatewayRejectedError(
                "tenant_queue_full", tenant=tenant, slo_class=slo,
                retry_after_s=retry_after)
        ticket = self._next_ticket
        self._next_ticket += 1
        if stream_key is None:
            stream_key = ticket
        tk = _Ticket(tenant, slo, stream_key, session, synthetic)
        self._tickets[ticket] = tk
        entry = _Pending(ticket, prompt, max_new, sampling, eos,
                         tenant, slo, session, stream_key,
                         synthetic=synthetic)
        queues.setdefault(slo, deque()).append(entry)
        now = time.perf_counter()
        _tracing.record_span(
            "gateway::admit", entry.submit_t, now,
            args={"ticket": ticket, "tenant": tenant, "class": slo,
                  "brownout": BROWNOUT_LEVELS[lvl]})
        return ticket

    def _count_reject(self, tenant: str, slo: str, shed: bool = False):
        _m_rejected.inc()
        if shed:
            _m_shed.inc()
            self.shed_by_class[slo] = self.shed_by_class.get(slo, 0) + 1
        now = time.perf_counter()
        _tracing.record_span(
            "gateway::reject", now, now,
            args={"tenant": tenant, "class": slo,
                  "brownout": BROWNOUT_LEVELS[self.brownout.level]})

    # -- terminal outcomes -------------------------------------------------
    def _emit_outcome(self, outcome: str, tenant: str, slo: str,
                      reason: Optional[str] = None,
                      ticket: Optional[int] = None, tk=None,
                      synthetic: bool = False):
        """Resolve one request's reason-coded terminal outcome exactly
        once (completed / deadline_missed / shed / rejected(reason) /
        drained) and publish it to the outcome listeners.  Pre-queue
        rejections have no ticket; everything else resolves through its
        `_Ticket`, which latches so double emission is impossible."""
        ttft_ms = None
        if tk is not None:
            if tk.outcome is not None:
                return
            tk.outcome = outcome
            tk.outcome_reason = reason
            synthetic = tk.synthetic
            if tk.first_tok_t is not None:
                ttft_ms = (tk.first_tok_t - tk.submit_t) * 1e3
        _OUTCOME_COUNTERS[outcome].inc()
        if not self.outcome_listeners:
            return
        ev = {"outcome": outcome, "reason": reason, "tenant": tenant,
              "slo": slo, "ticket": ticket, "synthetic": synthetic,
              "ttft_ms": ttft_ms}
        for fn in list(self.outcome_listeners):
            fn(ev)

    # -- pressure + ladder -------------------------------------------------
    def _pressure(self) -> Tuple[float, Optional[float]]:
        """(mean healthy-replica load_score, max digest p95 TTFT ms)."""
        reps = self.router._snapshot()
        loads = [rep.load_score() for rep in reps if rep.healthy()]
        load = sum(loads) / len(loads) if loads else 0.0
        ttft = None
        for rep in reps:
            ns = getattr(rep.engine, "metrics_namespace", None)
            # a retired replica's series is frozen: a stale high p95
            # must not hold the brownout ladder engaged forever
            if ns is None or getattr(rep, "retired", False):
                continue
            q = _metrics.child(ns).histogram(
                "serving/ttft_ms").quantile(0.95)
            if q is not None and (ttft is None or q > ttft):
                ttft = q
        _m_load.set(load)
        return load, ttft

    # -- dispatch ----------------------------------------------------------
    def _dispatchable_class(self, slo: str, lvl: int) -> bool:
        cls = self._class_cfg(slo)
        if cls.protected:
            return True
        if cls.deferrable and lvl >= L_DEFER_BATCH:
            return False
        if cls.sheddable and lvl >= L_SHED:
            return False
        return True

    def _next_entry(self, lvl: int) -> Optional[_Pending]:
        """Weighted-fair pick: among tenants with a dispatchable head
        entry, the smallest virtual time wins; within a tenant, class
        priority orders the pick.  The winner's vtime advances by
        1/weight — a heavy queue only drains as fast as its share."""
        by_prio = sorted(self.cfg.classes,
                         key=lambda s: self.cfg.classes[s].priority)
        best_tenant, best_v = None, None
        for tenant, queues in self._queues.items():
            if not any(queues.get(s) and self._dispatchable_class(s, lvl)
                       for s in by_prio):
                continue
            v = self._vtime.get(tenant, 0.0)
            if best_v is None or v < best_v:
                best_tenant, best_v = tenant, v
        if best_tenant is None:
            return None
        queues = self._queues[best_tenant]
        for slo in by_prio:
            q = queues.get(slo)
            if q and self._dispatchable_class(slo, lvl):
                entry = q.popleft()
                w = max(self._tenant_cfg(best_tenant).weight, 1e-9)
                floor = min((v for t, v in self._vtime.items()
                             if any(self._queues.get(t, {}).values())),
                            default=0.0)
                self._vtime[best_tenant] = \
                    max(self._vtime.get(best_tenant, 0.0), floor) \
                    + 1.0 / w
                return entry
        return None

    def _affinity(self, tenant: str, session: Optional[str],
                  prompt) -> Tuple[Optional[int], int]:
        """(preferred replica idx, cached-token coverage): the replica
        whose prefix cache covers the most of this prompt under the
        tenant's namespace; the session's last replica breaks ties and
        stands in when nothing is cached yet."""
        best_idx, best_cov = None, 0
        reps = self.router._snapshot()
        for idx, rep in enumerate(reps):
            # draining replicas are finishing their in-flight work on
            # the way OUT of the fleet: affinity must not pin new
            # sessions to a cache that is about to retire
            if not rep.placeable():
                continue
            cache = getattr(rep.engine, "_prefix_cache", None)
            if cache is None:
                continue
            cov = cache.probe(prompt, namespace=tenant)
            if cov > best_cov or (
                    cov == best_cov and cov > 0 and best_idx is not None
                    and rep.load_score()
                    < reps[best_idx].load_score()):
                best_idx, best_cov = idx, cov
        if best_idx is None and session is not None:
            idx = self._sessions.get((tenant, session))
            if idx is not None and idx < len(reps) \
                    and reps[idx].placeable():
                best_idx = idx
        return best_idx, best_cov

    def _dispatch(self, entry: _Pending, lvl: int) -> bool:
        """Admit one queued entry into the router.  False means the
        fleet is saturated and the entry went back to the head of its
        queue (stop pumping); True means the entry was resolved —
        admitted, or rejected against the retry budget."""
        tk = self._tickets[entry.ticket]
        if entry.attempts > self.cfg.free_redispatches \
                and not self.retry_budget.take():
            _m_budget_denied.inc()
            err = GatewayRejectedError(
                "retry_budget", tenant=entry.tenant,
                slo_class=entry.slo,
                retry_after_s=self.cfg.brownout.retry_after_s)
            tk.rejected = err
            self._count_reject(entry.tenant, entry.slo)
            self._emit_outcome("rejected", entry.tenant, entry.slo,
                               reason="retry_budget",
                               ticket=entry.ticket, tk=tk)
            return True
        cls = self._class_cfg(entry.slo)
        max_new = entry.max_new
        if lvl >= L_CLAMP and not cls.protected:
            clamp = self.cfg.brownout.clamp_max_new
            if max_new > clamp:
                max_new = clamp
                if not tk.clamped:
                    tk.clamped = True
                    _m_clamped.inc()
        prefer, cov = self._affinity(entry.tenant, entry.session,
                                     entry.prompt)
        t0 = time.perf_counter()
        try:
            h = self.router.submit(
                entry.prompt, max_new_tokens=max_new,
                sampling=entry.sampling,
                eos_token_id=entry.eos_token_id,
                deadline_s=cls.deadline_s, tenant=entry.tenant,
                prefer=prefer)
        except EngineOverloadedError:
            entry.attempts += 1
            self._queues[entry.tenant][entry.slo].appendleft(entry)
            return False
        self.retry_budget.deposit()
        idx, rid = self.router._handles[h]
        # pin the deterministic sampling identity: tokens depend only
        # on (salt_seed, stream_key, position) — never on placement,
        # rid assignment order, or load
        req = self.router.replicas[idx].engine._requests[rid]
        req.salt_rid = int(entry.stream_key)
        req.salt_seed = int(self.cfg.salt_seed)
        tk.handle = h
        self._by_handle[h] = entry.ticket
        if entry.session is not None:
            self._sessions[(entry.tenant, entry.session)] = idx
        if prefer is not None and idx == prefer and cov > 0:
            _m_affinity.inc()
        _m_admitted.inc()
        _tracing.record_span(
            "gateway::dispatch", t0, time.perf_counter(),
            args={"ticket": entry.ticket, "tenant": entry.tenant,
                  "class": entry.slo,
                  "replica": self.router.replicas[idx].name,
                  "prefix_cov": cov, "attempts": entry.attempts,
                  "brownout": BROWNOUT_LEVELS[lvl]})
        return True

    def _shed_queued(self, lvl: int):
        """Level >= 3: queued sheddable entries reject with
        retry-after instead of aging in the queue."""
        for tenant, queues in self._queues.items():
            for slo, q in queues.items():
                cls = self._class_cfg(slo)
                if cls.protected or not cls.sheddable or not q:
                    continue
                while q:
                    entry = q.popleft()
                    tk = self._tickets[entry.ticket]
                    tk.rejected = GatewayRejectedError(
                        "brownout_shed", tenant=tenant, slo_class=slo,
                        retry_after_s=self.cfg.brownout.retry_after_s)
                    self._count_reject(tenant, slo, shed=True)
                    self._emit_outcome("shed", tenant, slo,
                                       reason="brownout_shed",
                                       ticket=entry.ticket, tk=tk)

    def queued(self) -> int:
        return sum(len(q) for queues in self._queues.values()
                   for q in queues.values())

    def pump(self) -> int:
        """One gateway scheduling pass: re-evaluate the ladder, shed
        what the level says to shed, then weighted-fair dispatch until
        the fleet saturates or nothing dispatchable remains.  Returns
        how many entries were admitted to the router."""
        load, ttft = self._pressure()
        lvl = self.brownout.observe(load, ttft)
        if lvl >= L_SHED:
            self._shed_queued(lvl)
        dispatched = 0
        while True:
            entry = self._next_entry(lvl)
            if entry is None:
                break
            if not self._dispatch(entry, lvl):
                break
            if self._tickets[entry.ticket].handle is not None:
                dispatched += 1
        # deferral accounting: entries still queued in a deferred class
        for queues in self._queues.values():
            for slo, q in queues.items():
                cls = self._class_cfg(slo)
                if q and cls.deferrable and lvl >= L_DEFER_BATCH:
                    for entry in q:
                        tk = self._tickets[entry.ticket]
                        if not tk.deferred:
                            tk.deferred = True
                            _m_deferrals.inc()
        _m_depth.set(self.queued())
        return dispatched

    # -- driving -----------------------------------------------------------
    def step(self):
        """One pump + one router step; returns {ticket: [tokens]}
        produced this step (and records per-ticket first-token
        times)."""
        self.pump()
        produced = self.router.step_all()
        out = {}
        now = time.perf_counter()
        for h, toks in produced.items():
            t = self._by_handle.get(h)
            if t is None:
                continue
            tk = self._tickets[t]
            if toks and tk.first_tok_t is None:
                tk.first_tok_t = now
            out[t] = toks
        self._finalize_outcomes()
        return out

    def _finalize_outcomes(self):
        """Latch terminal outcomes for every placed ticket whose engine
        request has resolved: timed out -> deadline_missed, finished on
        the original replica -> completed, finished after a requeue
        hop -> drained."""
        moved = getattr(self.router, "moved_handles", set())
        for ticket, tk in self._tickets.items():
            if tk.outcome is not None or tk.handle is None:
                continue
            placed = self.router._handles.get(tk.handle)
            if placed is None:
                continue
            idx, rid = placed
            req = self.router.replicas[idx].engine._requests.get(rid)
            if req is None:
                continue
            if req.timed_out:
                self._emit_outcome("deadline_missed", tk.tenant, tk.slo,
                                   ticket=ticket, tk=tk)
            elif req.done:
                self._emit_outcome(
                    "drained" if tk.handle in moved else "completed",
                    tk.tenant, tk.slo, ticket=ticket, tk=tk)

    def run_to_completion(self, max_steps: int = 2000):
        for _ in range(max_steps):
            self.step()
            if not self.queued() and not self.router._live_pending():
                break
        return self.results()

    # -- observation -------------------------------------------------------
    def results(self) -> Dict[int, List[int]]:
        """{ticket: generated tokens} for every dispatched ticket."""
        by_handle = self.router.results()
        return {t: by_handle[tk.handle]
                for t, tk in self._tickets.items()
                if tk.handle is not None and tk.handle in by_handle}

    def rejected(self) -> Dict[int, GatewayRejectedError]:
        """Tickets resolved by rejection AFTER queueing (brownout shed
        of queued entries, retry-budget exhaustion).  Pre-queue
        rejections raise at ``submit``."""
        return {t: tk.rejected for t, tk in self._tickets.items()
                if tk.rejected is not None}

    def timed_out(self) -> List[int]:
        """Tickets whose final placement timed out (the router's
        deadline machinery, post-requeue-cap)."""
        handles = set(self.router.timed_out())
        return [t for t, tk in self._tickets.items()
                if tk.handle in handles]

    def ticket_info(self, ticket: int) -> dict:
        tk = self._tickets[ticket]
        return {"tenant": tk.tenant, "slo": tk.slo,
                "handle": tk.handle, "stream_key": tk.stream_key,
                "clamped": tk.clamped, "deferred": tk.deferred,
                "rejected": tk.rejected, "synthetic": tk.synthetic,
                "submit_t": tk.submit_t, "first_tok_t": tk.first_tok_t}

    def ttft(self, ticket: int) -> Optional[float]:
        tk = self._tickets[ticket]
        if tk.first_tok_t is None:
            return None
        return tk.first_tok_t - tk.submit_t
