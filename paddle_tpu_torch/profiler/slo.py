"""SLO engine: per-(tenant × class) objectives, attainment accounting,
error budgets, and multi-window burn-rate alerts.

The gateway resolves every request to exactly one reason-coded terminal
outcome — ``completed`` / ``deadline_missed`` / ``shed`` /
``rejected(reason)`` / ``drained`` — and publishes it to registered
outcome listeners.  `SLOTracker.attach(gateway)` subscribes and turns
the stream into judgment:

  * **Goodness.**  A request is GOOD iff its outcome is completed or
    drained AND (when the objective sets a TTFT bound) its first token
    arrived within it.  Attainment = good/total over a window; the
    error budget is ``1 - target``.
  * **Burn rate.**  ``burn = bad_fraction / error_budget`` — 1.0 burns
    the budget exactly at the sustainable rate, 10x eats a day's budget
    in ~2.4 hours.
  * **Multi-window alerts.**  An alert RAISES only when BOTH the fast
    window (default 5m — catches the storm now) and the slow window
    (default 1h — proves it is not a blip) burn at/above the
    threshold, and CLEARS only after `clear_after` consecutive calm
    evaluations with the fast burn at/below ``threshold *
    exit_ratio`` — the same enter-high/exit-low hysteresis as the
    brownout ladder, so a single storm spike cannot flap the pager.

Alerts are structured `SLOAlert`s; raising/clearing also lands a
flight-recorder note and a timeline event, so the black box and the
postmortem spill both carry the judgment next to the raw telemetry.
Clocks are injectable everywhere; nothing reads wall-clock unless the
default is used.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import timeline as _timeline
from . import tracing as _tracing

__all__ = ["SLOObjective", "SLOAlert", "SLOTracker",
           "OUTCOMES", "GOOD_OUTCOMES"]

# the gateway's terminal-outcome vocabulary
OUTCOMES = ("completed", "deadline_missed", "shed", "rejected", "drained")
GOOD_OUTCOMES = frozenset(("completed", "drained"))

_m_recorded = _metrics.counter("slo/outcomes_recorded")
_m_raised = _metrics.counter("slo/alerts_raised")
_m_cleared = _metrics.counter("slo/alerts_cleared")
_m_active = _metrics.gauge("slo/active_alerts")


@dataclass
class SLOObjective:
    """One objective: required good fraction (`target`, e.g. 0.99) and
    an optional per-request TTFT bound folded into goodness — a
    completed request slower than `ttft_ms` still burns budget."""

    target: float = 0.99
    ttft_ms: Optional[float] = None

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


@dataclass
class SLOAlert:
    """A raised burn-rate alert; `cleared_t is None` while active."""

    tenant: str
    slo_class: str
    kind: str
    raised_t: float
    fast_burn: float
    slow_burn: float
    threshold: float
    cleared_t: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.cleared_t is None

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "slo_class": self.slo_class,
                "kind": self.kind, "raised_t": self.raised_t,
                "fast_burn": round(self.fast_burn, 4),
                "slow_burn": round(self.slow_burn, 4),
                "threshold": self.threshold,
                "cleared_t": self.cleared_t, "active": self.active}


class SLOTracker:
    """Attainment + burn-rate state machine over outcome events.

    tracker = SLOTracker(
        class_objectives={"interactive": SLOObjective(0.999, ttft_ms=200)},
        fast_window_s=300, slow_window_s=3600, burn_threshold=10.0,
    ).attach(gateway)
    ...
    tracker.evaluate()            # call periodically (per timeline tick)
    tracker.attainment("acme", "interactive")
    tracker.report()
    """

    def __init__(self,
                 objectives: Optional[Dict[Tuple[str, str],
                                           SLOObjective]] = None,
                 class_objectives: Optional[Dict[str, SLOObjective]] = None,
                 default: Optional[SLOObjective] = None,
                 clock: Callable[[], float] = time.monotonic,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 10.0,
                 exit_ratio: float = 0.5,
                 clear_after: int = 3,
                 count_synthetic: bool = True,
                 max_events: int = 65536):
        self.objectives = dict(objectives or {})      # (tenant, class) ->
        self.class_objectives = dict(class_objectives or {})
        self.default = default or SLOObjective()
        self._clock = clock
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.exit_ratio = float(exit_ratio)
        self.clear_after = max(1, int(clear_after))
        self.count_synthetic = count_synthetic
        # (t, tenant, slo, outcome, reason, good)
        self._events: deque = deque(maxlen=max(1024, int(max_events)))
        # (tenant, slo) -> {"alert": SLOAlert|None, "calm": int}
        self._state: Dict[Tuple[str, str], dict] = {}
        self.alerts: List[SLOAlert] = []    # every alert ever raised

    # -- objective lookup -------------------------------------------------
    def objective(self, tenant: str, slo: str) -> SLOObjective:
        obj = self.objectives.get((tenant, slo))
        if obj is None:
            obj = self.class_objectives.get(slo)
        return obj or self.default

    # -- ingestion --------------------------------------------------------
    def attach(self, gateway) -> "SLOTracker":
        """Subscribe to a FleetGateway's outcome events."""
        gateway.outcome_listeners.append(self.record)
        return self

    def record(self, ev: dict) -> None:
        """Ingest one gateway outcome event (the listener callback)."""
        if ev.get("synthetic") and not self.count_synthetic:
            return
        tenant = str(ev.get("tenant"))
        slo = str(ev.get("slo"))
        outcome = str(ev.get("outcome"))
        good = outcome in GOOD_OUTCOMES
        if good:
            obj = self.objective(tenant, slo)
            ttft = ev.get("ttft_ms")
            if obj.ttft_ms is not None and ttft is not None \
                    and ttft > obj.ttft_ms:
                good = False
        self._events.append((self._clock(), tenant, slo, outcome,
                             ev.get("reason"), good))
        _m_recorded.inc()

    # -- attainment -------------------------------------------------------
    def _select(self, tenant=None, slo=None, window_s=None, now=None):
        if window_s is not None and now is None:
            now = self._clock()
        out = []
        for t, tn, sc, outcome, reason, good in self._events:
            if tenant is not None and tn != tenant:
                continue
            if slo is not None and sc != slo:
                continue
            if window_s is not None and t < now - window_s:
                continue
            out.append((t, tn, sc, outcome, reason, good))
        return out

    def attainment(self, tenant: Optional[str] = None,
                   slo: Optional[str] = None,
                   window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """good/total over the (optionally trailing, optionally
        filtered) outcome stream; None with no traffic."""
        evs = self._select(tenant, slo, window_s, now)
        if not evs:
            return None
        return sum(1 for e in evs if e[5]) / len(evs)

    def _burn(self, evs) -> Tuple[float, int]:
        if not evs:
            return 0.0, 0
        bad = sum(1 for e in evs if not e[5])
        return bad / len(evs), len(evs)

    # -- the alert state machine ------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[SLOAlert]:
        """One evaluation pass: recompute fast/slow burns per
        (tenant × class), raise/clear with hysteresis.  Returns the
        active alerts."""
        if now is None:
            now = self._clock()
        by_key: Dict[Tuple[str, str], list] = {}
        for ev in self._events:
            if ev[0] < now - self.slow_window_s:
                continue
            by_key.setdefault((ev[1], ev[2]), []).append(ev)
        thr = self.burn_threshold
        for key in set(by_key) | set(self._state):
            evs = by_key.get(key, [])
            budget = self.objective(*key).error_budget
            fast_frac, _ = self._burn(
                [e for e in evs if e[0] >= now - self.fast_window_s])
            slow_frac, _ = self._burn(evs)
            fast_burn = fast_frac / budget
            slow_burn = slow_frac / budget
            st = self._state.setdefault(key, {"alert": None, "calm": 0})
            alert = st["alert"]
            if alert is None:
                if fast_burn >= thr and slow_burn >= thr:
                    alert = SLOAlert(key[0], key[1], "burn_rate", now,
                                     fast_burn, slow_burn, thr)
                    st["alert"] = alert
                    st["calm"] = 0
                    self.alerts.append(alert)
                    _m_raised.inc()
                    note = alert.to_dict()
                    note["alert_kind"] = note.pop("kind")
                    _tracing.flight_note("slo_alert", **note)
                    _timeline.emit_event("slo_alert", **note)
            else:
                alert.fast_burn = fast_burn
                alert.slow_burn = slow_burn
                if fast_burn <= thr * self.exit_ratio:
                    st["calm"] += 1
                    if st["calm"] >= self.clear_after:
                        alert.cleared_t = now
                        st["alert"] = None
                        st["calm"] = 0
                        _m_cleared.inc()
                        note = alert.to_dict()
                        note["alert_kind"] = note.pop("kind")
                        _tracing.flight_note("slo_alert_cleared", **note)
                        _timeline.emit_event("slo_alert_cleared", **note)
                else:
                    st["calm"] = 0
        active = self.active_alerts()
        _m_active.set(len(active))
        return active

    def active_alerts(self) -> List[SLOAlert]:
        return [a for a in self.alerts if a.active]

    # -- reporting --------------------------------------------------------
    def report(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> dict:
        """The dashboard document: per-(tenant × class) attainment vs
        objective with burns, a per-class rollup, and the alert
        census."""
        if now is None:
            now = self._clock()
        keys = sorted({(e[1], e[2]) for e in self._events})
        per_tenant = {}
        for tenant, slo in keys:
            evs = self._select(tenant, slo, window_s, now)
            obj = self.objective(tenant, slo)
            att = (sum(1 for e in evs if e[5]) / len(evs)) if evs else None
            fast_frac, _ = self._burn(
                [e for e in evs if e[0] >= now - self.fast_window_s])
            slow_frac, _ = self._burn(
                [e for e in evs if e[0] >= now - self.slow_window_s])
            st = self._state.get((tenant, slo), {})
            outcomes: Dict[str, int] = {}
            for e in evs:
                outcomes[e[3]] = outcomes.get(e[3], 0) + 1
            per_tenant[f"{tenant}/{slo}"] = {
                "tenant": tenant, "slo_class": slo,
                "total": len(evs),
                "good": sum(1 for e in evs if e[5]),
                "attainment": round(att, 4) if att is not None else None,
                "target": obj.target,
                "error_budget": round(obj.error_budget, 6),
                "fast_burn": round(fast_frac / obj.error_budget, 4),
                "slow_burn": round(slow_frac / obj.error_budget, 4),
                "outcomes": outcomes,
                "alert_active": st.get("alert") is not None,
            }
        per_class: Dict[str, dict] = {}
        for slo in sorted({k[1] for k in keys}):
            evs = self._select(None, slo, window_s, now)
            att = (sum(1 for e in evs if e[5]) / len(evs)) if evs else None
            per_class[slo] = {
                "total": len(evs),
                "good": sum(1 for e in evs if e[5]),
                "attainment": round(att, 4) if att is not None else None,
            }
        return {
            "per_tenant": per_tenant,
            "per_class": per_class,
            "alerts": {
                "raised": len(self.alerts),
                "active": len(self.active_alerts()),
                "cleared": sum(1 for a in self.alerts if not a.active),
                "log": [a.to_dict() for a in self.alerts],
            },
        }
