"""Capacity headroom: fit the recorded load-vs-goodput curve from the
timeline and advise scale decisions.

ROADMAP item 1's AutoScaler needs one input: "given what the fleet
just did, should it grow, hold, or shrink — and if shrink, which
replicas drain first".  `ScaleAdvisor` is deliberately that exact
interface, computed from recorded telemetry instead of instantaneous
gauges:

  * **Curve fit.**  Adjacent timeline windows yield (load_score,
    goodput-rate) points; the saturation knee is the LOWEST load that
    already achieves ~peak goodput — pushing load past it buys
    queueing, not throughput.  Headroom is the remaining fraction of
    load below that knee (falling back to the configured `high_load`
    bound while the curve is still sparse).
  * **Monotone decision rules.**  `recommend()` escalates on current
    load, brownout activity, or active burn alerts; it de-escalates
    only when EVERY window in the decision horizon sat at/below
    `low_load` with no recent alert activity — so more load can never
    produce a lazier recommendation (the monotonicity test), and a
    fleet that just survived a storm holds instead of flapping into a
    scale-down while the storm is still inside the horizon.
  * **Drain candidates.**  On scale_down, the least-loaded replicas
    are proposed greedily while the survivors' projected mean load
    stays at/below `target_load`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics

__all__ = ["ScaleAdvice", "ScaleAdvisor", "ACTIONS"]

ACTIONS = ("scale_down", "hold", "scale_up")

_m_advisories = _metrics.counter("slo/advisories")
_m_headroom = _metrics.gauge("slo/headroom")


@dataclass
class ScaleAdvice:
    """One advisory — the AutoScaler input record."""

    action: str                         # scale_up | hold | scale_down
    reason: str
    current_load: Optional[float]
    headroom: Optional[float]           # fraction of knee load left
    saturation_load: Optional[float]    # fitted knee (None: sparse)
    peak_goodput: Optional[float]       # req/s at the knee
    drain_candidates: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        def r(v):
            return round(v, 4) if isinstance(v, float) else v
        return {"action": self.action, "reason": self.reason,
                "current_load": r(self.current_load),
                "headroom": r(self.headroom),
                "saturation_load": r(self.saturation_load),
                "peak_goodput": r(self.peak_goodput),
                "drain_candidates": list(self.drain_candidates)}


class ScaleAdvisor:
    """Headroom estimation + scale advisories over a Timeline (and
    optionally an SLOTracker for alert awareness).

    advisor = ScaleAdvisor(timeline, tracker=slo_tracker, window_s=60)
    advisor.recommend(replica_loads={"r0": 0.1, "r1": 0.05})
    """

    def __init__(self, timeline, tracker=None,
                 load_metric: str = "gateway/load_score",
                 goodput_metric: str = "gateway/outcome/completed",
                 brownout_metric: str = "gateway/brownout_level",
                 window_s: float = 60.0,
                 high_load: float = 1.0, low_load: float = 0.25,
                 target_load: float = 0.7,
                 min_windows: int = 3, sat_fraction: float = 0.9):
        self.timeline = timeline
        self.tracker = tracker
        self.load_metric = load_metric
        self.goodput_metric = goodput_metric
        self.brownout_metric = brownout_metric
        self.window_s = float(window_s)
        self.high_load = float(high_load)
        self.low_load = float(low_load)
        self.target_load = float(target_load)
        self.min_windows = max(1, int(min_windows))
        self.sat_fraction = float(sat_fraction)

    # -- the recorded curve -----------------------------------------------
    def curve(self) -> List[Tuple[float, float]]:
        """(load, goodput req/s) per adjacent-window pair, over the
        whole retained timeline."""
        wins = self.timeline.windows()
        pts = []
        for a, b in zip(wins, wins[1:]):
            dt = b["t"] - a["t"]
            load = b["gauges"].get(self.load_metric)
            if dt <= 0 or load is None:
                continue
            dg = (b["counters"].get(self.goodput_metric, 0)
                  - a["counters"].get(self.goodput_metric, 0))
            pts.append((float(load), dg / dt))
        return pts

    def saturation(self) -> Tuple[Optional[float], Optional[float]]:
        """(knee load, peak goodput) fitted from the curve, or
        (None, None) while the curve is too sparse to trust."""
        pts = self.curve()
        if len(pts) < self.min_windows:
            return None, None
        peak = max(g for _, g in pts)
        if peak <= 0:
            return None, None
        sat = min(l for l, g in pts if g >= self.sat_fraction * peak)
        return (sat if sat > 0 else None), peak

    def _alert_activity(self, now: Optional[float]) -> bool:
        """Any alert active, or raised/cleared inside the decision
        horizon — recent judgment vetoes a scale_down."""
        if self.tracker is None:
            return False
        if self.tracker.active_alerts():
            return True
        if now is None:
            return False
        for a in self.tracker.alerts:
            edge = a.cleared_t if a.cleared_t is not None else a.raised_t
            if edge >= now - self.window_s:
                return True
        return False

    # -- the advisory -----------------------------------------------------
    def recommend(self,
                  replica_loads: Optional[Dict[str, float]] = None,
                  now: Optional[float] = None) -> ScaleAdvice:
        wins = self.timeline.windows(self.window_s, now)
        loads = [w["gauges"][self.load_metric] for w in wins
                 if self.load_metric in w["gauges"]]
        # the LIVE registry gauges join the horizon: a storm that hits
        # between samples must not read as a calm set of windows
        gauges = self.timeline.registry.snapshot().get("gauges", {})
        live = gauges.get(self.load_metric)
        if live is not None:
            loads = loads + [float(live)]
        cur = loads[-1] if loads else None
        sat, peak = self.saturation()
        headroom = None
        if cur is not None:
            knee = sat if sat is not None else self.high_load
            if knee > 0:
                headroom = max(0.0, 1.0 - cur / knee)
        if now is None and wins:
            now = wins[-1]["t"]
        brown = max((w["gauges"].get(self.brownout_metric, 0)
                     for w in wins), default=0)
        brown = max(brown, gauges.get(self.brownout_metric, 0) or 0)
        alerts = bool(self.tracker.active_alerts()) \
            if self.tracker is not None else False
        if cur is None:
            advice = ScaleAdvice("hold", "no load signal recorded yet",
                                 None, None, sat, peak)
        elif alerts or brown >= 1 or cur >= self.high_load:
            why = ("active burn alert" if alerts
                   else "brownout ladder engaged" if brown >= 1
                   else f"load {cur:.2f} >= high watermark "
                        f"{self.high_load:.2f}")
            advice = ScaleAdvice("scale_up", why, cur, headroom,
                                 sat, peak)
        elif (len(loads) >= self.min_windows
                and all(l <= self.low_load for l in loads)
                and not self._alert_activity(now)):
            advice = ScaleAdvice(
                "scale_down",
                f"load held <= {self.low_load:.2f} across the horizon",
                cur, headroom, sat, peak,
                drain_candidates=self._drain_candidates(replica_loads))
        else:
            advice = ScaleAdvice("hold", "inside the comfort band",
                                 cur, headroom, sat, peak)
        _m_advisories.inc()
        if headroom is not None:
            _m_headroom.set(headroom)
        return advice

    def _drain_candidates(
            self, replica_loads: Optional[Dict[str, float]]) -> List[str]:
        """Least-loaded replicas removable while the survivors'
        projected mean load stays at/below target_load."""
        if not replica_loads or len(replica_loads) <= 1:
            return []
        items = sorted(replica_loads.items(), key=lambda kv: kv[1])
        total = sum(replica_loads.values())
        n = len(items)
        out = []
        for name, load in items:
            if n <= 1:
                break
            if (total - load) / (n - 1) > self.target_load:
                break
            out.append(name)
            total -= load
            n -= 1
        return out
