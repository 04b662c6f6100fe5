"""Telemetry timeline: a bounded time-series ring over registry
snapshots, the time dimension of the fleet's observability plane
(port of paddle_tpu/profiler/timeline.py).

`FleetAggregator` answers "what does the fleet look like NOW";
autoscaler rules, SLO attainment, and capacity plans all need "how did
it behave over the last five minutes".  A `Timeline` closes that gap:

  * **Periodic sampling.**  `sample()` snapshots the registry under an
    injectable clock (`clock=` — tests and chip_smoke.py drive it with a
    synthetic step counter; nothing here reads wall-clock in a hot
    path) and appends one window record: cumulative counters, gauges,
    and the per-window histogram digests.
  * **Honest window quantiles.**  t-digests merge but do NOT subtract,
    so a trailing-window p95 cannot be derived by differencing
    cumulative sketches — instead every `Histogram` keeps a second,
    drainable window digest (`drain_window()`, metrics.py) that
    `sample()` collects, and `percentile(name, q, window_s)` MERGES the
    retained window sketches: real t-digest math over the window's
    observations, not an average of averages.
  * **Counter rates.**  `rate(name, window_s)` reads the cumulative
    counter delta between the window's boundary samples.
  * **Point events.**  Router/supervisor health transitions and
    brownout moves land via the module-level `emit_event` sink and ride
    inside the next window, so a postmortem sees "replica demoted"
    between the p95 spike and the burn alert.
  * **Crash spill.**  With `spill_dir` set, each window appends to a
    JSONL file and then republishes `MANIFEST.json` atomically
    (recovery.py's manifest-last discipline: the manifest counts the
    published windows, so `load_spill` replays exactly the complete
    prefix and a torn tail line is ignored).  `attach_flight()` also
    embeds the last N windows into every FlightRecorder dump.

Single consumer by design: `sample()` drains the registry's window
digests, so exactly one Timeline should own a given registry.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import tracing as _tracing
from .digest import QuantileDigest

__all__ = ["Timeline", "load_spill", "emit_event", "install",
           "uninstall", "SPILL_FILE"]

SPILL_FILE = "windows.jsonl"

_m_samples = _metrics.counter("timeline/samples")
_m_events = _metrics.counter("timeline/events")
_m_spilled = _metrics.counter("timeline/windows_spilled")
_m_spill_errors = _metrics.counter("timeline/spill_errors")

# module-level event sink: instrumented layers (router demotions, the
# brownout ladder) call emit_event without holding a Timeline reference;
# installed timelines fold the events into their next window
_sinks: List["Timeline"] = []
_sinks_lock = threading.Lock()


def install(tl: "Timeline") -> "Timeline":
    """Route subsequent `emit_event` calls into `tl` (idempotent)."""
    with _sinks_lock:
        if tl not in _sinks:
            _sinks.append(tl)
    return tl


def uninstall(tl: "Timeline") -> None:
    with _sinks_lock:
        if tl in _sinks:
            _sinks.remove(tl)


def emit_event(kind: str, **payload) -> None:
    """Record a point event (JSON-safe payload) on every installed
    timeline.  No-op (beyond a counter) when none is installed, so the
    emitting hot paths never grow a hard dependency."""
    _m_events.inc()
    with _sinks_lock:
        sinks = list(_sinks)
    for tl in sinks:
        tl.event(kind, **payload)


class Timeline:
    """Bounded in-memory ring of sampled windows + optional JSONL spill.

    tl = Timeline(clock=my_clock, spill_dir="/var/pt/timeline")
    tl.sample()                       # one window per call
    tl.rate("gateway/outcome/completed", window_s=60)
    tl.percentile("serving/ttft_ms", 0.95, window_s=60)
    """

    def __init__(self, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = 720, spill_dir: Optional[str] = None,
                 max_events: int = 4096):
        self.registry = registry if registry is not None \
            else _metrics.registry()
        self._clock = clock
        self._windows: deque = deque(maxlen=max(2, int(capacity)))
        self._pending_events: deque = deque(maxlen=max(16, int(max_events)))
        self._lock = threading.Lock()
        self._seq = 0
        self._spilled = 0
        self._spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # -- ingestion --------------------------------------------------------
    def event(self, kind: str, **payload) -> None:
        """Queue a point event; it rides inside the next window."""
        with self._lock:
            self._pending_events.append(
                {"t": self._clock(), "kind": kind, **payload})

    def sample(self) -> dict:
        """Snapshot the registry into one window record: cumulative
        counters, gauges, drained per-window digests, queued events.
        The window's `t` is its END; it covers observations since the
        previous sample."""
        now = self._clock()
        snap = self.registry.snapshot()
        digests: Dict[str, dict] = {}
        for name in snap.get("histograms", {}):
            wd = self.registry.histogram(name).drain_window()
            if wd.count:
                digests[name] = wd.to_dict()
        with self._lock:
            self._seq += 1
            win = {"seq": self._seq, "t": now,
                   "counters": dict(snap.get("counters", {})),
                   "gauges": dict(snap.get("gauges", {})),
                   "digests": digests,
                   "events": list(self._pending_events)}
            self._pending_events.clear()
            self._windows.append(win)
        _m_samples.inc()
        if self._spill_dir:
            self._spill(win)
        return win

    # -- queries ----------------------------------------------------------
    def windows(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> List[dict]:
        """Retained windows, oldest first; `window_s` keeps only those
        ENDING within the trailing window (measured from the newest
        sample unless `now` is given)."""
        with self._lock:
            wins = list(self._windows)
        if window_s is None or not wins:
            return wins
        if now is None:
            now = wins[-1]["t"]
        return [w for w in wins if w["t"] >= now - window_s]

    def rate(self, name: str, window_s: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Counter increments per second over the trailing window: the
        cumulative delta between the boundary samples (None until two
        samples exist)."""
        wins = self.windows(None, None)
        if now is not None:
            wins = [w for w in wins if w["t"] <= now]
        if len(wins) < 2:
            return None
        last = wins[-1]
        base = wins[0]
        if window_s is not None:
            t_cut = last["t"] - window_s
            for w in wins[:-1]:
                if w["t"] <= t_cut:
                    base = w
                else:
                    break
        dt = last["t"] - base["t"]
        if dt <= 0:
            return None
        return (last["counters"].get(name, 0)
                - base["counters"].get(name, 0)) / dt

    def percentile(self, name: str, q: float,
                   window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """Honest trailing-window quantile: merge the per-window
        digests covered by the window — t-digest math over the window's
        actual observation stream."""
        merged: Optional[QuantileDigest] = None
        for w in self.windows(window_s, now):
            d = w["digests"].get(name)
            if not d:
                continue
            part = QuantileDigest.from_dict(d)
            merged = part if merged is None else merged.merge(part)
        return merged.quantile(q) if merged is not None else None

    def series(self, name: str,
               window_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """[(t, value)] per window for a gauge (falling back to the
        cumulative counter of the same name)."""
        out = []
        for w in self.windows(window_s):
            v = w["gauges"].get(name)
            if v is None:
                v = w["counters"].get(name)
            if v is not None:
                out.append((w["t"], v))
        return out

    def events(self, window_s: Optional[float] = None,
               kind: Optional[str] = None) -> List[dict]:
        out = []
        for w in self.windows(window_s):
            for ev in w.get("events", ()):
                if kind is None or ev.get("kind") == kind:
                    out.append(ev)
        return out

    def recent(self, n: int = 20) -> List[dict]:
        """The last `n` windows with digests summarized to quantiles —
        the compact view FlightRecorder dumps embed."""
        out = []
        for w in self.windows()[-max(1, n):]:
            dg = {}
            for name, d in w["digests"].items():
                part = QuantileDigest.from_dict(d)
                dg[name] = {"count": part.count,
                            "p50": part.quantile(0.5),
                            "p95": part.quantile(0.95),
                            "p99": part.quantile(0.99)}
            out.append({"seq": w["seq"], "t": w["t"],
                        "counters": w["counters"], "gauges": w["gauges"],
                        "digests": dg, "events": w["events"]})
        return out

    def attach_flight(self, n: int = 20, recorder=None) -> "Timeline":
        """Embed this timeline's last `n` windows in every future
        FlightRecorder dump (section key ``timeline``)."""
        rec = recorder if recorder is not None else _tracing.flight
        rec.attach("timeline", lambda: self.recent(n))
        return self

    # -- crash spill ------------------------------------------------------
    def _spill(self, win: dict) -> None:
        """Append-only JSONL + manifest-last: data line first, then the
        manifest republishes atomically with the published count.  A
        crash between the two leaves an unpublished tail line that
        `load_spill` ignores — the manifest IS the completeness
        marker."""
        from ..distributed.resilience import recovery as _recovery

        try:
            path = os.path.join(self._spill_dir, SPILL_FILE)
            with open(path, "a") as f:
                f.write(json.dumps(win) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._spilled += 1
            _recovery.publish_manifest(self._spill_dir, {
                "kind": "timeline", "windows": self._spilled,
                "last_seq": win["seq"], "last_t": win["t"]})
            _m_spilled.inc()
        except (OSError, TypeError, ValueError):
            _m_spill_errors.inc()


def load_spill(path: str) -> List[dict]:
    """Replay a timeline spill directory: the complete prefix of
    windows the manifest published.  Returns [] for a torn spill (no
    manifest); a trailing line written after the last manifest publish,
    or torn mid-write, is ignored."""
    from ..distributed.resilience import recovery as _recovery

    man = _recovery.read_manifest(path)
    if man is None:
        return []
    out: List[dict] = []
    published = int(man.get("windows", 0))
    try:
        f = open(os.path.join(path, SPILL_FILE))
    except OSError:
        return []
    with f:
        for line in f:
            if len(out) >= published:
                break
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                break          # torn line: nothing after it is trusted
    return out
