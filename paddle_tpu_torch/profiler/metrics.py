"""Always-on runtime metrics: a process-wide registry of counters,
gauges and histograms behind the `paddle.profiler` orchestrator.

Reference analog: the C++ layered tracers under platform/profiler/ keep
host-side statistic tables that survive independently of whether a trace
is being recorded; production serving stacks additionally export them as
Prometheus text. Here the registry is the single sink every instrumented
layer writes to — op dispatch (`dispatch/*`), the compile bridge
(`jit/*`), collectives (`comm/*`) and the serving engine (`serving/*`)
— cheap enough (one lock + int add per event) to stay on at all times.

Crash safety: `enable_periodic_flush(path)` starts a daemon thread that
atomically rewrites a JSON snapshot every interval (tmp file +
``os.replace``), so a process killed mid-run still leaves its last
complete snapshot behind — the failure mode that lost an entire bench
run when results were only emitted as one final line. Env flags
``PT_METRICS_FLUSH_PATH`` / ``PT_METRICS_FLUSH_INTERVAL`` arm the
flusher at import time.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .digest import QuantileDigest

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "registry", "counter", "gauge", "histogram", "child",
    "inc", "set_gauge", "observe", "timed",
    "snapshot", "to_json", "to_prometheus_text", "snapshot_to_file",
    "enable_periodic_flush", "disable_periodic_flush", "reset",
]


# default latency buckets (ms): microseconds through minutes
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                   50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                   10000.0, 60000.0)


class Counter:
    """Monotonic counter. `inc` is thread-exact (lock-guarded add)."""

    __slots__ = ("name", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, v=1):
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _snap(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, v=1):
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0

    def _snap(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram tracking count/sum/min/max, plus a
    mergeable t-digest for honest tail quantiles.

    Buckets are upper bounds (le); `observe` finds the first bound >= v
    with a linear scan (bucket lists are short and observation cost must
    stay O(ns), not O(log n) with allocation). The digest rides along so
    `quantile(0.99)` answers from the actual value stream instead of a
    bucket upper bound, and so per-replica histograms merge into fleet
    percentiles in `profiler.aggregate`.
    """

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_digest", "_win_digest", "_lock")
    kind = "histogram"

    def __init__(self, name: str, buckets: Tuple[float, ...] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._digest = QuantileDigest()
        # second, drainable digest over the observations since the last
        # drain_window() — t-digests merge but do NOT subtract, so a
        # trailing-window quantile can only be honest if each window
        # keeps its own sketch (profiler/timeline.py drains one per
        # sampling tick and merges window sketches on query)
        self._win_digest = QuantileDigest()
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            self._digest.observe(v)
            self._win_digest.observe(v)

    def drain_window(self) -> QuantileDigest:
        """Hand over (and reset) the digest of observations since the
        previous drain — single-consumer semantics: whoever samples the
        registry owns the window boundaries.  The cumulative digest is
        untouched."""
        with self._lock:
            wd = self._win_digest
            self._win_digest = QuantileDigest()
        return wd

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def quantile(self, q: float):
        """Digest-estimated quantile of the observed stream (honest
        p50/p95/p99, not a bucket bound); None while empty."""
        with self._lock:
            return self._digest.quantile(q)

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None
            self._digest._reset()
            self._win_digest._reset()

    def _snap(self):
        with self._lock:
            return {
                "count": self._count,
                "sum": round(self._sum, 6),
                "avg": round(self._sum / self._count, 6)
                if self._count else None,
                "min": self._min, "max": self._max,
                "buckets": {str(b): c for b, c in
                            zip(self.buckets, self._counts)},
                "inf": self._counts[-1],
                "p50": self._digest.quantile(0.5),
                "p95": self._digest.quantile(0.95),
                "p99": self._digest.quantile(0.99),
                "digest": self._digest.to_dict(),
            }


class _FanoutCounter:
    """Child-registry counter: writes land on the local (per-namespace)
    counter AND roll up into the parent registry's same-name counter.
    Reads delegate to the local metric."""

    __slots__ = ("local", "up")
    kind = "counter"

    def __init__(self, local, up):
        self.local = local
        self.up = up

    def inc(self, v=1):
        self.local.inc(v)
        self.up.inc(v)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "local"), item)


class _FanoutGauge:
    __slots__ = ("local", "up")
    kind = "gauge"

    def __init__(self, local, up):
        self.local = local
        self.up = up

    def set(self, v):
        self.local.set(v)
        self.up.set(v)

    def inc(self, v=1):
        self.local.inc(v)
        self.up.inc(v)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "local"), item)


class _FanoutHistogram:
    __slots__ = ("local", "up")
    kind = "histogram"

    def __init__(self, local, up):
        self.local = local
        self.up = up

    def observe(self, v):
        self.local.observe(v)
        self.up.observe(v)

    def quantile(self, q):
        return self.local.quantile(q)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "local"), item)


_FANOUT = {"counter": _FanoutCounter, "gauge": _FanoutGauge,
           "histogram": _FanoutHistogram}


class MetricsRegistry:
    """Process-wide, thread-safe name -> metric table.

    Lookup (`counter`/`gauge`/`histogram`) is get-or-create; hot call
    sites should hold the returned object instead of re-looking-up per
    event. Requesting an existing name as a different kind raises.

    `child(namespace)` returns a namespaced child registry whose metric
    writes fan out to both the child's own metrics and this registry's
    same-name metrics — the mechanism that keeps co-hosted serving
    replicas from conflating their `serving/*` series while the global
    rollup stays intact.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._children: Dict[str, "ChildRegistry"] = {}
        self.namespace: Optional[str] = None
        self._flush_thread: Optional[threading.Thread] = None
        self._flush_stop = threading.Event()
        self._flush_path: Optional[str] = None

    def _get(self, name, cls, *args):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def child(self, namespace: str) -> "ChildRegistry":
        """Get-or-create the namespaced child registry (e.g. one per
        serving replica). Stable: the same namespace always returns the
        same child, so a FleetSupervisor-restarted engine re-binds to
        its replica's existing series."""
        with self._lock:
            c = self._children.get(namespace)
            if c is None:
                c = self._children[namespace] = ChildRegistry(
                    self, namespace)
            return c

    def children(self) -> Dict[str, "ChildRegistry"]:
        with self._lock:
            return dict(self._children)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Zero every metric IN PLACE (instrumented modules hold direct
        references to metric objects, so they must not be replaced).
        Child registries are zeroed too."""
        with self._lock:
            metrics = list(self._metrics.values())
            children = list(self._children.values())
        for m in metrics:
            m._reset()
        for c in children:
            c.reset()

    # -- exporters --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        out = {"ts": time.time(), "pid": os.getpid(),
               "counters": {}, "gauges": {}, "histograms": {}}
        if self.namespace is not None:
            out["namespace"] = self.namespace
        for name in sorted(metrics):
            m = metrics[name]
            out[m.kind + "s"][name] = m._snap()
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus_text(self) -> str:
        """Prometheus exposition format; '/'/'-' in names map to '_'."""
        def san(name):
            out = []
            for ch in name:
                out.append(ch if (ch.isalnum() or ch == "_") else "_")
            s = "".join(out)
            return ("_" + s) if s[:1].isdigit() else s

        with self._lock:
            metrics = dict(self._metrics)
        lines = []
        for name in sorted(metrics):
            m = metrics[name]
            p = san(name)
            if m.kind == "counter":
                lines.append(f"# TYPE {p} counter")
                lines.append(f"{p} {m.value}")
            elif m.kind == "gauge":
                lines.append(f"# TYPE {p} gauge")
                lines.append(f"{p} {m.value}")
            else:
                lines.append(f"# TYPE {p} histogram")
                acc = 0
                with m._lock:
                    counts = list(m._counts)
                    total, hsum = m._count, m._sum
                for b, c in zip(m.buckets, counts):
                    acc += c
                    lines.append(f'{p}_bucket{{le="{b}"}} {acc}')
                lines.append(f'{p}_bucket{{le="+Inf"}} {total}')
                lines.append(f"{p}_sum {hsum}")
                lines.append(f"{p}_count {total}")
        return "\n".join(lines) + "\n"

    def snapshot_to_file(self, path: str):
        """Atomic JSON snapshot: write tmp in the same directory, fsync,
        os.replace — a crash mid-write can never leave a torn file."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.tmp")
        data = self.to_json()
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- crash-safe periodic flusher --------------------------------------
    def enable_periodic_flush(self, path: str, interval_s: float = 10.0):
        """Start (or retarget) the daemon flusher: every `interval_s` the
        registry is snapshotted atomically to `path`, and once more on
        interpreter exit, so a killed process still leaves its last
        complete interval behind."""
        self._flush_path = path
        if self._flush_thread is not None and self._flush_thread.is_alive():
            return
        self._flush_stop.clear()

        def loop():
            while not self._flush_stop.wait(interval_s):
                try:
                    self.snapshot_to_file(self._flush_path)
                except OSError:
                    pass

        self._flush_thread = threading.Thread(
            target=loop, name="pt_metrics_flush", daemon=True)
        self._flush_thread.start()
        import atexit

        atexit.register(self._final_flush)

    def _final_flush(self):
        if self._flush_path:
            try:
                self.snapshot_to_file(self._flush_path)
            except OSError:
                pass

    def disable_periodic_flush(self, final_flush: bool = True):
        self._flush_stop.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=2.0)
            self._flush_thread = None
        if final_flush:
            self._final_flush()
        self._flush_path = None


class ChildRegistry(MetricsRegistry):
    """Namespaced registry whose metrics fan out to a parent.

    `child.counter("serving/requests").inc()` bumps both the child's
    local counter (per-replica truth, what `snapshot()` reports) and
    the parent registry's counter of the same name (the global rollup
    existing dashboards and tests read)."""

    def __init__(self, parent: MetricsRegistry, namespace: str):
        super().__init__()
        self.parent = parent
        self.namespace = namespace

    def _get(self, name, cls, *args):
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != cls.kind:
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                up = self.parent._get(name, cls, *args)
                local = cls(name, *args)
                m = self._metrics[name] = _FANOUT[cls.kind](local, up)
            elif m.kind != cls.kind:
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}")
            return m


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def child(namespace: str) -> ChildRegistry:
    """Namespaced child of the process-wide registry."""
    return _REGISTRY.child(namespace)


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return _REGISTRY.histogram(name, buckets)


def inc(name: str, v=1):
    _REGISTRY.counter(name).inc(v)


def set_gauge(name: str, v):
    _REGISTRY.gauge(name).set(v)


def observe(name: str, v):
    _REGISTRY.histogram(name).observe(v)


class timed:
    """Context manager: wall-clock milliseconds into a histogram.

        with metrics.timed("jit/compile_ms"):
            compile()
    """

    __slots__ = ("hist", "_t0")

    def __init__(self, name_or_hist):
        self.hist = name_or_hist if isinstance(name_or_hist, Histogram) \
            else _REGISTRY.histogram(name_or_hist)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe((time.perf_counter() - self._t0) * 1e3)
        return False


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def to_json(indent=None) -> str:
    return _REGISTRY.to_json(indent)


def to_prometheus_text() -> str:
    return _REGISTRY.to_prometheus_text()


def snapshot_to_file(path: str):
    _REGISTRY.snapshot_to_file(path)


def enable_periodic_flush(path: str, interval_s: float = 10.0):
    _REGISTRY.enable_periodic_flush(path, interval_s)


def disable_periodic_flush(final_flush: bool = True):
    _REGISTRY.disable_periodic_flush(final_flush)


def reset():
    _REGISTRY.reset()


# env-armed crash-safe flush: PT_METRICS_FLUSH_PATH=/path/metrics.json
# [PT_METRICS_FLUSH_INTERVAL=10]
_env_path = os.environ.get("PT_METRICS_FLUSH_PATH")
if _env_path:
    try:
        enable_periodic_flush(
            _env_path,
            float(os.environ.get("PT_METRICS_FLUSH_INTERVAL", "10") or 10))
    except (OSError, ValueError):
        pass
