"""Fleet-wide distributed tracing: trace contexts, a span ring, and a
crash flight recorder.

Plain `RecordEvent` spans are process-local and only recorded while a
`Profiler` session is active. The fleet stack (router → replica →
disagg prefill/decode → drain/migrate) moves one request through many
engines and, in production, many processes — so spans here carry a
`TraceContext` (trace_id / span_id / parent_id) that is

  * propagated inside a process through a contextvar (`span(...)`
    context manager — which still drives `RecordEvent`, so Profiler
    chrome traces keep working),
  * serialized into cross-process hand-off payloads (disagg migration
    meta, drain/requeue info dicts) via `inject`/`extract`, and
  * attached to request-lifecycle spans (`record_span`) that the
    serving engine emits at phase boundaries: admission → queue →
    prefill → migrate → decode.

All finished spans land in an always-on bounded ring (no Profiler
session required; capacity `PT_TRACE_RING`, default 4096) and export to
chrome-trace JSON with the ids in `args`, so `tools/trace_report.py`
can merge multi-host traces onto one timeline and a migrated request's
pre- and post-migration spans join under one trace id.

The `FlightRecorder` keeps a second bounded ring of annotated events
(span completions are mirrored into it, hooks add notes) and dumps
ring + counter deltas + a full metrics snapshot to disk when something
dies: `EngineDeadError` drains, comm-watchdog escalation, quorum loss.
Dumps go to `PT_FLIGHT_DIR` (or a directory set via
`set_flight_dir`); with neither configured the dump is a no-op so the
hot path never grows a hard filesystem dependency.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

from . import RecordEvent
from . import metrics as _metrics

__all__ = [
    "TraceContext", "current", "use_context", "span", "record_span",
    "child_of", "inject", "extract", "ring_spans", "clear_ring",
    "export_chrome", "FlightRecorder", "flight", "flight_note",
    "flight_dump", "set_flight_dir",
]

_m_spans = _metrics.counter("trace/spans")
_m_dumps = _metrics.counter("trace/flight_dumps")
_m_dump_errors = _metrics.counter("trace/flight_dump_errors")


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """Identity of one span inside one trace.

    `trace_id` names the whole request/operation tree; `span_id` names
    this span; `parent_id` links to the enclosing span (None at roots).
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new_root(cls) -> "TraceContext":
        return cls(_new_id(), _new_id(), None)

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_id(), self.span_id)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceContext":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"))

    def __repr__(self):
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id})")


_current: contextvars.ContextVar = contextvars.ContextVar(
    "pt_trace_ctx", default=None)


def current() -> Optional[TraceContext]:
    """The TraceContext of the innermost open `span(...)`, if any."""
    return _current.get()


def child_of(ctx) -> TraceContext:
    """Mint a child context of `ctx` (a TraceContext, a dict from
    `to_dict`, or None → fresh root)."""
    if ctx is None:
        return TraceContext.new_root()
    if isinstance(ctx, dict):
        ctx = TraceContext.from_dict(ctx)
    return ctx.child()


class use_context:
    """Install `ctx` as the ambient trace context for a `with` block."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self._token = _current.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


# -- span ring ------------------------------------------------------------

_RING_CAP = int(os.environ.get("PT_TRACE_RING", "4096") or 4096)
_ring = deque(maxlen=max(64, _RING_CAP))
_ring_lock = threading.Lock()


def _push(span_dict: dict) -> None:
    with _ring_lock:
        _ring.append(span_dict)
    _m_spans.inc()
    flight.note("span", **span_dict)


def ring_spans():
    """Snapshot of the bounded span ring (list of span dicts)."""
    with _ring_lock:
        return list(_ring)


def clear_ring():
    with _ring_lock:
        _ring.clear()


def record_span(name: str, begin: float, end: float, ctx=None, parent=None,
                args: Optional[dict] = None) -> TraceContext:
    """Record a completed span directly (no context manager).

    `begin`/`end` are `time.perf_counter()` seconds. Identity: pass
    `ctx` to use it as-is, or `parent` (TraceContext/dict/None) to mint
    a child; with neither, the ambient context parents the span.
    Returns the span's context so callers can chain children off it.
    """
    if ctx is None:
        ctx = child_of(parent if parent is not None else _current.get())
    elif isinstance(ctx, dict):
        ctx = TraceContext.from_dict(ctx)
    d = {"name": name, "ts": float(begin),
         "dur": max(0.0, float(end) - float(begin)),
         "trace_id": ctx.trace_id, "span_id": ctx.span_id,
         "parent_id": ctx.parent_id, "pid": os.getpid()}
    if args:
        d["args"] = dict(args)
    _push(d)
    return ctx


class span:
    """Context manager: a traced span that nests via the contextvar and
    also drives `RecordEvent` so active Profiler sessions see it."""

    __slots__ = ("name", "args", "ctx", "_t0", "_token", "_rev")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args

    def __enter__(self):
        self.ctx = child_of(_current.get())
        self._token = _current.set(self.ctx)
        self._rev = RecordEvent(self.name)
        self._rev.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._rev.__exit__(*exc)
        _current.reset(self._token)
        record_span(self.name, self._t0, end, ctx=self.ctx,
                    args=self.args or None)
        return False


# -- cross-process propagation -------------------------------------------

TRACE_META_KEY = "trace"


def inject(meta: dict, ctx: Optional[TraceContext] = None) -> dict:
    """Serialize `ctx` (default: ambient) into a hand-off payload."""
    if ctx is None:
        ctx = _current.get()
    if ctx is not None:
        meta[TRACE_META_KEY] = ctx.to_dict()
    return meta


def extract(meta: Optional[dict]) -> Optional[TraceContext]:
    """Recover a TraceContext from a hand-off payload (or None)."""
    if not meta:
        return None
    d = meta.get(TRACE_META_KEY)
    return TraceContext.from_dict(d) if d else None


# -- chrome export --------------------------------------------------------

def export_chrome(path: Optional[str] = None, spans=None,
                  clock_offset_s: float = 0.0, pid=None) -> dict:
    """Render spans (default: the ring) as chrome-trace JSON with the
    trace/span/parent ids in each event's `args`. `clock_offset_s`
    shifts timestamps so multi-host traces merge onto one timeline."""
    evs = []
    for s in (ring_spans() if spans is None else spans):
        ev = {"name": s["name"], "ph": "X",
              "pid": pid if pid is not None else s.get("pid", 0),
              "tid": 0,
              "ts": (s["ts"] + clock_offset_s) * 1e6,
              "dur": s["dur"] * 1e6,
              "args": {"trace_id": s.get("trace_id"),
                       "span_id": s.get("span_id"),
                       "parent_id": s.get("parent_id"),
                       **(s.get("args") or {})}}
        evs.append(ev)
    trace = {"traceEvents": evs}
    if path:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


# -- flight recorder ------------------------------------------------------

class FlightRecorder:
    """Bounded ring of recent annotated events + span completions,
    dumped to disk with counter deltas when the process hits a fatal
    fault. One dump file per incident:
    ``<dir>/flight_<reason>_<pid>_<seq>.json``."""

    def __init__(self, capacity: int = 512):
        self._ring = deque(maxlen=max(16, capacity))
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._seq = 0
        self._base_counters = {}
        # named section providers: zero-arg callables evaluated at dump
        # time whose JSON-safe return value is embedded in the doc
        # (profiler/timeline.py attaches its last-N-windows view here,
        # so every black box carries the minutes before the incident)
        self._sections = {}

    def configure(self, directory: Optional[str]) -> None:
        self._dir = directory

    def attach(self, name: str, provider) -> None:
        """Register `provider` (zero-arg, JSON-safe return) to be
        evaluated and embedded as ``doc[name]`` in every future dump."""
        with self._lock:
            self._sections[name] = provider

    def detach(self, name: str) -> None:
        with self._lock:
            self._sections.pop(name, None)

    def note(self, kind: str, **payload) -> None:
        with self._lock:
            self._ring.append({"t": time.perf_counter(), "kind": kind,
                               **payload})

    def events(self):
        with self._lock:
            return list(self._ring)

    def _counter_deltas(self, snap: dict) -> dict:
        # read-modify-write on the delta baseline: two concurrent dumps
        # (e.g. a crash handler racing a periodic dump) would otherwise
        # double-count or drop deltas
        cur = snap.get("counters", {})
        deltas = {}
        with self._lock:
            for name, v in cur.items():
                d = v - self._base_counters.get(name, 0)
                if d:
                    deltas[name] = d
            self._base_counters = dict(cur)
        return deltas

    def dump(self, reason: str, path: Optional[str] = None,
             **meta) -> Optional[str]:
        """Write the black box. Returns the file path, or None when no
        destination is configured (PT_FLIGHT_DIR / set_flight_dir /
        explicit `path`). Never raises: a postmortem writer must not
        take down the crash handler that called it."""
        directory = None
        if path is None:
            directory = self._dir or os.environ.get("PT_FLIGHT_DIR")
            if not directory:
                return None
        try:
            snap = _metrics.snapshot()
            with self._lock:
                self._seq += 1
                seq = self._seq
                events = list(self._ring)
            doc = {
                "reason": reason,
                "ts": time.time(),
                "pid": os.getpid(),
                "meta": meta,
                "events": events,
                "spans": ring_spans(),
                "counter_deltas": self._counter_deltas(snap),
                "metrics": snap,
            }
            with self._lock:
                sections = dict(self._sections)
            for name, provider in sections.items():
                if name in doc:
                    continue
                try:
                    doc[name] = provider()
                except Exception:
                    doc[name] = {"error": "section provider failed"}
            if path is None:
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory, f"flight_{reason}_{os.getpid()}_{seq}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _m_dumps.inc()
            return path
        except (OSError, TypeError, ValueError):
            _m_dump_errors.inc()
            return None


flight = FlightRecorder()


def flight_note(kind: str, **payload) -> None:
    flight.note(kind, **payload)


def flight_dump(reason: str, **meta) -> Optional[str]:
    return flight.dump(reason, **meta)


def set_flight_dir(directory: Optional[str]) -> None:
    flight.configure(directory)
