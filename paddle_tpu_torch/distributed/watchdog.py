"""Collective desync watchdog (the port's copy of
paddle_tpu/distributed/watchdog.py).

Reference analog: CommTaskManager + CommTask
(paddle/phi/core/distributed/comm_task_manager.h,
paddle/phi/core/distributed/nccl_comm_task.cc) — an async
watchdog thread that tracks every in-flight collective, and when one stalls
past a timeout dumps per-rank diagnostics (op, group, sequence number,
elapsed) so hangs caused by ranks issuing mismatched collective sequences
can be localised.

NCCL runs asynchronously to the host, so a record never synchronises: every
collective issued through ``paddle_tpu_torch.distributed.collective``
registers a ``CommTask`` carrying the group's monotonically increasing
**sequence number** and, while the watchdog is enabled, a CUDA event
recorded on the stream after the collective (a gloo collective completes
on the host and is done when it returns; an async one is watched through
its Work's ``is_completed``). The watchdog loop polls ``event.query()``
non-blockingly — exactly as the reference polls CUDA events. A task that is
still pending past the timeout triggers a structured dump to stderr and
(optionally) a file, including the per-group sequence counters — comparing
these across ranks' dumps is exactly how the reference's "found async_op
desync" report works.

Enable with ``enable_comm_watchdog(timeout_s)`` or env
``FLAGS_comm_watchdog_timeout`` (seconds; 0 disables — the default, as in
the reference where FLAGS_enable_async_trace defaults off).

Escalation (resilience): a task stalled past the timeout no longer just
dumps — the watchdog marks the group unhealthy in the rendezvous store
(``__unhealthy__/<gid>`` with the dump payload, visible to every member,
and for a sub-group also ``__unhealthy__/0``, the world's key, which the
launch controller reads) and aborts the local transport with a
structured ``CommTimeoutError``, so the blocked rank RAISES instead of
hanging while its peers spin. The store is the transport's when one is
up, else a client dialled to the launcher's store (``PADDLE_MASTER``):
an NCCL trainer brings up no transport. The group's torch process group
is aborted too (``ProcessGroup.abort()``, or
``torch.distributed.distributed_c10d._abort_process_group`` where the
installed PyTorch offers only that), so a rank blocked in an NCCL
collective returns, and the next collective issued on the group raises
the ``CommTimeoutError``; a PyTorch that offers neither leaves the
blocked worker to the elastic launcher, which kills and re-forms the pod.
Disable with ``FLAGS_comm_watchdog_escalate=0`` (dump-only, the
pre-escalation behavior).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..profiler import metrics as _metrics
from .resilience.errors import CommTimeoutError

__all__ = [
    "CommTask", "CommTaskManager", "enable_comm_watchdog",
    "disable_comm_watchdog", "comm_task_manager",
    "unhealthy_key", "read_unhealthy", "clear_unhealthy",
]

_m_escalations = _metrics.counter("comm/watchdog_escalations")

UNHEALTHY_PREFIX = "__unhealthy__"


def unhealthy_key(group_id: int) -> str:
    """Store key under which the watchdog marks a stalled group."""
    return f"{UNHEALTHY_PREFIX}/{group_id}"


def read_unhealthy(store, group_id: int) -> Optional[dict]:
    """The stalled-task dump a watchdog published for `group_id`, or
    None. Consumers (launch controller, elastic supervisor) use this as
    the re-form trigger for hung-but-heartbeating ranks."""
    try:
        raw = store.get_nowait(unhealthy_key(group_id))
    except KeyError:
        return None
    except Exception:
        # the store may be unreachable mid-failure: treat as "no mark"
        # (counted; the transport error path still drives recovery)
        _metrics.inc("comm/escalation_store_errors")
        return None
    try:
        return json.loads(raw if isinstance(raw, str) else raw.decode())
    except (ValueError, AttributeError):
        return {}


def clear_unhealthy(store, group_id: int) -> bool:
    """Delete a stale ``__unhealthy__/<gid>`` mark. Called after a
    successful group re-form — a recovered pod must not immediately
    re-trigger escalation off the previous incarnation's mark. Returns
    True when a mark was present and cleared."""
    if read_unhealthy(store, group_id) is None:
        return False
    store.delete_key(unhealthy_key(group_id))
    _metrics.inc("elastic/unhealthy_cleared")
    return True


class CommTask:
    """One in-flight collective (reference: phi::distributed::CommTask)."""

    __slots__ = ("op_name", "group_id", "group_ranks", "seq", "rank",
                 "start_time", "done", "dumped", "shape", "dtype", "_arr")

    def __init__(self, op_name: str, group_id: int, group_ranks: List[int],
                 seq: int, rank: int, shape=None, dtype=None):
        self.op_name = op_name
        self.group_id = group_id
        self.group_ranks = group_ranks
        self.seq = seq
        self.rank = rank
        self.start_time = time.monotonic()
        self.done = False
        self.dumped = False
        self.shape = shape
        self.dtype = dtype
        self._arr = None           # the completion probe (see attach)

    def attach(self, value):
        """Bind the collective's completion signal: a CUDA event recorded
        after it (``query()``), or a torch Work (``is_completed()``). Any
        other object is held by weak reference: its release marks the
        task done."""
        if hasattr(value, "query") or hasattr(value, "is_completed"):
            self._arr = lambda: value
            return
        import weakref
        try:
            self._arr = weakref.ref(value)
        except TypeError:
            self._arr = None

    def poll(self) -> bool:
        """Non-blocking completion check; updates and returns ``done``."""
        if self.done:
            return True
        if self._arr is None:
            # attach() not (yet) called — stays pending; start_task marks
            # it done when a later collective is issued on the same group
            # (per-group dispatch order), so an attach() that failed or was
            # skipped cannot dump forever on an active group
            return False
        arr = self._arr()
        if arr is None:
            # output released by the program -> it was dispatched and
            # consumed; nothing left to watch
            self.done = True
        else:
            try:
                if hasattr(arr, "query"):
                    ready = arr.query()
                elif hasattr(arr, "is_completed"):
                    ready = arr.is_completed()
                else:
                    ready = False
                if ready:
                    self.done = True
            except Exception:
                # by-design best-effort probe on the 1 Hz poll path: a
                # failed communicator raises here, which just means
                # "not observably ready yet" — the task stays pending
                # and the timeout still fires
                pass
        return self.done

    def elapsed(self) -> float:
        return time.monotonic() - self.start_time

    def mark_done(self):
        self.done = True

    def to_dict(self):
        return {
            "op": self.op_name,
            "group_id": self.group_id,
            "group_ranks": self.group_ranks,
            "seq": self.seq,
            "rank": self.rank,
            "elapsed_s": round(self.elapsed(), 3),
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": str(self.dtype) if self.dtype is not None else None,
        }


class CommTaskManager:
    """Tracks in-flight collectives; a daemon thread dumps stalled ones.

    Reference: CommTaskManager::CommTaskLoop / CommTaskClearLoop
    (comm_task_manager.cc) — here one loop does both: it polls each
    task's CUDA event (or Work) and retires the finished ones.
    """

    _POLL_S = 1.0

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: List[CommTask] = []
        self._seq: Dict[int, int] = {}          # group_id -> last seq issued
        self._last: Dict[int, CommTask] = {}    # group_id -> last task
        # cumulative per-group stats — ALWAYS on (unlike the watchdog
        # thread): group_id -> op -> {count, bytes, total_ms, max_ms}.
        # Fed by every collective issued through distributed.collective,
        # so a timeout dump shows each group's lifetime traffic, not
        # just the in-flight task that stalled.
        self._group_stats: Dict[int, Dict[str, dict]] = {}
        self._timeout_s = float(os.environ.get(
            "FLAGS_comm_watchdog_timeout", "0") or 0)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.dump_path = os.environ.get("FLAGS_comm_watchdog_dump_path", "")
        # escalate stalled tasks into structured errors on every member
        # (dump-only with FLAGS_comm_watchdog_escalate=0)
        self.escalate = os.environ.get(
            "FLAGS_comm_watchdog_escalate", "1") != "0"

    # -- configuration ----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._timeout_s > 0

    def enable(self, timeout_s: float):
        self._timeout_s = float(timeout_s)
        if self._timeout_s > 0 and (self._thread is None
                                    or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="comm_watchdog", daemon=True)
            self._thread.start()

    def disable(self):
        self._timeout_s = 0.0
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            self._tasks.clear()
            self._last.clear()
        self.dump_path = os.environ.get("FLAGS_comm_watchdog_dump_path", "")

    # -- task tracking -----------------------------------------------------
    def next_seq(self, group_id: int) -> int:
        with self._lock:
            self._seq[group_id] = self._seq.get(group_id, 0) + 1
            return self._seq[group_id]

    def start_task(self, op_name: str, group_id: int, group_ranks: List[int],
                   rank: int, shape=None, dtype=None) -> Optional[CommTask]:
        if not self.enabled:
            return None
        seq = self.next_seq(group_id)
        task = CommTask(op_name, group_id, group_ranks, seq, rank,
                        shape=shape, dtype=dtype)
        with self._lock:
            # dispatch on a group is ordered: starting a new task proves
            # every earlier un-attached dispatch on the same group returned
            # (its attach() failed or was skipped) — retire it instead of
            # letting it dump a guaranteed-false timeout. Each start does
            # so, so only the group's last task can be un-attached
            prev = self._last.get(group_id)
            if prev is not None and prev._arr is None:
                prev.mark_done()
            self._last[group_id] = task
            self._tasks.append(task)
        return task

    def seq_counters(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._seq)

    # -- cumulative per-group stats (always on) ---------------------------
    def record_stats(self, op_name: str, group_id: int, nbytes: int = 0,
                     elapsed_ms: Optional[float] = None):
        """Fold one completed collective into the per-group totals."""
        with self._lock:
            ops = self._group_stats.setdefault(group_id, {})
            st = ops.get(op_name)
            if st is None:
                st = ops[op_name] = {"count": 0, "bytes": 0,
                                     "total_ms": 0.0, "max_ms": 0.0}
            st["count"] += 1
            st["bytes"] += int(nbytes)
            if elapsed_ms is not None:
                st["total_ms"] = round(st["total_ms"] + elapsed_ms, 3)
                if elapsed_ms > st["max_ms"]:
                    st["max_ms"] = round(elapsed_ms, 3)

    def group_stats(self) -> Dict[int, Dict[str, dict]]:
        with self._lock:
            return {gid: {op: dict(st) for op, st in ops.items()}
                    for gid, ops in self._group_stats.items()}

    def reset_stats(self):
        with self._lock:
            self._group_stats.clear()

    def pending(self) -> List[CommTask]:
        with self._lock:
            return [t for t in self._tasks if not t.poll()]

    # -- watchdog loop -----------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self._POLL_S):
            if not self.enabled:
                continue
            now_stalled = []
            with self._lock:
                self._tasks = [t for t in self._tasks if not t.poll()]
                for t in self._tasks:
                    if t.elapsed() > self._timeout_s and not t.dumped:
                        t.dumped = True
                        now_stalled.append(t)
            for t in now_stalled:
                self._dump(t)
                if self.escalate:
                    self._escalate(t)

    def _escalate(self, task: CommTask):
        """Stalled past timeout: mark the group unhealthy in the store
        (every member and the launch controller can see it), abort the
        local transport and the group's process group, so the blocked
        rank raises a structured CommTimeoutError instead of hanging."""
        _m_escalations.inc()
        from ..profiler import tracing as _tracing

        _tracing.flight_dump("watchdog_escalation",
                             stalled=task.to_dict(),
                             timeout_s=self._timeout_s)
        err = CommTimeoutError(task.op_name, task.group_id, task.seq,
                               task.rank, self._timeout_s)
        try:
            from .transport import get_transport

            tp = get_transport()
            self._mark_unhealthy(tp._store if tp is not None else None,
                                 task)
            if tp is not None:
                tp.abort(err)
            self._abort_process_group(task.group_id, err)
        except Exception:
            _metrics.inc("comm/escalation_errors")

    @staticmethod
    def _mark_unhealthy(store, task: CommTask):
        """Write the stalled task's dump under the group's key and, for a
        sub-group, the world's (group 0, the key the launch controller
        reads). Without ``store`` (no transport is up) a client is dialled
        to ``PADDLE_MASTER``; with neither, or a store that fails (it may
        be down WITH the dead peer), comm/escalation_store_errors counts
        it and the aborts still unblock this rank."""
        own = None
        try:
            if store is None:
                master = os.environ.get("PADDLE_MASTER")
                if not master:
                    raise ConnectionError("no transport and no "
                                          "PADDLE_MASTER to mark")
                from .store import connect_store

                host, port = master.rsplit(":", 1)
                store = own = connect_store(host, int(port), timeout=10.0)
            payload = json.dumps(task.to_dict())
            for gid in dict.fromkeys((task.group_id, 0)):
                store.set(unhealthy_key(gid), payload)
        except Exception:
            _metrics.inc("comm/escalation_store_errors")
        finally:
            if own is not None:
                own.close()

    @staticmethod
    def _abort_process_group(group_id: int, err: BaseException):
        """Abort the torch process group of ``group_id`` so a rank blocked
        in its collective returns (NCCL; gloo's abort is a no-op), and
        make the next collective issued on the group raise ``err``.
        Counted as comm/pg_aborts; a PyTorch without an abort counts
        comm/pg_abort_unavailable and leaves a blocked worker to the
        launcher's re-formation."""
        tdist = sys.modules.get("torch.distributed")
        if tdist is None or not tdist.is_available() \
                or not tdist.is_initialized():
            return
        from .collective import get_group

        g = get_group(group_id)
        pg = getattr(g, "process_group", None)
        if pg is None:
            return
        g.aborted = err
        if hasattr(pg, "abort"):
            pg.abort()
        else:
            abort = getattr(tdist.distributed_c10d, "_abort_process_group",
                            None)
            if abort is None:
                _metrics.inc("comm/pg_abort_unavailable")
                return
            abort(pg)
        _metrics.inc("comm/pg_aborts")

    def _dump(self, task: CommTask):
        report = {
            "event": "comm_task_timeout",
            "timeout_s": self._timeout_s,
            "stalled": task.to_dict(),
            "group_seq_counters": self.seq_counters(),
            "group_cumulative_stats": self.group_stats(),
            "hint": "compare group_seq_counters across ranks' dumps; a "
                    "rank whose counter trails issued fewer collectives "
                    "on that group (desync)",
        }
        line = json.dumps(report)
        print(f"[comm_watchdog] {line}", file=sys.stderr, flush=True)
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass


comm_task_manager = CommTaskManager()
if comm_task_manager._timeout_s > 0:       # env-enabled at import
    comm_task_manager.enable(comm_task_manager._timeout_s)


def enable_comm_watchdog(timeout_s: float = 600.0, dump_path: str = ""):
    """Turn on the collective watchdog (reference:
    FLAGS_enable_async_trace + comm task timeout)."""
    if dump_path:
        comm_task_manager.dump_path = dump_path
    comm_task_manager.enable(timeout_s)


def disable_comm_watchdog():
    comm_task_manager.disable()
