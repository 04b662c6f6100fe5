"""Profiler (reference: python/paddle/profiler/profiler.py:346 + the C++
layered tracers in paddle/fluid/platform/profiler/).

Device-side tracing is `torch.profiler` (CUPTI on the card, exported as
chrome-trace JSON); host spans are RecordEvent instrumentation aggregated
into a summary table. Both run under one Profiler orchestrator with the
reference's scheduler-state API. A RecordEvent span opened while a session
records also opens a `torch.profiler.record_function`, so it shows in the
device trace beside the kernels it launched."""
from __future__ import annotations

import enum
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Optional

from . import metrics

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "export_protobuf",
           "load_profiler_result", "SummaryView", "metrics",
           "host_tracing_active", "tracing", "digest", "aggregate",
           "timeline", "slo", "headroom", "TraceContext"]


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class SummaryView(enum.Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


def make_scheduler(closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        cycle = closed + ready + record
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


class _HostEventCollector(threading.local):
    def __init__(self):
        self.events = []
        self.active = False


_collector = _HostEventCollector()
# True while a torch.profiler session of some Profiler records: only then
# does a RecordEvent pay for a record_function.
_device_tracing = [False]


def host_tracing_active() -> bool:
    """True while a Profiler is collecting host spans — instrumented hot
    paths check this before opening per-event RecordEvent spans so the
    always-on cost is one attribute read."""
    return _collector.active


class RecordEvent:
    """Host instrumentation span (reference: platform/profiler RecordEvent)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self.begin = None
        self._rf = None

    def __enter__(self):
        self.begin = time.perf_counter()
        if _device_tracing[0]:
            import torch

            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self.begin is not None and _collector.active:
            _collector.events.append(
                (self.name, self.begin, time.perf_counter()))
            self.begin = None


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof):
        prof._export_dir = dir_name
        prof.export(os.path.join(
            dir_name, (worker_name or "worker") + ".json"))
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


class Profiler:
    """Orchestrator with scheduler states. Device tracing =
    torch.profiler (CPU and CUDA activities); host spans = RecordEvent
    collection.

    The default targets are CPU and GPU; without CUDA that raises, and a
    caller that wants a host-only trace passes `targets=[ProfilerTarget.CPU]`.
    GPU and TPU both name the accelerator, which here is the CUDA card."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        self._device = any(t in (ProfilerTarget.GPU, ProfilerTarget.TPU)
                           for t in self.targets)
        if ProfilerTarget.CUSTOM_DEVICE in self.targets:
            raise ValueError("ProfilerTarget.CUSTOM_DEVICE has no tracer "
                             "in this framework")
        if self._device and not timer_only:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Profiler targets the GPU but CUDA is not available; "
                    "pass targets=[ProfilerTarget.CPU] for a host-only "
                    "trace")
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=max(lo, 0), ready=0,
                                            record=hi - lo, repeat=1)
        else:
            self.scheduler = scheduler or (
                lambda step: ProfilerState.RECORD)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.with_flops = with_flops
        self.step_num = 0
        self.state = ProfilerState.CLOSED
        self._prof = None          # the running torch.profiler.profile
        self._last_prof = None     # the last finished one, for export
        self._step_times = []
        self._last_step_t = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def _torch_start(self):
        if self._prof is not None or self.timer_only:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._device:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts, record_shapes=self.record_shapes,
            profile_memory=self.profile_memory, with_flops=self.with_flops)
        prof.__enter__()
        self._prof = prof
        _device_tracing[0] = True

    def _torch_stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        _device_tracing[0] = False
        prof.__exit__(None, None, None)
        self._last_prof = prof

    def start(self):
        _collector.active = True
        _collector.events = []
        self.state = self.scheduler(self.step_num)
        if self.state in _RECORDING:
            self._torch_start()
        self._last_step_t = time.perf_counter()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append((now - self._last_step_t, num_samples))
        self._last_step_t = now
        self.step_num += 1
        new_state = self.scheduler(self.step_num)
        if new_state != self.state:
            if new_state in _RECORDING:
                self._torch_start()
            elif self.state in _RECORDING:
                self._torch_stop()
                if self.on_trace_ready:
                    self.on_trace_ready(self)
            self.state = new_state

    def stop(self):
        self._torch_stop()
        _collector.active = False
        if self.on_trace_ready and self.state in _RECORDING:
            self.on_trace_ready(self)

    def export(self, path: str, format: str = "json"):
        """Export chrome-trace JSON: the torch.profiler trace of the last
        recorded window (which holds the RecordEvent spans as
        `user_annotation` events beside the kernels), plus every host span
        of this session as a complete ("X") event in category
        `host_span`."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        trace = {"traceEvents": []}
        if self._last_prof is not None:
            self._last_prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        for name, b, e in _collector.events:
            trace["traceEvents"].append({
                "name": name, "ph": "X", "pid": 0, "tid": 0,
                "cat": "host_span", "ts": b * 1e6, "dur": (e - b) * 1e6,
            })
        with open(path, "w") as f:
            json.dump(trace, f)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None):
        agg = defaultdict(lambda: [0.0, 0])
        for name, b, e in _collector.events:
            agg[name][0] += (e - b) * 1e3
            agg[name][1] += 1
        lines = [f"{'Name':<40} {'Calls':>8} {'Total(ms)':>12} "
                 f"{'Avg(ms)':>12}"]
        for name, (total, calls) in sorted(agg.items(),
                                           key=lambda kv: -kv[1][0]):
            lines.append(
                f"{name:<40} {calls:>8} {total:>12.3f} "
                f"{total / max(calls, 1):>12.3f}")
        table = "\n".join(lines)
        print(table)
        return table

    # throughput timer (reference: profiler/timer.py benchmark hooks)
    def step_info(self, unit="samples"):
        if not self._step_times:
            return "no steps recorded"
        import numpy as np

        times = np.asarray([t for t, _ in self._step_times[-20:]])
        ips = None
        samples = [n for _, n in self._step_times[-20:] if n]
        if samples:
            ips = np.asarray(samples) / times[-len(samples):]
        msg = f"avg step: {times.mean() * 1e3:.2f} ms"
        if ips is not None:
            msg += f", ips: {ips.mean():.1f} {unit}/s"
        return msg


# fleet observability plane, imported last: tracing layers TraceContext
# propagation on RecordEvent (above), aggregate ships registry snapshots
# across processes, digest is the mergeable quantile sketch both use; the
# serving plane: timeline (the time dimension over the registry), slo
# (objectives, attainment and burn alerts over the gateway's outcomes),
# headroom (the autoscaler's advisory interface)
from . import digest           # noqa: E402
from . import tracing          # noqa: E402
from . import aggregate        # noqa: E402
from . import timeline         # noqa: E402
from . import slo              # noqa: E402
from . import headroom         # noqa: E402
from .tracing import TraceContext  # noqa: E402
from .aggregate import FleetAggregator  # noqa: E402
from .timeline import Timeline, load_spill  # noqa: E402
from .slo import SLOAlert, SLOObjective, SLOTracker  # noqa: E402
from .headroom import ScaleAdvice, ScaleAdvisor  # noqa: E402
