"""Fault tolerance for the distributed stack.

Four pieces, one recovery loop (MegaScale-style per-rank failure
detection, Gemini-style fast resume):

- ``errors``: the structured failure taxonomy every layer raises from.
- ``faults``: the deterministic chaos-injection harness (PT_FAULT_PLAN)
  the transport consults, so pod failure modes run on the CPU mesh.
- transport hardening lives in ``..transport`` (CRC32 frames, ack/
  retransmit with seq dedup, redial with exponential backoff).
- ``recovery``: checkpoint discovery + ``resume_from_latest`` restoring
  the last complete atomic checkpoint via reshard-on-load, so a
  re-formed pod continues bitwise-identically on the surviving config.
- ``backoff``: the shared exponential-backoff policy every retry loop
  in ``distributed/`` goes through (lint rule PT503 enforces it).
- ``supervisor`` + ``guards``: the self-healing training loop —
  ``run_elastic`` re-forms the group after a failure and restores from
  the freshest tier (in-memory ring replica -> disk -> fresh), while
  ``StepGuard`` skips/rolls-back numerically anomalous steps.

``recovery``/``supervisor``/``guards`` are imported lazily: they pull
train-loop machinery (torch, the checkpoint) while ``errors``/``faults``/
``backoff`` stay importable from the transport and store layer.
"""
from __future__ import annotations

from . import backoff
from . import errors
from . import faults
from .errors import (CommTimeoutError, EngineDeadError,
                     FrameCorruptError, PeerUnreachableError,
                     PublishRejectedError, StaleGenerationError,
                     StoreTimeoutError, TransportClosedError,
                     TransportError, TransportTimeoutError,
                     WeightTransferError)
from .faults import FaultAction, FaultInjector, FaultPlan, FaultRule

__all__ = [
    "backoff", "errors", "faults", "recovery", "supervisor", "guards",
    "CommTimeoutError", "EngineDeadError", "FrameCorruptError",
    "PeerUnreachableError", "PublishRejectedError", "StaleGenerationError",
    "StoreTimeoutError", "WeightTransferError",
    "TransportClosedError", "TransportError", "TransportTimeoutError",
    "FaultAction", "FaultInjector", "FaultPlan", "FaultRule",
    "resume_from_latest", "save_checkpoint", "latest_checkpoint",
    "sweep_incomplete", "run_elastic", "Supervisor", "SupervisorConfig",
    "StepGuard", "GuardConfig",
]

_LAZY_RECOVERY = ("recovery", "resume_from_latest", "save_checkpoint",
                  "latest_checkpoint", "sweep_incomplete")
_LAZY_SUPERVISOR = ("supervisor", "run_elastic", "Supervisor",
                    "SupervisorConfig")
_LAZY_GUARDS = ("guards", "StepGuard", "GuardConfig")


def __getattr__(name):
    import importlib

    for lazy_names, modname in ((_LAZY_RECOVERY, "recovery"),
                                (_LAZY_SUPERVISOR, "supervisor"),
                                (_LAZY_GUARDS, "guards")):
        if name in lazy_names:
            mod = importlib.import_module(f".{modname}", __name__)
            return mod if name == modname else getattr(mod, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
