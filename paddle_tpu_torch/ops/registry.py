"""The op registry and per-op call tallies (paddle_tpu/ops/registry.py).

``defop`` records each op it defines (name -> the function of torch
tensors, differentiable or not); every call through ``core.dispatch.apply``
is tallied by name, including inline functions that never registered.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["OpInfo", "register", "get", "record_call", "op_call_counts",
           "reset_call_counts"]


@dataclass
class OpInfo:
    name: str
    fn: Callable
    differentiable: bool = True


_REGISTRY: Dict[str, OpInfo] = {}


def register(name: str, fn: Callable, differentiable: bool = True):
    _REGISTRY[name] = OpInfo(name, fn, differentiable)
    return _REGISTRY[name]


def get(name: str) -> Optional[OpInfo]:
    return _REGISTRY.get(name)


_call_counts: Dict[str, int] = {}
_call_lock = threading.Lock()


def record_call(name: str):
    with _call_lock:
        _call_counts[name] = _call_counts.get(name, 0) + 1


def op_call_counts(top: Optional[int] = None) -> Dict[str, int]:
    """Calls a op since the last reset, most first (optionally the top N)."""
    with _call_lock:
        items = sorted(_call_counts.items(), key=lambda kv: -kv[1])
    return dict(items if top is None else items[:top])


def reset_call_counts():
    with _call_lock:
        _call_counts.clear()
