"""Exponential backoff for the retry loops of ``distributed/`` (the
port's copy of paddle_tpu/distributed/resilience/backoff.py): a retry
that sleeps a constant hammers a dead peer at a fixed rate while the
controller needs seconds to relaunch it."""
from __future__ import annotations

import time

__all__ = ["delay", "sleep_backoff"]


def delay(attempt: int, base: float = 0.05, cap: float = 2.0) -> float:
    """The delay before retry ``attempt`` (0-based):
    ``min(base * 2**attempt, cap)`` seconds."""
    return min(base * (2 ** attempt), cap)


def sleep_backoff(attempt: int, base: float = 0.05,
                  cap: float = 2.0) -> float:
    """Sleep the backoff delay for ``attempt``; returns it."""
    d = delay(attempt, base=base, cap=cap)
    time.sleep(d)
    return d
