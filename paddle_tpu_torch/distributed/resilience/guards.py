"""Numerical guards for the training loop.

The failures that *don't* crash are the expensive ones: a NaN/Inf loss
or a silently corrupted gradient trains garbage at full pod speed until
a human notices the curve. ``StepGuard`` closes that loop per step:

- **Finiteness**: loss (and optionally grad-norm) is checked through
  the same probe ``amp.debugging`` uses (``nonfinite_counts``), so the
  training-loop guard and the per-op tensor checker agree on what
  "non-finite" means.
- **Loss spike**: a relative threshold against an EMA of recent losses
  catches the blow-up that is still finite.
- **Policy**: the first K-1 consecutive anomalies are *skipped* (the
  batch is dropped, state unchanged — ``train/skipped_batches``); the
  K-th triggers a *rollback* verdict, which the supervisor serves from
  the last in-memory snapshot. Every anomaly counts in
  ``train/anomalies``.
- **``check_numerics=True``** (use the guard as a context manager)
  installs ``amp.debugging``'s per-op tensor checker for the guarded
  region — NaNs surface at the op that produced them as
  ``FloatingPointError``, which the supervisor routes back into
  ``anomaly()`` — the existing debugging path, not a parallel one.
- **SDC probe**: ``check_grad_agreement`` folds the gradients into a
  CRC32 checksum and compares it across data-parallel replicas (one
  tiny all_gather); replicas whose reduced gradients differ bitwise
  are flagged by rank (``train/sdc_flags``) — the cheap cross-replica
  agreement check for silent data corruption.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ...profiler import metrics as _metrics

__all__ = ["GuardConfig", "StepGuard", "grad_checksum",
           "OK", "SKIP", "ROLLBACK"]

OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"

_m_anomalies = _metrics.counter("train/anomalies")
_m_skipped = _metrics.counter("train/skipped_batches")
_m_sdc = _metrics.counter("train/sdc_flags")


@dataclass
class GuardConfig:
    """Anomaly policy for ``StepGuard``."""

    spike_factor: float = 10.0     # loss > factor * EMA => anomaly
    ema_beta: float = 0.9          # loss EMA decay
    warmup_steps: int = 5          # no spike detection before this many
    max_consecutive: int = 3       # K: rollback on the K-th in a row
    check_numerics: bool = False   # install amp.debugging tensor checker
    grad_checksum: bool = False    # cross-replica SDC agreement check


def grad_checksum(grads) -> int:
    """Fold a dict/list of arrays into one CRC32 (key-order-stable).
    Bitwise: two replicas that computed the same reduced gradients get
    the same checksum; any flipped bit diverges."""
    from ..transport import _encode, _to_host

    leaves = [grads[k] for k in sorted(grads)] if isinstance(grads, dict) \
        else list(grads)
    crc = 0
    for leaf in leaves:
        crc = zlib.crc32(_encode(_to_host(leaf))[1], crc)
    return crc


class StepGuard:
    """Per-step anomaly detector; see module docstring. Use as a
    context manager when ``check_numerics=True`` so the amp tensor
    checker is installed/removed with the guarded region."""

    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig()
        self.ema: Optional[float] = None
        self.steps_seen = 0
        self.consecutive = 0
        self.anomalies = 0
        self.last_reason: Optional[str] = None
        self._checker_installed = False

    # -- amp.debugging wiring (check_numerics=True) -----------------------
    def __enter__(self):
        if self.config.check_numerics:
            from ...amp import debugging as amp_dbg

            amp_dbg.enable_tensor_checker(amp_dbg.TensorCheckerConfig(
                debug_mode=amp_dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
            self._checker_installed = True
        return self

    def __exit__(self, *exc):
        if self._checker_installed:
            from ...amp import debugging as amp_dbg

            amp_dbg.disable_tensor_checker()
            self._checker_installed = False
        return False

    # -- verdicts ----------------------------------------------------------
    def _nonfinite(self, value) -> bool:
        if value is None:
            return False
        if isinstance(value, (int, float)):
            return not math.isfinite(value)
        from ...amp.debugging import nonfinite_counts

        nan, inf = nonfinite_counts(value)
        return bool(nan or inf)

    def observe(self, loss, grad_norm=None) -> str:
        """Judge one completed step: OK (accept the update), SKIP (drop
        the batch, keep state), or ROLLBACK (restore last snapshot)."""
        if self._nonfinite(loss):
            return self.anomaly("nonfinite_loss")
        if self._nonfinite(grad_norm):
            return self.anomaly("nonfinite_grad")
        val = float(np.mean(np.asarray(loss)))
        if self.ema is not None and self.steps_seen >= \
                self.config.warmup_steps and \
                val > self.config.spike_factor * max(abs(self.ema), 1e-12):
            return self.anomaly("loss_spike")
        beta = self.config.ema_beta
        self.ema = val if self.ema is None else \
            beta * self.ema + (1 - beta) * val
        self.steps_seen += 1
        self.consecutive = 0
        return OK

    def anomaly(self, reason: str) -> str:
        """Record one anomaly (from observe() or externally — e.g. the
        supervisor catching the tensor checker's FloatingPointError)
        and return the policy verdict."""
        self.anomalies += 1
        self.consecutive += 1
        self.last_reason = reason
        _m_anomalies.inc()
        if self.consecutive >= self.config.max_consecutive:
            self.consecutive = 0
            return ROLLBACK
        _m_skipped.inc()
        return SKIP

    def reset(self):
        """Forget streak state (after a rollback or a group re-form)."""
        self.consecutive = 0

    # -- cross-replica SDC agreement --------------------------------------
    def check_grad_agreement(self, grads, transport, ranks: List[int],
                             gid: int, rank: int) -> List[int]:
        """Compare this replica's gradient checksum against the group.
        Returns the ranks whose checksum disagrees with the majority
        (empty = bitwise agreement). Cost: one CRC fold + an all_gather
        of a single int64 (the psum-of-folded-checksum analog)."""
        if transport is None or len(ranks) <= 1:
            return []
        crc = grad_checksum(grads)
        gathered = transport.all_gather(
            np.asarray([crc], dtype=np.int64), ranks, gid)
        values = [int(np.asarray(g)[0]) for g in gathered]
        counts: dict = {}
        for v in values:
            counts[v] = counts.get(v, 0) + 1
        majority = max(counts, key=lambda v: counts[v])
        suspects = [r for r, v in zip(ranks, values) if v != majority]
        if suspects:
            _m_sdc.inc(len(suspects))
        return suspects
