"""The errors of live weight publishing: the port's own copies of
paddle_tpu/distributed/resilience/errors.py's PublishRejectedError and
WeightTransferError (:156-200), with the reference's arguments, attributes
and messages. The rest of that taxonomy (transport, collectives, engine
liveness) comes with the modules that raise it (ROADMAP.md, queue 1)."""
from __future__ import annotations

from typing import Optional

__all__ = ["PublishRejectedError", "WeightTransferError"]


class PublishRejectedError(RuntimeError):
    """A live weight publish was refused, by policy, not by accident:
    ``reason`` says why (``stale_version`` when a newer version is already
    active, ``not_staged`` when the version was never staged,
    ``no_previous`` when there is nothing to roll back to; the reference's
    fleet tier adds ``canary_nonfinite``, ``canary_drift`` and
    ``no_replicas``), ``version`` is the refused version and, for a stale
    one, ``fence_version`` the version that outran it. A refused publish
    leaves the engine serving what it served before."""

    def __init__(self, reason: str, version: int,
                 fence_version: Optional[int] = None,
                 detail: Optional[str] = None):
        self.reason = reason
        self.version = version
        self.fence_version = fence_version
        self.detail = detail
        extra = ""
        if fence_version is not None:
            extra = f"; fence already at version {fence_version}"
        if detail:
            extra += f"; {detail}"
        super().__init__(
            f"weight publish of version {version} rejected "
            f"(reason={reason}){extra} — fleet keeps serving its "
            f"current version")


class WeightTransferError(RuntimeError):
    """A weight set failed its integrity check at the receiving engine
    (a tensor's CRC, or a tensor count, shape or dtype that disagrees with
    the serving set). Nothing is staged and the engine keeps its current
    version: a torn or corrupted set can never be committed."""

    def __init__(self, version: int, replica: str, detail: str):
        self.version = version
        self.replica = replica
        self.detail = detail
        super().__init__(
            f"weight set version {version} failed verification on "
            f"replica {replica}: {detail} — staged buffer discarded, "
            f"replica keeps its current version")
