"""The errors of live weight publishing and of the rendezvous store: the
port's own copies of paddle_tpu/distributed/resilience/errors.py's
PublishRejectedError and WeightTransferError (:156-200), TransportError,
StoreTimeoutError and StaleGenerationError (:22-23, 119-155), with the
reference's arguments, attributes and messages. The rest of that taxonomy
(the transport's, collectives', engine liveness) comes with the modules
that raise it (ROADMAP.md, queue 1)."""
from __future__ import annotations

from typing import Optional

__all__ = ["PublishRejectedError", "WeightTransferError", "TransportError",
           "StoreTimeoutError", "StaleGenerationError"]


class TransportError(RuntimeError):
    """Base class for eager-transport failures."""


class StoreTimeoutError(TransportError, TimeoutError):
    """A rendezvous-store read (``get``/``wait``) expired. Names the key,
    the store endpoint and the budget, and subclasses ``TimeoutError``."""

    def __init__(self, key: str, endpoint: Optional[str],
                 timeout_s: Optional[float], op: str = "get"):
        self.key = key
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.op = op
        super().__init__(
            f"store {op} on key {key!r} at {endpoint or '<unknown>'} "
            f"timed out after {timeout_s}s")


class StaleGenerationError(RuntimeError):
    """A fenced store write carried a generation older than the fence:
    the writer was partitioned out of a re-formed group. Not a
    TransportError: the write fails fast and is never retried."""

    def __init__(self, key: str, domain: str, write_gen: int,
                 fence_gen: int):
        self.key = key
        self.domain = domain
        self.write_gen = write_gen
        self.fence_gen = fence_gen
        super().__init__(
            f"fenced write to {key!r} refused: generation {write_gen} "
            f"is stale (fence for domain {domain!r} is at generation "
            f"{fence_gen}) — this rank was partitioned out of the "
            f"re-formed group and must rejoin through rendezvous")


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
