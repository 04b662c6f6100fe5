"""Structured error taxonomy for the fault-tolerance subsystem.

Every failure the transport / collectives / recovery loop can surface is
a named class carrying the machine-readable context a controller needs
to decide between retry, re-form, and abort — never a bare Exception
with a free-text message. Deliberately stdlib-only: this module is
imported by the transport and store layer and by the chaos test harness.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = [
    "TransportError", "TransportClosedError", "TransportTimeoutError",
    "FrameCorruptError", "PeerUnreachableError", "CommTimeoutError",
    "EngineDeadError", "StoreTimeoutError", "StaleGenerationError",
    "GatewayRejectedError", "PublishRejectedError",
    "WeightTransferError",
]


class TransportError(RuntimeError):
    """Base class for eager-transport failures."""


class TransportClosedError(TransportError):
    """The transport was shut down while an operation was in flight."""


class TransportTimeoutError(TransportError, TimeoutError):
    """recv() deadline expired. Names the missing tag and what IS
    waiting in the mailbox, so a hang is debuggable from one rank's
    traceback (a desync shows up as pending tags from the wrong
    channel/sequence)."""

    def __init__(self, tag: str, pending: Optional[List[str]] = None,
                 timeout_s: Optional[float] = None):
        self.tag = tag
        self.pending = list(pending or [])
        self.timeout_s = timeout_s
        pend = ", ".join(repr(t) for t in self.pending) or "<none>"
        super().__init__(
            f"transport recv timed out after {timeout_s}s waiting for "
            f"tag {tag!r}; tags pending in mailbox: {pend}")


class FrameCorruptError(TransportError):
    """A frame repeatedly failed CRC32 verification at the receiver and
    the sender exhausted its retransmit budget."""

    def __init__(self, peer: int, fseq: int, attempts: int):
        self.peer = peer
        self.fseq = fseq
        self.attempts = attempts
        super().__init__(
            f"frame fseq={fseq} to rank {peer} failed CRC verification "
            f"after {attempts} transmit attempts (payload corrupted in "
            f"flight)")


class PeerUnreachableError(TransportError, ConnectionError):
    """Dial/redial to a peer kept failing past the retry budget."""

    def __init__(self, peer: int, addr: Optional[str], attempts: int,
                 last_error: Optional[BaseException] = None):
        self.peer = peer
        self.addr = addr
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"cannot reach rank {peer} at {addr} after {attempts} "
            f"dial attempts: {last_error!r}")


class EngineDeadError(RuntimeError):
    """A serving engine (replica) died mid-step: its scheduler loop is
    gone and its in-flight requests need a new home. Raised by the
    engine when a ``kill@prefill``/``kill@decode``/``kill@cache_save``
    chaos fault fells it in-process (the single-host analog of a replica
    process dying on a pod), and by any call into an engine whose
    ``dead`` flag is already set. The fleet supervisor treats this as
    the drain trigger: migrate the replica's in-flight requests to
    healthy peers, then restart the engine under backoff."""

    def __init__(self, name: str, site: Optional[str] = None):
        self.replica = name
        self.site = site
        at = f" at {site} site" if site else ""
        super().__init__(
            f"serving engine {name} is dead{at}: drain its in-flight "
            f"requests to a healthy replica and restart it")


class GatewayRejectedError(RuntimeError):
    """The traffic gateway refused a request — by policy, not by
    accident.  Carries the machine-readable triage a client (or the
    storm bench) needs: WHY it was refused (``reason`` — e.g.
    ``tenant_rate``, ``brownout_shed``, ``brownout_reject``,
    ``retry_budget``, ``injected_drop``), who asked (``tenant``,
    ``slo_class``), and ``retry_after_s`` — the gateway's hint for when
    capacity should exist again (the HTTP 429/503 Retry-After analog).
    A None ``retry_after_s`` means "do not retry" (e.g. the request
    itself is malformed or the tenant is over a hard quota)."""

    def __init__(self, reason: str, tenant: Optional[str] = None,
                 slo_class: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        self.reason = reason
        self.tenant = tenant
        self.slo_class = slo_class
        self.retry_after_s = retry_after_s
        hint = (f"; retry after {retry_after_s:.3f}s"
                if retry_after_s is not None else "; do not retry")
        super().__init__(
            f"gateway rejected request (reason={reason}, "
            f"tenant={tenant}, class={slo_class}){hint}")


class StoreTimeoutError(TransportError, TimeoutError):
    """A rendezvous-store read (`get`/`wait`) expired. Names the key,
    the store endpoint, and the budget so a wedged rendezvous is
    attributable from one rank's traceback — and subclasses
    ``TimeoutError`` so pre-taxonomy catch sites keep working."""

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
    the writer is on the minority side of a partition (or woke from a
    long stall) and the group has re-formed without it. Deliberately
    NOT a TransportError — the write must fail fast, never be retried
    into the re-formed group."""

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
    """A live weight publish was refused — by policy, not by accident.
    Carries the machine-readable triage the rollout controller needs:
    WHY (``reason`` — ``stale_version`` when the store fence already
    holds a newer epoch, ``canary_nonfinite`` / ``canary_drift`` when
    the golden-prompt probe rejected the candidate, ``no_replicas``
    when there is nothing healthy to canary on), the refused
    ``version``, and for fence rejections the epoch that outran it
    (``fence_version``). A rejected publish leaves the fleet serving
    exactly what it served before — rejection is not an error state to
    recover from, it is the safety contract working."""

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
    """A shipped weight set failed integrity verification at the
    receiving replica (per-tensor CRC or set digest mismatch, or a
    tensor count/shape that disagrees with the manifest). The staged
    buffer is discarded and the replica keeps serving its current
    version — a torn or corrupted transfer can never be committed."""

    def __init__(self, version: int, replica: str, detail: str):
        self.version = version
        self.replica = replica
        self.detail = detail
        super().__init__(
            f"weight set version {version} failed verification on "
            f"replica {replica}: {detail} — staged buffer discarded, "
            f"replica keeps its current version")


class CommTimeoutError(TransportError):
    """A collective stalled past the watchdog timeout. Raised on every
    member of the group (the watchdog aborts local mailbox waiters and
    marks the group unhealthy in the store) instead of hanging one
    rank while the rest spin."""

    def __init__(self, op: str, group_id: int, seq: Optional[int],
                 rank: Optional[int], timeout_s: float):
        self.op = op
        self.group_id = group_id
        self.seq = seq
        self.rank = rank
        self.timeout_s = timeout_s
        super().__init__(
            f"collective '{op}' on group {group_id} (seq={seq}) stalled "
            f"past the {timeout_s}s watchdog timeout on rank {rank}; "
            f"group marked unhealthy — compare watchdog dumps across "
            f"ranks to locate the desynced/dead member")
