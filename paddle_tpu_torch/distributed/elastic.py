"""Elastic training manager.

Reference analog: ElasticManager (fleet/elastic/manager.py:124-277) — etcd
leases + heartbeat thread, scale in/out watch, rank remap, relaunch with
dedicated exit codes (manager.py:32-33).

Here membership lives in the launcher TCPStore (heartbeat keys with
timestamps). The manager watches membership; on change within [min, max]
nodes it signals ELASTIC_RESTART so the launch controller re-forms the pod
(rank remap happens at the next rendezvous). The store serves the role
the reference's etcd leases play.

Failure detection is the first half of the recovery loop (resilience/):
a dead heartbeat drops the rank from ``alive_members()``, the membership
change sets ``need_restart`` / fires ``on_membership_change``, the launch
controller re-forms the pod, and the re-formed workers call
``resilience.resume_from_latest`` to continue from the last complete
checkpoint. The heartbeat thread itself is hardened: a store error (the
store hiccuping, or dying with the master node) is counted in
``elastic/heartbeat_errors`` and the thread KEEPS BEATING — a transient
store failure must not silently turn this node into a corpse that the
rest of the pod then evicts.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..profiler import metrics as _metrics


def default_host_id() -> str:
    """The failure-domain label for this process: PT_HOST_ID when the
    launcher set one (chaos tests and multi-host pods do), else the
    hostname — ranks sharing it share a fate under host loss."""
    return os.environ.get("PT_HOST_ID", "") or socket.gethostname()

__all__ = ["ElasticManager", "default_host_id", "ELASTIC_EXIT_CODE",
           "ELASTIC_AUTO_PARALLEL_EXIT_CODE"]

# reference manager.py:32-33 exit codes
ELASTIC_EXIT_CODE = 101
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102

_m_hb_errors = _metrics.counter("elastic/heartbeat_errors")
_m_last_beat = _metrics.gauge("elastic/last_beat_ts")
_m_changes = _metrics.counter("elastic/membership_changes")


class ElasticManager:
    def __init__(self, store, job_id: str, rank: int, min_nodes: int,
                 max_nodes: int, heartbeat_interval: float = 3.0,
                 ttl: float = 15.0,
                 on_membership_change: Optional[Callable] = None,
                 host_id: Optional[str] = None):
        self.store = store
        self.job_id = job_id
        self.rank = rank
        self.host_id = host_id if host_id is not None else \
            default_host_id()
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.interval = heartbeat_interval
        self.ttl = ttl
        self.on_change = on_membership_change
        self._stop = threading.Event()
        self._thread = None
        self._last_members: Optional[List[int]] = None
        self.need_restart = False
        self.last_beat_ts: Optional[float] = None
        self.heartbeat_errors = 0
        self.last_error: Optional[str] = None

    # -- membership --------------------------------------------------------
    def register(self):
        self.store.set(f"{self.job_id}/hb/{self.rank}", str(time.time()))
        self.store.set(f"{self.job_id}/host/{self.rank}", self.host_id)
        self.store.add(f"{self.job_id}/registered", 1)

    def host_map(self) -> Dict[int, str]:
        """{rank: host_id} for every registered rank — what quorum
        sizing and host-aware ring placement key on."""
        out: Dict[int, str] = {}
        for r in range(self.max_nodes):
            try:
                h = self.store.get_nowait(f"{self.job_id}/host/{r}")
            except Exception:
                h = None     # unregistered rank: no failure domain yet
            if h is not None:
                out[r] = h.decode()
        return out

    def alive_hosts(self) -> List[str]:
        """Distinct host_ids with at least one fresh heartbeat."""
        hosts = self.host_map()
        return sorted({hosts[r] for r in self.alive_members()
                       if r in hosts})

    def alive_members(self) -> List[int]:
        now = time.time()
        members = []
        for r in range(self.max_nodes):
            try:
                ts = float(self.store.get_nowait(f"{self.job_id}/hb/{r}"))
            except Exception:
                ts = None
            if ts is not None and now - ts < self.ttl:
                members.append(r)
        return members

    def dead_members(self) -> List[int]:
        """Ranks whose heartbeat is stale (relative to the last known
        membership) — what the launch controller treats as failed."""
        alive = set(self.alive_members())
        known = self._last_members or list(range(self.min_nodes))
        return [r for r in known if r not in alive]

    def wait_for_members(self, n: int,
                         timeout: float = 60.0) -> List[int]:
        """Block until at least `n` members have a fresh heartbeat (the
        supervisor's re-form gate: survivors wait here for the killed
        rank to be relaunched and rejoin). Returns the alive members;
        raises TimeoutError naming who is missing when the group cannot
        re-form within `timeout`."""
        deadline = time.time() + timeout
        members = self.alive_members()
        while len(members) < n:
            if time.time() > deadline:
                missing = [r for r in range(self.max_nodes)
                           if r not in members][:n - len(members)]
                raise TimeoutError(
                    f"elastic group did not re-form: {len(members)}/{n} "
                    f"members alive after {timeout}s (waiting on ranks "
                    f"{missing})")
            time.sleep(min(self.interval, 0.2))
            members = self.alive_members()
        return members

    def clear_restart(self):
        """Acknowledge a membership change after a successful re-form."""
        self.need_restart = False

    # -- heartbeat loop ----------------------------------------------------
    def _beat_once(self):
        """One heartbeat + membership check. Split out from the loop so
        tests can drive it synchronously."""
        self.store.set(f"{self.job_id}/hb/{self.rank}",
                       str(time.time()))
        self.last_beat_ts = time.time()
        _m_last_beat.set(self.last_beat_ts)
        members = self.alive_members()
        if self._last_members is not None and \
                members != self._last_members:
            _m_changes.inc()
            if len(members) >= self.min_nodes:
                self.need_restart = True
                if self.on_change:
                    self.on_change(members)
        self._last_members = members

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._beat_once()
            except Exception as e:
                # a store error must NOT kill the heartbeat thread: a
                # silent death here reads as a dead node to every peer
                # and evicts a healthy worker. Count it and keep beating.
                self.heartbeat_errors += 1
                self.last_error = repr(e)
                _m_hb_errors.inc()
            self._stop.wait(self.interval)

    def start(self):
        self.register()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def exit_for_rescale(self):
        """Worker-side: exit with the elastic code so the launcher reforms
        the pod (reference exit-code contract)."""
        os._exit(ELASTIC_EXIT_CODE)
