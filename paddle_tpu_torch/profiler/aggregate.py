"""Fleet metrics aggregation plane: ship per-process registry snapshots
to an aggregator and merge them into fleet-wide percentiles.

The router's health scrape "shrunk to process-local method calls"
(router.py) — good enough for one process, useless as a placement
signal for a FleetGateway that must see every replica on every host.
This module closes the loop:

  * `MetricsCollector` — runs next to each replica/trainer; serializes
    the (child-)registry snapshot as JSON-bytes and sends it over any
    transport with the CRC/ACK `TensorTransport` surface
    (``send(arr, dst, channel)`` / ``recv(src, channel)``), identity-
    stamped with (host_id, replica).
  * `FleetAggregator` — ingests snapshots (in-process or off the
    transport), keys them by (host_id, replica), merges histogram
    digests across replicas (t-digest merge, so fleet p95 is honest,
    not an average of averages), and exposes the fleet-snapshot API.
  * `estimate_clock_offset` / `serve_clock` — NTP-style transport-ping
    offset estimation so `tools/trace_report.py` can shift per-host
    chrome traces onto one timeline before merging.
  * `straggler_report` — per-rank `train/step_ms` digest comparison
    flagging ranks whose p95 lags the fleet median.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import metrics as _metrics
from .digest import QuantileDigest

__all__ = [
    "MetricsCollector", "FleetAggregator", "estimate_clock_offset",
    "serve_clock", "METRICS_CHANNEL", "CLOCK_CHANNEL",
]

METRICS_CHANNEL = "metrics"
CLOCK_CHANNEL = "clock"

_m_published = _metrics.counter("fleet/snapshots_published")
_m_ingested = _metrics.counter("fleet/snapshots_ingested")
_m_replicas = _metrics.gauge("fleet/replicas")
_m_stale = _metrics.counter("fleet/stale_evictions")


def _encode(doc: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(doc).encode("utf-8"), dtype=np.uint8)


def _decode(arr) -> dict:
    return json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode("utf-8"))


class MetricsCollector:
    """Per-process publisher of identity-stamped registry snapshots."""

    def __init__(self, transport, dst: int, host_id: Optional[str] = None,
                 replica: Optional[str] = None, channel: str = METRICS_CHANNEL,
                 registry=None):
        self.transport = transport
        self.dst = dst
        self.host_id = host_id
        self.replica = replica
        self.channel = channel
        self.registry = registry if registry is not None \
            else _metrics.registry()

    def snapshot(self) -> dict:
        snap = self.registry.snapshot()
        snap["host_id"] = self.host_id
        snap["replica"] = self.replica \
            or snap.get("namespace") or f"pid{snap.get('pid')}"
        return snap

    def publish(self) -> dict:
        """Snapshot + send over the transport; returns the snapshot."""
        snap = self.snapshot()
        self.transport.send(_encode(snap), self.dst, channel=self.channel)
        _m_published.inc()
        return snap


def _merge_hist_snaps(snaps: List[dict]) -> dict:
    out = {"count": 0, "sum": 0.0, "min": None, "max": None}
    dg: Optional[QuantileDigest] = None
    for h in snaps:
        out["count"] += h.get("count", 0)
        out["sum"] += h.get("sum", 0.0) or 0.0
        for key, better in (("min", min), ("max", max)):
            v = h.get(key)
            if v is not None:
                out[key] = v if out[key] is None else better(out[key], v)
        d = h.get("digest")
        if d:
            part = QuantileDigest.from_dict(d)
            dg = part if dg is None else dg.merge(part)
    out["avg"] = out["sum"] / out["count"] if out["count"] else None
    if dg is not None:
        out["p50"] = dg.quantile(0.5)
        out["p95"] = dg.quantile(0.95)
        out["p99"] = dg.quantile(0.99)
        out["digest"] = dg.to_dict()
    return out


class FleetAggregator:
    """Keyed store of per-replica snapshots + digest-merging rollup.

    Snapshots are last-write-wins per (host_id, replica) and carry the
    ingest timestamp, so a retired or renamed replica that stops
    publishing can be EVICTED (`evict_stale`) instead of polluting
    fleet percentiles forever with its final digest.  Pass
    ``stale_after_s`` to evict automatically on every fleet read."""

    def __init__(self, clock=time.time,
                 stale_after_s: Optional[float] = None):
        self._snaps: Dict[Tuple[str, str], dict] = {}
        self._clock = clock
        self.stale_after_s = stale_after_s

    # -- ingestion --------------------------------------------------------
    def ingest(self, snap: dict) -> Tuple[str, str]:
        key = (str(snap.get("host_id")),
               str(snap.get("replica") or snap.get("namespace")
                   or f"pid{snap.get('pid')}"))
        snap = dict(snap)
        snap["ingest_ts"] = self._clock()
        self._snaps[key] = snap
        _m_ingested.inc()
        _m_replicas.set(len(self._snaps))
        return key

    def evict_stale(self, max_age_s: Optional[float] = None,
                    now: Optional[float] = None) -> List[Tuple[str, str]]:
        """Drop every snapshot not re-ingested within ``max_age_s``
        (default: the constructor's ``stale_after_s``); returns the
        evicted keys and counts ``fleet/stale_evictions``."""
        max_age = max_age_s if max_age_s is not None else self.stale_after_s
        if max_age is None:
            return []
        if now is None:
            now = self._clock()
        stale = sorted(k for k, s in self._snaps.items()
                       if now - s.get("ingest_ts", now) > max_age)
        for k in stale:
            del self._snaps[k]
        if stale:
            _m_stale.inc(len(stale))
            _m_replicas.set(len(self._snaps))
        return stale

    def poll(self, transport, src: int,
             channel: str = METRICS_CHANNEL) -> Tuple[str, str]:
        """Receive one published snapshot from `src` and ingest it."""
        return self.ingest(_decode(transport.recv(src, channel=channel)))

    def keys(self) -> List[Tuple[str, str]]:
        return sorted(self._snaps)

    # -- fleet snapshot API (the future FleetGateway input) ---------------
    def replica_snapshot(self, host_id, replica) -> Optional[dict]:
        return self._snaps.get((str(host_id), str(replica)))

    def percentile(self, metric: str, q: float, host_id=None,
                   replica=None) -> Optional[float]:
        """Digest percentile for one replica, or fleet-merged when no
        identity is given."""
        if self.stale_after_s is not None:
            self.evict_stale()
        if host_id is not None or replica is not None:
            snap = self.replica_snapshot(host_id, replica)
            if snap is None:
                return None
            h = snap.get("histograms", {}).get(metric)
            if not h or not h.get("digest"):
                return None
            return QuantileDigest.from_dict(h["digest"]).quantile(q)
        merged = self._merged_histogram(metric)
        if not merged or not merged.get("digest"):
            return None
        return QuantileDigest.from_dict(merged["digest"]).quantile(q)

    def _merged_histogram(self, metric: str) -> Optional[dict]:
        parts = [s["histograms"][metric] for s in self._snaps.values()
                 if metric in s.get("histograms", {})]
        return _merge_hist_snaps(parts) if parts else None

    def fleet_snapshot(self) -> dict:
        """Everything a gateway needs in one dict: per-replica series
        plus the digest-merged fleet rollup."""
        if self.stale_after_s is not None:
            self.evict_stale()
        replicas = {}
        counters: Dict[str, float] = {}
        gauges: Dict[str, List[float]] = {}
        hist_names = set()
        for (host, rep), snap in sorted(self._snaps.items()):
            replicas[f"{host}/{rep}"] = {
                "host_id": host, "replica": rep,
                "ts": snap.get("ts"), "pid": snap.get("pid"),
                "counters": snap.get("counters", {}),
                "gauges": snap.get("gauges", {}),
                "histograms": snap.get("histograms", {}),
            }
            for name, v in snap.get("counters", {}).items():
                counters[name] = counters.get(name, 0) + v
            for name, v in snap.get("gauges", {}).items():
                gauges.setdefault(name, []).append(v)
            hist_names.update(snap.get("histograms", {}))
        fleet_hists = {name: self._merged_histogram(name)
                       for name in sorted(hist_names)}
        return {
            "ts": time.time(),
            "n_replicas": len(self._snaps),
            "replicas": replicas,
            "fleet": {
                "counters": counters,
                "gauges": {n: (sum(vs) / len(vs) if vs else None)
                           for n, vs in gauges.items()},
                "histograms": fleet_hists,
            },
        }

    # -- straggler detection ----------------------------------------------
    def straggler_report(self, metric: str = "train/step_ms",
                         factor: float = 1.5) -> dict:
        """Per-rank digest comparison: flag replicas whose `metric` p95
        exceeds `factor` x the fleet median p95."""
        per_rank = {}
        p95s = []
        for (host, rep), snap in sorted(self._snaps.items()):
            h = snap.get("histograms", {}).get(metric)
            if not h or not h.get("digest"):
                continue
            dg = QuantileDigest.from_dict(h["digest"])
            row = {"count": dg.count, "p50": dg.quantile(0.5),
                   "p95": dg.quantile(0.95), "max": dg.max}
            per_rank[f"{host}/{rep}"] = row
            p95s.append((row["p95"], f"{host}/{rep}"))
        if not p95s:
            return {"metric": metric, "per_rank": {}, "stragglers": [],
                    "median_p95": None}
        vals = sorted(v for v, _ in p95s)
        median = vals[len(vals) // 2]
        stragglers = [k for v, k in p95s
                      if median and v > factor * median]
        return {"metric": metric, "per_rank": per_rank,
                "stragglers": sorted(stragglers), "median_p95": median,
                "factor": factor}


# -- clock-offset estimation ---------------------------------------------

def _recv_wait(transport, src: int, channel: str, timeout_s: float = 5.0):
    """recv that tolerates empty loopback queues (LoopbackTransport
    raises instead of blocking); real transports block internally."""
    from ..distributed.resilience.errors import TransportClosedError

    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            return transport.recv(src, channel=channel)
        except TransportClosedError:
            if time.perf_counter() > deadline:
                raise
            time.sleep(0.001)


def serve_clock(transport, peer: int, n: int = 4,
                channel: str = CLOCK_CHANNEL, skew_s: float = 0.0) -> None:
    """Answer `n` clock pings from `peer`: echo the originator's t0 with
    this process's receive/send timestamps. `skew_s` offsets the local
    clock reading (tests use it to simulate an unsynchronized host).
    Ping and reply ride separate sub-channels so a loopback transport
    (one queue per channel) can't hand a sender back its own frame."""
    for _ in range(n):
        frame = np.asarray(
            _recv_wait(transport, peer, channel + "/req"), dtype=np.float64)
        t_rx = time.perf_counter() + skew_s
        t_tx = time.perf_counter() + skew_s
        reply = np.array([frame[0], t_rx, t_tx], dtype=np.float64)
        transport.send(reply, peer, channel=channel + "/rsp")


def estimate_clock_offset(transport, peer: int, n: int = 4,
                          channel: str = CLOCK_CHANNEL) -> float:
    """NTP-style offset of `peer`'s clock relative to ours, in seconds
    (add the result to *our* timestamps to land on the peer's
    timeline). Uses the minimum-RTT sample — the one least polluted by
    queueing delay."""
    best = None
    for _ in range(max(1, n)):
        t0 = time.perf_counter()
        transport.send(np.array([t0], dtype=np.float64), peer,
                       channel=channel + "/req")
        frame = np.asarray(
            _recv_wait(transport, peer, channel + "/rsp"), dtype=np.float64)
        t3 = time.perf_counter()
        t_rx, t_tx = float(frame[1]), float(frame[2])
        rtt = (t3 - t0) - (t_tx - t_rx)
        offset = ((t_rx - t0) + (t_tx - t3)) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    offset = best[1]
    _metrics.gauge("fleet/clock_offset_ms").set(offset * 1e3)
    return offset
