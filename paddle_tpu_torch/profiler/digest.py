"""Fixed-size mergeable streaming quantile sketch (merging t-digest).

The metrics registry's `Histogram` answers "how many observations fell
in each latency band" but its bucket-estimated p50/p95 are only as good
as the bucket edges — the fleet bench's `tpot_ms_min/max` stopgap exists
because the edges were too coarse to quote an honest p99. This sketch
gives honest tail quantiles from O(compression) memory regardless of
stream length, and — critically for the fleet aggregation plane — two
sketches merge into one that is as accurate as a sketch built from the
concatenated stream, so per-replica digests roll up into fleet-wide
percentiles without shipping raw samples.

Algorithm: the "merging" t-digest variant. Incoming values buffer in a
flat list; on overflow (or any read) the buffer and existing centroids
are sorted by mean and re-clustered under the k1 scale function
``k(q) = (compression / 2π) · asin(2q − 1)``, which keeps clusters tiny
at the tails (exact min/max, tight p99) and coarse in the middle. Memory
is bounded: after compression the centroid count is < 2·compression and
the buffer never exceeds a fixed cap, independent of how many values
were observed.

Serialization (`to_dict` / `from_dict`) is plain JSON so digests travel
inside metrics snapshots over the CRC/ACK transport.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Tuple

__all__ = ["QuantileDigest"]


class QuantileDigest:
    """Mergeable streaming quantile sketch with bounded memory."""

    __slots__ = ("compression", "_means", "_weights", "_buf_v", "_buf_w",
                 "_buf_cap", "_count", "_min", "_max")

    def __init__(self, compression: int = 128):
        if compression < 8:
            raise ValueError("compression must be >= 8")
        self.compression = int(compression)
        self._means: List[float] = []      # sorted centroid means
        self._weights: List[float] = []    # parallel centroid weights
        self._buf_v: List[float] = []      # unmerged values
        self._buf_w: List[float] = []      # parallel weights
        self._buf_cap = max(512, 4 * self.compression)
        self._count = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    # -- ingestion --------------------------------------------------------
    def observe(self, v) -> None:
        v = float(v)
        self._buf_v.append(v)
        self._buf_w.append(1.0)
        self._count += 1.0
        if self._min is None or v < self._min:
            self._min = v
        if self._max is None or v > self._max:
            self._max = v
        if len(self._buf_v) >= self._buf_cap:
            self._compress()

    def update_many(self, values: Iterable[float]) -> None:
        """Bulk ingest; chunks through the buffer so a 1e6-value stream
        never holds more than buffer + centroids in memory at once."""
        for v in values:
            self.observe(v)

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        """Fold `other` into this digest in place (returns self)."""
        if other._count == 0:
            return self
        self._buf_v.extend(other._means)
        self._buf_w.extend(other._weights)
        self._buf_v.extend(other._buf_v)
        self._buf_w.extend(other._buf_w)
        self._count += other._count
        if other._min is not None and (self._min is None
                                       or other._min < self._min):
            self._min = other._min
        if other._max is not None and (self._max is None
                                       or other._max > self._max):
            self._max = other._max
        self._compress()
        return self

    # -- compression ------------------------------------------------------
    def _k(self, q: float) -> float:
        q = min(1.0, max(0.0, q))
        return self.compression / (2.0 * math.pi) * math.asin(2.0 * q - 1.0)

    def _compress(self) -> None:
        if not self._buf_v and len(self._means) < 2 * self.compression:
            return
        pts: List[Tuple[float, float]] = list(zip(self._means, self._weights))
        pts.extend(zip(self._buf_v, self._buf_w))
        self._buf_v = []
        self._buf_w = []
        if not pts:
            return
        pts.sort(key=lambda p: p[0])
        total = sum(w for _, w in pts)
        means: List[float] = []
        weights: List[float] = []
        cum = 0.0                       # weight strictly before current cluster
        cur_m, cur_w = pts[0]
        k_lo = self._k(0.0)
        for m, w in pts[1:]:
            q_hi = (cum + cur_w + w) / total
            if self._k(q_hi) - k_lo <= 1.0:
                # weighted-mean merge into the open cluster
                cur_m += (m - cur_m) * (w / (cur_w + w))
                cur_w += w
            else:
                means.append(cur_m)
                weights.append(cur_w)
                cum += cur_w
                cur_m, cur_w = m, w
                k_lo = self._k(cum / total)
        means.append(cur_m)
        weights.append(cur_w)
        self._means = means
        self._weights = weights

    # -- queries ----------------------------------------------------------
    @property
    def count(self) -> int:
        return int(self._count)

    @property
    def min(self) -> Optional[float]:
        return self._min

    @property
    def max(self) -> Optional[float]:
        return self._max

    def size(self) -> int:
        """Retained points (centroids + buffered) — the memory bound."""
        return len(self._means) + len(self._buf_v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]); None when empty."""
        if self._count == 0:
            return None
        self._compress()
        means, weights = self._means, self._weights
        if len(means) == 1:
            return means[0]
        q = min(1.0, max(0.0, q))
        total = sum(weights)
        target = q * total
        # centroid i "lives" at cumulative position cum_i + w_i / 2
        cum = 0.0
        prev_pos = 0.0
        prev_mean = self._min
        for m, w in zip(means, weights):
            pos = cum + w / 2.0
            if target < pos:
                span = pos - prev_pos
                frac = (target - prev_pos) / span if span > 0 else 0.0
                return prev_mean + (m - prev_mean) * frac
            prev_pos, prev_mean = pos, m
            cum += w
        # above the last centroid's midpoint: interpolate toward max
        span = total - prev_pos
        frac = (target - prev_pos) / span if span > 0 else 1.0
        return prev_mean + (self._max - prev_mean) * min(1.0, frac)

    def quantiles(self, qs: Iterable[float]) -> List[Optional[float]]:
        return [self.quantile(q) for q in qs]

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        self._compress()
        return {
            "compression": self.compression,
            "count": self._count,
            "min": self._min,
            "max": self._max,
            "centroids": [[round(m, 9), w] for m, w in
                          zip(self._means, self._weights)],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileDigest":
        dg = cls(int(d.get("compression", 128)))
        cents = d.get("centroids", [])
        dg._means = [float(m) for m, _ in cents]
        dg._weights = [float(w) for _, w in cents]
        dg._count = float(d.get("count", sum(dg._weights)))
        dg._min = d.get("min")
        dg._max = d.get("max")
        return dg

    def copy(self) -> "QuantileDigest":
        return QuantileDigest.from_dict(self.to_dict())

    def _reset(self) -> None:
        self._means = []
        self._weights = []
        self._buf_v = []
        self._buf_w = []
        self._count = 0.0
        self._min = None
        self._max = None

    def __repr__(self):
        return (f"QuantileDigest(compression={self.compression}, "
                f"count={self.count}, size={self.size()})")
