"""Fixed-size quantile digest (port of `QuantileDigest` from
`photon_tpu/telemetry/health.py`; the watchdog rules and the health report
wait for a later slice)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


class QuantileDigest:
    """Fixed-size log-spaced histogram: O(1) memory, bounded relative
    quantile error, exact merge.

    Values clamp into ``[lo, hi)`` (defaults cover 1 µs – 1000 s in ns);
    bucket ``i`` spans ``[lo·g^i, lo·g^(i+1))`` with
    ``g = (1+rel_error)^2``, and quantiles report the geometric bucket
    midpoint — so any quantile is within ``rel_error`` of the true value
    (up to clamping). Not thread-safe: the owner serializes access."""

    __slots__ = ("lo", "hi", "rel_error", "growth", "_inv_log_g",
                 "counts", "n", "total")

    def __init__(self, rel_error: float = 0.005, lo: float = 1e3,
                 hi: float = 1e12):
        if not (0 < rel_error < 1):
            raise ValueError(f"rel_error must be in (0,1), got {rel_error}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.rel_error = float(rel_error)
        self.growth = (1.0 + rel_error) ** 2
        self._inv_log_g = 1.0 / math.log(self.growth)
        n_buckets = int(math.ceil(
            math.log(self.hi / self.lo) * self._inv_log_g))
        self.counts = np.zeros(n_buckets, np.int64)
        self.n = 0
        self.total = 0.0

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.log(v / self.lo) * self._inv_log_g)
        return min(i, self.counts.size - 1)

    def add(self, value: float) -> None:
        self.counts[self._index(float(value))] += 1
        self.n += 1
        self.total += float(value)

    def add_many(self, values) -> None:
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return
        idx = np.floor(
            np.log(np.maximum(v, self.lo) / self.lo) * self._inv_log_g
        ).astype(np.int64)
        np.clip(idx, 0, self.counts.size - 1, out=idx)
        np.add.at(self.counts, idx, 1)
        self.n += int(v.size)
        self.total += float(v.sum())

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        if (other.lo, other.hi, other.rel_error) != \
                (self.lo, self.hi, self.rel_error):
            raise ValueError("cannot merge digests with different bucketing")
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        return self

    def quantile(self, q: float) -> Optional[float]:
        """The geometric midpoint of the bucket holding rank ``q·n``
        (None when empty)."""
        if self.n == 0:
            return None
        rank = min(max(q, 0.0), 1.0) * (self.n - 1)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="right"))
        i = min(i, self.counts.size - 1)
        return self.lo * self.growth ** (i + 0.5)

    def mean(self) -> Optional[float]:
        return (self.total / self.n) if self.n else None

    def stats_ms(self) -> dict:
        """The dispatcher's latency_stats shape, ns → ms."""
        if self.n == 0:
            return {"n": 0, "p50_ms": None, "p95_ms": None, "p99_ms": None,
                    "mean_ms": None}
        return {"n": int(self.n),
                "p50_ms": self.quantile(0.50) / 1e6,
                "p95_ms": self.quantile(0.95) / 1e6,
                "p99_ms": self.quantile(0.99) / 1e6,
                "mean_ms": self.mean() / 1e6}
