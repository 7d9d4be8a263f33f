"""The health plane (port of `photon_tpu/telemetry/health.py`):
fixed-size quantile digests, counter-rate windows, declarative watchdog
rules and the serving-staleness gauge — one typed :class:`HealthReport`
snapshot of a live (or read-back) telemetry `Run`.

- :class:`QuantileDigest` — a fixed-size log-spaced histogram (latencies
  in ns) with a bounded relative quantile error; digests merge exactly,
  which is how `ReplicaFleet.latency_stats` pools replicas.
- :class:`HealthMonitor` — diffs the run's counters between snapshots;
  each snapshot reports per-second rates over its own window.
- :class:`WatchRule` — declarative thresholds over window deltas (shed
  rate, deadline expiry, worker deaths, failover rate:
  :data:`DEFAULT_RULES`), each OK/DEGRADED/CRITICAL; the report's verdict
  is the worst rule's.
- the ``continual.staleness_s`` gauge, surfaced as the report's
  ``staleness_s``.

Exports: `HealthReport.to_json()` and `HealthReport.prometheus()`
(node-exporter textfile lines under the reference's ``photon_tpu_``
metric prefix, so dashboards read either package), written by ``python
-m photon_tpu_torch.telemetry --health PATH --prom OUT``.
"""
from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Optional

import numpy as np

OK = "OK"
DEGRADED = "DEGRADED"
CRITICAL = "CRITICAL"
_VERDICT_RANK = {OK: 0, DEGRADED: 1, CRITICAL: 2}


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
        # photon: unguarded(owner-serialized: shared digests are only touched under the owner's _lat_lock)
        self.n += 1
        # photon: unguarded(owner-serialized: shared digests are only touched under the owner's _lat_lock)
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
        # photon: unguarded(owner-serialized: shared digests are only touched under the owner's _lat_lock)
        self.n += int(v.size)
        # photon: unguarded(owner-serialized: shared digests are only touched under the owner's _lat_lock)
        self.total += float(v.sum())

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        if (other.lo, other.hi, other.rel_error) != \
                (self.lo, self.hi, self.rel_error):
            raise ValueError("cannot merge digests with different bucketing")
        self.counts += other.counts
        # photon: unguarded(owner-serialized: fleet merge holds each replica's _lat_lock; the target digest is merge-local)
        self.n += other.n
        # photon: unguarded(owner-serialized: fleet merge holds each replica's _lat_lock; the target digest is merge-local)
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


# ------------------------------------------------------------ watchdog rules
@dataclasses.dataclass(frozen=True)
class WatchRule:
    """One declarative threshold over a snapshot window.

    kind="ratio": value = Δnumerator / max(Δdenominator, 1) — a
        fraction of traffic (shed rate, failover rate).
    kind="delta": value = Δnumerator — an absolute count in the window
        (worker deaths).
    ``warn``/``crit`` are inclusive lower bounds: value ≥ crit →
    CRITICAL, ≥ warn → DEGRADED, else OK. A rule whose numerator never
    moved and whose denominator is absent reads 0 (OK) — quiet planes
    stay green."""

    name: str
    numerator: str
    warn: float
    crit: float
    kind: str = "ratio"
    denominator: Optional[str] = None
    description: str = ""

    def evaluate(self, delta: dict) -> dict:
        num = float(delta.get(self.numerator, 0.0))
        if self.kind == "ratio":
            den = float(delta.get(self.denominator, 0.0)) \
                if self.denominator else 0.0
            value = num / max(den, 1.0)
        elif self.kind == "delta":
            value = num
        else:
            raise ValueError(f"unknown WatchRule kind {self.kind!r}")
        verdict = CRITICAL if value >= self.crit else \
            DEGRADED if value >= self.warn else OK
        return {"rule": self.name, "value": round(value, 6),
                "warn": self.warn, "crit": self.crit, "verdict": verdict}


DEFAULT_RULES: tuple = (
    WatchRule("shed_rate", "serving.shed", 0.05, 0.25,
              kind="ratio", denominator="serving.admitted",
              description="watermark/bounded-submit sheds per admitted "
                          "request"),
    WatchRule("deadline_expiry", "serving.deadline_expired", 0.05, 0.25,
              kind="ratio", denominator="serving.admitted",
              description="admitted requests dropped before a batch slot"),
    WatchRule("worker_death", "ingest.worker_deaths", 1.0, 4.0,
              kind="delta",
              description="decode-pool worker deaths in the window"),
    WatchRule("failover", "serving.fleet_failovers", 0.10, 0.50,
              kind="ratio", denominator="serving.fleet_dispatches",
              description="fleet attempts beyond the primary replica per "
                          "successful dispatch"),
)


# ----------------------------------------------------------------- report
_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "photon_tpu_" + _PROM_SANITIZE.sub("_", name)


@dataclasses.dataclass
class HealthReport:
    """One typed snapshot: verdict + the evidence behind it."""

    name: str
    verdict: str
    window_s: float
    rates: dict          # counter -> per-second rate over the window
    rules: list          # WatchRule.evaluate outputs
    latency: dict        # digest stats_ms shape (or gauge fallback)
    staleness_s: Optional[float]
    counters: dict       # absolute totals at snapshot time
    gauges: dict
    taken_unix: float

    def to_json(self) -> dict:
        return {"name": self.name, "verdict": self.verdict,
                "window_s": round(self.window_s, 3),
                "rates_per_s": {k: round(v, 6)
                                for k, v in sorted(self.rates.items())},
                "rules": self.rules,
                "latency": self.latency,
                "staleness_s": self.staleness_s,
                "taken_unix": self.taken_unix}

    def prometheus(self) -> str:
        """Node-exporter textfile lines: counters as ``_total``, gauges
        and derived values as plain gauges, the verdict as a 0/1/2
        severity gauge plus one labeled line per rule."""
        lines = [
            "# photon_tpu health snapshot "
            f"(run={self.name!r}, window={self.window_s:.3f}s)",
            f"photon_tpu_health_verdict {_VERDICT_RANK[self.verdict]}",
        ]
        for r in self.rules:
            lines.append(
                f'photon_tpu_watch_value{{rule="{r["rule"]}"}} '
                f'{r["value"]}')
            lines.append(
                f'photon_tpu_watch_verdict{{rule="{r["rule"]}"}} '
                f'{_VERDICT_RANK[r["verdict"]]}')
        if self.staleness_s is not None:
            lines.append(
                f"photon_tpu_serving_staleness_seconds {self.staleness_s}")
        for k, v in sorted(self.latency.items()):
            if isinstance(v, (int, float)) and v is not None:
                lines.append(f"{_prom_name('latency_' + k)} {v}")
        for k, v in sorted(self.counters.items()):
            lines.append(f"{_prom_name(k)}_total {v}")
        for k, v in sorted(self.gauges.items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"{_prom_name(k)} {v}")
        return "\n".join(lines) + "\n"


def _worst(verdicts) -> str:
    worst = OK
    for v in verdicts:
        if _VERDICT_RANK[v] > _VERDICT_RANK[worst]:
            worst = v
    return worst


def _build_report(name: str, counters: dict, gauges: dict,
                  prev_counters: dict, window_s: float,
                  rules: tuple, latency: Optional[QuantileDigest],
                  taken_unix: float) -> HealthReport:
    delta = {k: v - prev_counters.get(k, 0.0) for k, v in counters.items()}
    window = max(window_s, 1e-9)
    rates = {k: d / window for k, d in delta.items() if d}
    evaluated = [r.evaluate(delta) for r in rules]
    if latency is not None:
        lat = latency.stats_ms()
    else:  # fall back to the dispatcher's close()-time gauges
        lat = {k.replace("serving.latency_", ""): v
               for k, v in gauges.items()
               if k.startswith("serving.latency_")}
    staleness = gauges.get("continual.staleness_s")
    return HealthReport(
        name=name, verdict=_worst(e["verdict"] for e in evaluated),
        window_s=window_s, rates=rates, rules=evaluated, latency=lat,
        staleness_s=float(staleness) if staleness is not None else None,
        counters=dict(counters), gauges=dict(gauges),
        taken_unix=taken_unix)


class HealthMonitor:
    """Windowed snapshots of the live Run: each `snapshot` diffs counters
    against the previous one, so rates and rule deltas cover exactly the
    inter-snapshot window (the first window reaches back to run start)."""

    def __init__(self, rules: tuple = DEFAULT_RULES):
        self.rules = tuple(rules)
        self._prev_counters: dict = {}
        self._prev_t: Optional[float] = None

    def snapshot(self, run=None,
                 latency: Optional[QuantileDigest] = None) -> HealthReport:
        from photon_tpu_torch import telemetry

        run = run if run is not None else telemetry.current_run()
        now = time.monotonic()
        if run is None:
            counters, gauges, name = {}, {}, "(no run)"
            window = 0.0 if self._prev_t is None else now - self._prev_t
        else:
            with run._lock:
                counters = dict(run.counters)
                gauges = dict(run.gauges)
            name = run.name
            window = (now - self._prev_t) if self._prev_t is not None \
                else run.duration_s()
        report = _build_report(name, counters, gauges,
                               self._prev_counters, window, self.rules,
                               latency, time.time())
        self._prev_counters = counters
        self._prev_t = now
        return report


def snapshot(run=None, latency: Optional[QuantileDigest] = None,
             rules: tuple = DEFAULT_RULES) -> HealthReport:
    """One-shot whole-run snapshot (window = run duration so far)."""
    return HealthMonitor(rules).snapshot(run, latency=latency)


def report_from_jsonl(path: str,
                      rules: tuple = DEFAULT_RULES) -> HealthReport:
    """The offline face of `snapshot`: rebuild a HealthReport from a
    run's JSONL event file (counters/gauges ride the ``run_end``
    snapshot; a torn file — no run_end — reads as an empty, OK report
    with whatever spans survived ignored). Window = run duration."""
    from photon_tpu_torch.telemetry.sinks import load_report

    rep = load_report(path)
    duration = rep.get("duration_s") or 0.0
    return _build_report(rep.get("name") or "(torn run)",
                         rep.get("counters", {}), rep.get("gauges", {}),
                         {}, float(duration), tuple(rules), None,
                         time.time())
