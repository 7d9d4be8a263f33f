"""Deterministic fault injection + host-IO retry/backoff (the port's copy
of `photon_tpu/checkpoint/faults.py`, whole, on the port's `telemetry`).

Reference parity: the reference inherits its failure story from Spark —
executor loss replays lineage, HDFS clients retry transient IO — and its
tests trust that machinery. The host loops here (the ingest plane's
decode workers, the chunk cache's commits, Avro container opens) have no
lineage to replay, so this module supplies the two halves explicitly:

- **kill points** — named sites on the hot paths (the canonical site
  list is :data:`FAULT_SITES` below) where an armed :class:`FaultPlan`
  raises :class:`InjectedFault` at a chosen occurrence, simulating a
  preemption at exactly that moment. Sites are DETERMINISTIC: the n-th
  hit of a site is the same program point on every run. Disarmed (the
  default), a kill point is one module-global load and one branch.
- **transient errors + retry** — :func:`retry_io` wraps host IO in
  bounded retry with exponential backoff; an armed plan can inject
  ``OSError`` a fixed number of times at a site to prove the retry path
  end to end. A `retry_io` site is a FULL fault site: ``errors[site]``
  injects retried transient failures, and ``kills[site]`` injects an
  :class:`InjectedFault` at that occurrence — fatal unless the caller's
  ``retry_on`` includes it. Backoff is deterministic (no jitter).

The registry keeps every reference site, so plans and site names mean
the same in both packages, and the port hits every one but
``selftest_io`` (the selftest's own): ``replica_dispatch``
(`serving.fleet.ReplicaFleet.score`, one hit per failover attempt),
``chunk_upload``
(`data.dataset.DeviceChunkRing.stream_pass`, one hit per consumed
chunk), ``evaluation`` (`optim.streamed`), ``bucket_retire``
(`game.random_effect`), ``snapshot_write`` / ``snapshot_io`` / ``commit``
(`checkpoint.store`), ``swap_publish`` (`continual.swap.publish_store`),
``rung_execute`` (`serving.dispatcher.RungExecutor.execute`),
``store_open`` (`serving.store.CoefficientStore.open`), ``avro_open``,
``ingest_worker``, ``cache_open`` and ``cache_commit``.

Counters (`telemetry`): ``faults.injected_kills``,
``faults.injected_errors``, ``faults.io_retries``,
``faults.backoff_seconds``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional

from photon_tpu_torch import telemetry

__all__ = [
    "FAULT_SITES", "InjectedFault", "TransientIOError", "FaultPlan",
    "arm_faults", "disarm_faults", "fault_plan", "current_plan",
    "kill_point", "record_sites", "retry_io",
]

# The canonical fault-site registry, the reference's entries verbatim (a
# plan names the same program point in both packages). Paths are the
# reference's module paths.
FAULT_SITES = {
    # kill points (one `kill_point` hit per occurrence)
    "chunk_upload": (
        "data/dataset.py — per streamed feature-chunk upload (iter_device"
        " and the persistent DeviceChunkRing)"),
    "evaluation": (
        "optim/streamed.py — per streamed objective evaluation (the "
        "checkpoint cadence tick)"),
    "bucket_retire": (
        "game/random_effect.py — per retired random-effect block in the "
        "pipelined train loop"),
    "snapshot_write": (
        "checkpoint/store.py — inside SnapshotStore payload writes, "
        "before the manifest swing"),
    "commit": (
        "checkpoint/store.py commit_bytes/replace_committed — the widest "
        "window of every two-phase commit, after the temp write"),
    "swap_publish": (
        "continual/swap.py — between the versioned store publish and the "
        "CURRENT-pointer commit of a serving hot-swap"),
    "rung_execute": (
        "serving/dispatcher.py RungExecutor — per dispatched micro-batch "
        "device program (a replica death mid-request)"),
    "ingest_worker": (
        "data/ingest_plane.py — once per retired decode task (a worker "
        "death; the stream degrades that chunk to in-process decode)"),
    # retry_io sites (errors[site] injects retried TransientIOErrors;
    # kills[site] still injects an InjectedFault at that occurrence)
    "avro_open": (
        "data/streaming.py — Avro container opens for the ingest scan "
        "and chunkers"),
    "snapshot_io": (
        "checkpoint/store.py — snapshot payload/manifest reads on the "
        "restore path"),
    "store_open": (
        "serving/store.py CoefficientStore.open — serving store manifest"
        " + block opens (missing manifest fails fast)"),
    "replica_dispatch": (
        "serving/fleet.py — per-replica request dispatch; retry_on "
        "includes InjectedFault, so a kill here IS a failover"),
    "cache_open": (
        "data/chunk_cache.py — chunk-cache manifest/payload opens "
        "(a torn entry reads as a miss)"),
    "cache_commit": (
        "data/chunk_cache.py — payload writes + the manifest-last commit "
        "of a cache entry"),
    "selftest_io": (
        "checkpoint/__main__.py — the selftest's retry/backoff proof "
        "site (never hit in production code)"),
}


class InjectedFault(RuntimeError):
    """An injected kill: the simulated preemption. Deliberately an
    exception (not os._exit) so in-process tests observe the exact state a
    real SIGKILL would leave on disk, while the dead run's Python state is
    simply abandoned."""

    def __init__(self, site: str, occurrence: int):
        super().__init__(f"injected fault at {site!r} occurrence "
                         f"{occurrence}")
        self.site = site
        self.occurrence = occurrence


class TransientIOError(OSError):
    """The injected transient host-IO failure (an OSError subclass, so the
    default ``retry_io`` policy retries it)."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject where.

    kills: site -> 1-based occurrence at which to raise InjectedFault.
    errors: site -> number of leading occurrences that raise
        TransientIOError before the site starts succeeding (exercises the
        retry/backoff path).
    """

    kills: dict = dataclasses.field(default_factory=dict)
    errors: dict = dataclasses.field(default_factory=dict)
    # live occurrence counters per site (site -> hits so far)
    hits: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def kill_at(cls, site: str, occurrence: int) -> "FaultPlan":
        return cls(kills={site: int(occurrence)})

    @classmethod
    def seeded(cls, seed: int, site_counts: dict) -> "FaultPlan":
        """A deterministic seeded kill: pick one (site, occurrence) from
        the observed ``site -> hit count`` map of a dry run
        (:func:`record_sites`). Same seed + same counts = same kill."""
        import numpy as np

        rng = np.random.default_rng(seed)
        sites = sorted(s for s, c in site_counts.items() if c > 0)
        if not sites:
            raise ValueError("no fault sites were hit in the dry run")
        site = sites[int(rng.integers(len(sites)))]
        occ = 1 + int(rng.integers(site_counts[site]))
        return cls.kill_at(site, occ)

    def hit(self, site: str) -> int:
        # fault sites fire from every thread in the stack (writer,
        # dispatch, fleet workers); the occurrence counters must not
        # lose increments or two kill-at-occurrence-N plans drift
        with _HIT_LOCK:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
        return n


_HIT_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None


def arm_faults(plan: FaultPlan) -> FaultPlan:
    """Arm a plan process-wide (occurrence counters start fresh)."""
    global _PLAN
    plan.hits = {}
    _PLAN = plan
    return plan


def disarm_faults() -> None:
    global _PLAN
    _PLAN = None


def current_plan() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def fault_plan(plan: FaultPlan):
    """``with fault_plan(FaultPlan.kill_at("bucket_retire", 2)): ...``"""
    arm_faults(plan)
    try:
        yield plan
    finally:
        disarm_faults()


def kill_point(site: str) -> None:
    """A named preemption site. Disarmed: one global load + one branch."""
    plan = _PLAN
    if plan is None:
        return
    n = plan.hit(site)
    if plan.kills.get(site) == n:
        telemetry.count("faults.injected_kills")
        raise InjectedFault(site, n)


def _maybe_io_error(site: str) -> None:
    """The fault half of a `retry_io` site, honoring BOTH plan maps on one
    occurrence counter: ``kills[site] == n`` raises InjectedFault (a kill
    at the n-th attempt — NOT retried unless the caller's ``retry_on``
    includes it, which is how the serving fleet turns a replica death
    into failover), and ``n <= errors[site]`` raises TransientIOError
    (each retry attempt is its own occurrence, so ``errors={"s": 2}``
    fails twice then succeeds)."""
    plan = _PLAN
    if plan is None:
        return
    n = plan.hit(site)
    if plan.kills.get(site) == n:
        telemetry.count("faults.injected_kills")
        raise InjectedFault(site, n)
    if n <= plan.errors.get(site, 0):
        telemetry.count("faults.injected_errors")
        raise TransientIOError(f"injected transient IO failure at "
                               f"{site!r} occurrence {n}")


class _Recorder(FaultPlan):
    pass


@contextlib.contextmanager
def record_sites():
    """Dry-run recorder: arms a plan that injects NOTHING but counts site
    hits — the fault matrix a test enumerates kills over.

    >>> with record_sites() as rec: run()
    >>> rec.hits  # {"evaluation": 42, "chunk_upload": 126, ...}
    """
    rec = _Recorder()
    arm_faults(rec)
    try:
        yield rec
    finally:
        disarm_faults()


def retry_io(fn: Callable, *, site: str, retries: int = 4,
             base_delay: float = 0.05, max_delay: float = 2.0,
             retry_on: tuple = (OSError,), sleep=time.sleep):
    """Run ``fn()`` with bounded exponential-backoff retry on transient
    host-IO errors (delays ``base_delay * 2**attempt`` capped at
    ``max_delay``; deterministic, no jitter). The armed fault plan's
    ``errors[site]`` budget injects failures here, so the retry path is
    provable end to end. The final failure re-raises unmodified."""
    attempt = 0
    while True:
        try:
            _maybe_io_error(site)
            return fn()
        except retry_on:
            if attempt >= retries:
                raise
            delay = min(base_delay * (2.0 ** attempt), max_delay)
            telemetry.count("faults.io_retries")
            telemetry.count(f"faults.io_retries.{site}")
            telemetry.count("faults.backoff_seconds", delay)
            sleep(delay)
            attempt += 1
