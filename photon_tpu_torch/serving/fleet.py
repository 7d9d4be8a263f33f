"""Replica fleet: the serving tier's scale-out plane (port of
`photon_tpu/serving/fleet.py`).

N `MicroBatchDispatcher` replicas, each over an ENTITY-RANGE shard of the
`CoefficientStore`, with request routing and retry/timeout/exponential-
backoff failover riding `checkpoint.faults.retry_io`:

- **Sharding** (`shard_store`): shard ``j`` of ``n`` holds every fixed
  block (shared, read-only) plus the contiguous dense-row range
  ``[j·E/n, (j+1)·E/n)`` of each random block, re-rooted to a local
  `IndexMap`. An entity outside a shard's range resolves to that shard's
  cold-miss zero row — the fixed-effect-only answer an unseen entity
  gets, so a failover answer is degraded but CORRECT, never wrong.
- **Routing** (`ReplicaFleet.replica_for`): the request's first routed
  entity key → dense id through the full directory → the owning range;
  keyless or unseen requests hash (crc32) across replicas. Routing is
  host arithmetic: a request's device work is its replica's one rung
  launch a flush, with no collective (`python -m photon_tpu_torch.
  serving --selftest`'s ``fleet_request_path``).
- **Failover** (`score`/`submit`): each attempt submits to a replica and
  bounds the wait (``attempt_timeout_s``); a replica error, injected
  kill or timeout fails over to the next replica (mod N) under
  `retry_io`'s bounded exponential backoff at the ``replica_dispatch``
  fault site. With the dispatcher's ``rung_execute`` and the store's
  ``store_open`` sites, a kill matrix shows that every fault ×
  first/middle/last occurrence leaves no hung future, no torn response
  and only exact or degraded-but-correct answers.

All replicas of one process share its device (the store's): on one card
they are N dispatchers over N shards, each flushing its own rung.

Telemetry (`serving.*`): ``fleet_dispatches`` (successful replica
answers), ``fleet_failovers`` (attempts beyond the primary),
``fleet_degraded`` (answers served off a non-owning replica), the
``fleet_replicas`` gauge, and with `telemetry.trace` armed the
``fleet_route`` / ``replica_dispatch`` / ``failover_backoff`` hops
around each replica's own ``queue_wait`` / ``device_flush`` /
``retire_wait``.
"""
from __future__ import annotations

import bisect
import dataclasses
import zlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

import numpy as np

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint.faults import retry_io
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.serving.admission import AdmissionPolicy, Shed
from photon_tpu_torch.serving.dispatcher import (MicroBatchDispatcher,
                                                 ScoreRequest)
from photon_tpu_torch.serving.programs import ProgramLadder
from photon_tpu_torch.serving.store import CoefficientStore, RandomBlock
from photon_tpu_torch.telemetry import trace
from photon_tpu_torch.telemetry.health import QuantileDigest

__all__ = ["FleetPolicy", "Replica", "ReplicaFleet", "shard_bounds",
           "shard_store"]


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Failover knobs.

    attempt_timeout_s: bound on one replica's answer before failing over
        (queueing + dispatch + read-back on that replica).
    failover_retries: extra attempts beyond the primary (each on the
        next replica, mod N).
    base_delay_s/max_delay_s: `retry_io`'s exponential-backoff envelope
        between attempts.
    submit_workers: thread pool driving asynchronous `submit` calls.
    """

    attempt_timeout_s: float = 10.0
    failover_retries: int = 2
    base_delay_s: float = 0.005
    max_delay_s: float = 0.1
    submit_workers: int = 8


def _directory_keys(directory) -> list:
    if hasattr(directory, "keys_in_order"):
        return list(directory.keys_in_order())
    raise ValueError(
        "entity-range sharding needs an enumerable directory "
        "(IndexMap/PalDBIndexMap); rebuild the store with one")


def shard_bounds(n_entities: int, n_shards: int) -> list:
    """Contiguous balanced range bounds: shard j owns dense rows
    ``[bounds[j], bounds[j+1])``."""
    return [(j * n_entities) // n_shards for j in range(n_shards + 1)]


def shard_store(store: CoefficientStore, n_shards: int) -> list:
    """Split one CoefficientStore into ``n_shards`` entity-range shards on
    the store's device.

    Fixed blocks are shared by reference (read-only); each random block
    is sliced to its range with a fresh zero cold-miss row and a local
    `IndexMap` directory. The shards cover every entity exactly once; any
    shard answers any request (out-of-range entities degrade to the
    fixed-effect-only score)."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    shards = []
    for j in range(n_shards):
        random: dict = {}
        for name, blk in store.random.items():
            keys = _directory_keys(blk.directory)
            bounds = shard_bounds(blk.n_entities, n_shards)
            lo, hi = bounds[j], bounds[j + 1]
            C = np.zeros((hi - lo + 1, blk.dim), np.float32)
            C[:-1] = np.asarray(blk.coefficients[lo:hi], np.float32)
            local = IndexMap({keys[i]: i - lo for i in range(lo, hi)},
                             frozen=True)
            random[name] = RandomBlock(blk.feature_shard, blk.entity_name,
                                       C, local)
        shards.append(CoefficientStore(store.task, store.order,
                                       dict(store.fixed), random,
                                       device=store.device))
    return shards


@dataclasses.dataclass
class _Route:
    """Router state for one random coordinate: the FULL directory plus
    the range bounds that map a dense id to its owning replica."""

    name: str
    entity_name: str
    block: RandomBlock  # the full (unsharded) block — host lookups only
    bounds: list


class Replica:
    """One serving node: an entity-range shard behind its own ladder and
    dispatcher."""

    def __init__(self, index: int, store: CoefficientStore,
                 ladder: ProgramLadder, dispatcher: MicroBatchDispatcher):
        self.index = index
        self.store = store
        self.ladder = ladder
        self.dispatcher = dispatcher

    def dispatch(self, req: ScoreRequest, timeout: float):
        """Submit + bounded wait on this replica (one failover attempt)."""
        return self.dispatcher.submit(req).result(timeout=timeout)


def _replicas(stores: list, ladder_kwargs, dispatcher_kwargs, admission,
              warmup: bool) -> list:
    lk = dict(ladder_kwargs or {})
    dk = dict(dispatcher_kwargs or {})
    replicas = []
    for j, shard in enumerate(stores):
        ladder = ProgramLadder(shard, **lk)
        if warmup:
            ladder.warmup()
        d = MicroBatchDispatcher(ladder, policy=admission, **dk)
        replicas.append(Replica(j, shard, ladder, d))
    return replicas


class ReplicaFleet:
    """N dispatcher replicas over entity-range shards, with routing and
    retry/backoff failover. Build with `ReplicaFleet.build(store, n)`
    (in-memory shards) or `ReplicaFleet.open([dir, ...])` (saved shard
    stores — each open rides the ``store_open`` retry site)."""

    def __init__(self, replicas: list, routes: list,
                 policy: Optional[FleetPolicy] = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = replicas
        self.routes = routes
        self.policy = policy or FleetPolicy()
        self._pool = ThreadPoolExecutor(
            max_workers=self.policy.submit_workers,
            thread_name_prefix="serving-fleet")
        self._closed = False
        telemetry.gauge("serving.fleet_replicas", len(replicas))

    # ------------------------------------------------------------ builders
    @classmethod
    def build(cls, store: CoefficientStore, n_replicas: int, *,
              policy: Optional[FleetPolicy] = None,
              admission: Optional[AdmissionPolicy] = None,
              ladder_kwargs: Optional[dict] = None,
              dispatcher_kwargs: Optional[dict] = None,
              warmup: bool = False) -> "ReplicaFleet":
        """Shard ``store`` into ``n_replicas`` ranges and start one ladder
        + dispatcher per shard on the store's device (``warmup`` runs each
        ladder's `warmup`, a quantized ladder's accuracy gate included).
        The router keeps the full store's directories for range lookups
        (host memory only)."""
        shards = shard_store(store, n_replicas)
        replicas = _replicas(shards, ladder_kwargs, dispatcher_kwargs,
                             admission, warmup)
        routes = [
            _Route(name, blk.entity_name, blk,
                   shard_bounds(blk.n_entities, n_replicas))
            for name, blk in store.random.items()]
        return cls(replicas, routes, policy=policy)

    @classmethod
    def open(cls, shard_dirs: list, *, mmap: bool = True,
             routing_store: Optional[CoefficientStore] = None,
             policy: Optional[FleetPolicy] = None,
             admission: Optional[AdmissionPolicy] = None,
             ladder_kwargs: Optional[dict] = None,
             dispatcher_kwargs: Optional[dict] = None,
             device=None, warmup: bool = False) -> "ReplicaFleet":
        """A fleet over saved per-shard store directories, on ``device``
        (each `CoefficientStore.open` rides the ``store_open`` fault site,
        so a flaky open retries and an injected kill at any occurrence
        dies cleanly before any replica thread starts). Routing uses
        ``routing_store``'s full directories when given; otherwise
        requests hash across replicas (every shard still answers)."""
        stores = [CoefficientStore.open(d, mmap=mmap, device=device)
                  for d in shard_dirs]
        replicas = _replicas(stores, ladder_kwargs, dispatcher_kwargs,
                             admission, warmup)
        routes = []
        if routing_store is not None:
            routes = [
                _Route(name, blk.entity_name, blk,
                       shard_bounds(blk.n_entities, len(stores)))
                for name, blk in routing_store.random.items()]
        return cls(replicas, routes, policy=policy)

    # ------------------------------------------------------------- routing
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @staticmethod
    def _hash(key: str) -> int:
        return zlib.crc32(key.encode("utf-8", "surrogateescape"))

    def replica_for(self, req: ScoreRequest) -> int:
        """The replica owning this request's first routed entity's range;
        keyless or unseen-entity requests hash across the fleet (any
        replica serves their fixed-effect-only score identically)."""
        for route in self.routes:
            raw = req.entities.get(route.entity_name)
            if raw is None:
                continue
            ids, miss = route.block.lookup([raw])
            if miss:
                return self._hash(str(raw)) % self.n_replicas
            return bisect.bisect_right(route.bounds, int(ids[0])) - 1
        return self._hash(repr(sorted(req.entities.items()))) \
            % self.n_replicas

    # ------------------------------------------------------------- serving
    def score(self, req: ScoreRequest, timeout: Optional[float] = None):
        """Synchronous fleet scoring with failover: the primary replica by
        range, then the next (mod N) on error/kill/timeout, with backoff
        between attempts (`retry_io`, site ``replica_dispatch``). Returns
        the float score — or the replica's typed `Shed` under overload
        policy (shedding is an answer; it never fails over, so an
        overloaded fleet does not cascade)."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        primary = self.replica_for(req)
        state = {"attempt": 0}
        bound = self.policy.attempt_timeout_s if timeout is None else timeout
        # one trace across every failover attempt: the ContextVar attach
        # below lets each replica's dispatcher continue THIS trace
        tc = trace.begin("fleet_route", primary=primary)

        def attempt():
            idx = (primary + state["attempt"]) % self.n_replicas
            if state["attempt"]:
                telemetry.count("serving.fleet_failovers")
            state["attempt"] += 1
            trace.hop(tc, "replica_dispatch", replica=idx)
            try:
                with trace.attach(tc):
                    out = self.replicas[idx].dispatch(req, timeout=bound)
            except BaseException:
                # retry_io's backoff sleep runs between this raise and
                # the next attempt's hop — it accrues here, by name
                trace.hop(tc, "failover_backoff", replica=idx)
                raise
            telemetry.count("serving.fleet_dispatches")
            if idx != primary and not isinstance(out, Shed):
                telemetry.count("serving.fleet_degraded")
            return out

        # InjectedFault is a RuntimeError: an injected replica death at
        # any occurrence fails over exactly like a real one
        try:
            return retry_io(attempt, site="replica_dispatch",
                            retries=self.policy.failover_retries,
                            base_delay=self.policy.base_delay_s,
                            max_delay=self.policy.max_delay_s,
                            retry_on=(OSError, FutureTimeout, RuntimeError))
        finally:
            trace.finish(tc)  # no-op if a retire thread closed it first

    def submit(self, req: ScoreRequest):
        """Asynchronous fleet scoring: a Future resolving to the score (or
        `Shed`), driven by the fleet's worker pool through `score`."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        return self._pool.submit(self.score, req)

    # ------------------------------------------------------------ lifecycle
    def assert_no_retrace(self) -> int:
        """Every replica's ladder holds its signature bound; returns the
        total distinct-signature count across the fleet."""
        return sum(r.ladder.assert_no_retrace() for r in self.replicas)

    def latency_stats(self) -> dict:
        """Pooled request-latency percentiles across all replicas — an
        EXACT digest merge (same bucketing → counts add)."""
        merged = QuantileDigest()
        for r in self.replicas:
            with r.dispatcher._lat_lock:
                merged.merge(r.dispatcher._lat)
        s = merged.stats_ms()
        return {"n": s["n"], "p50_ms": s["p50_ms"],
                "p95_ms": s["p95_ms"], "p99_ms": s["p99_ms"]}

    def close(self, timeout: float = 30.0) -> None:
        """Drain the submit pool, then close every replica (each close
        flushes its queue — every outstanding future resolves).
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        for r in self.replicas:
            r.dispatcher.close(timeout=timeout)


# ----------------------------------------------------------------- contracts
# The fleet's per-request device path IS the single-replica rung program:
# routing and failover are host arithmetic, sharding only re-roots the
# coefficient blocks.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402


@register_contract(
    name="serving_fleet_request_path",
    description="one fleet replica's rung program over an entity-range "
                "shard: the per-request path stays collective-free / "
                "sync-free / f64-free — routing and failover never enter "
                "the device program",
    collectives={}, tags=("serving",))
def _contract_fleet_request_path(device):
    from photon_tpu_torch.serving.programs import (_contract_rung_args,
                                                   _tiny_store)

    shards = shard_store(_tiny_store(device), 2)
    ladder = ProgramLadder(shards[0], ladder=(8,), sparse_k={"member": 3},
                           output_mean=True)
    return ladder._fn, _contract_rung_args(ladder, 8)
