"""Micro-batching dispatcher: the serving tier's request plane (port of
`photon_tpu/serving/dispatcher.py`, with its ``rung_execute`` fault
site and its request tracing).

A bounded queue feeds a dispatch thread that collects up to ``max_batch``
requests or until the OLDEST queued request has waited ``max_delay_us``,
pads the batch into the nearest `ProgramLadder` rung (zero rows, entity
id = the zero row), resolves entity keys through the `CoefficientStore`
(cold misses score the fixed-effect-only fallback and are counted), and
dispatches ONE rung. A separate retire thread waits for the result and
resolves the futures, so dispatch of batch i+1 overlaps the readback of
batch i.

On CUDA the collated host batch lives in pinned memory and uploads with
``non_blocking``; the dispatch thread queues the upload and the rung on
its own stream and records a `torch.cuda.Event` after them; the retire
thread waits on that event before its device-to-host copy (on a stream
of its own).

Telemetry (`serving.*`): requests/batches/batch_rows/pad_waste/
cold_misses/admitted/shed/deadline_expired counters, queue-depth and
batch-fill gauges, a ``serving.flush`` span and a ``serving_batch``
event per flush (with a run attached), and per-request latency (enqueue
→ score delivered) in a fixed-size `QuantileDigest`, summarized by
`latency_stats`. With `telemetry.trace` armed each request carries a
trace on its ``_Pending`` slot: ``queue_wait`` from submit, then
``device_flush`` (collation, upload and the rung's launch), then
``retire_wait`` (the wait for the device and the read-back), closed by
the retire thread as it resolves the future (``shed`` instead for a
request admission drops). A failed request closes its trace only if the
trace is its own: one continued from a `ReplicaFleet` stays open, so the
fleet's failover hops land on it (the reference closes it here, which
drops them).

Thread-safety: `submit`/`score` are safe from any number of client
threads; results arrive on `concurrent.futures.Future`s — a float score,
or a typed `admission.Shed` when overload policy dropped the request.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint import faults
from photon_tpu_torch.data.matrix import SparseRows
from photon_tpu_torch.serving.admission import (SHED_DEADLINE,
                                                SHED_QUEUE_FULL,
                                                AdmissionController,
                                                AdmissionPolicy, Shed)
from photon_tpu_torch.serving.programs import ProgramLadder
from photon_tpu_torch.serving.store import CoefficientStore
from photon_tpu_torch.telemetry import trace
from photon_tpu_torch.telemetry.health import QuantileDigest


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request: per-shard feature rows + entity keys.

    features: shard name → dense ``(d,)`` vector, or ``(indices, values)``
        arrays of length ≤ the shard's ``sparse_k`` (padded-COO row).
    entities: entity-type name → raw key. A missing or unseen key scores
        the fixed-effect-only fallback.
    offset: base margin offset.
    deadline_ms: per-request deadline from enqueue (overrides the policy).
    """

    features: dict
    entities: dict = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    deadline_ms: Optional[float] = None


class _Pending:
    __slots__ = ("req", "future", "t_enqueue", "deadline_ns", "trace",
                 "own_trace")

    def __init__(self, req: ScoreRequest):
        self.req = req
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter_ns()
        self.deadline_ns: Optional[int] = None
        # None unless tracing is armed; carried across the dispatch/retire
        # thread boundary so the future-resolving thread closes the trace
        self.trace = trace.begin("queue_wait")
        # a trace continued from the caller's (a fleet's) is the caller's
        # to close when the request fails: it fails over on the same trace
        self.own_trace = (self.trace is not None
                          and trace.current() is not self.trace)


def collate_rung_args(ladder: ProgramLadder, batch: list,
                      bucket: int) -> tuple:
    """Stack + pad B requests into one full-rung argument set of host
    tensors (pinned when the ladder serves on CUDA). Pad rows are
    all-zero (features, offsets) with entity id = the zero row.

    Returns ``(offsets, shards, ids, n_cold_misses)``. Raises ValueError
    for a sparse row with more than ``sparse_k`` slots or an index
    outside its shard."""
    pin = ladder.device.type == "cuda"

    def host(shape, dtype):
        return torch.zeros(shape, dtype=dtype, pin_memory=pin)

    store = ladder.store
    B, n = bucket, len(batch)
    offsets = host(B, torch.float32)
    offsets.numpy()[:n] = [p.req.offset for p in batch]
    shards = {}
    for s, spec in ladder.shard_specs.items():
        if spec.sparse_k is None:
            X = host((B, spec.d), torch.float32)
            Xn = X.numpy()
            for i, p in enumerate(batch):
                Xn[i] = np.asarray(p.req.features[s], np.float32)
            shards[s] = X
        else:
            k = spec.sparse_k
            ind, val = host((B, k), torch.int32), host((B, k), torch.float32)
            indn, valn = ind.numpy(), val.numpy()
            for i, p in enumerate(batch):
                ri, rv = p.req.features[s]
                ri = np.asarray(ri, np.int32)
                if ri.shape[0] > k:
                    raise ValueError(
                        f"request row has {ri.shape[0]} nnz > shard "
                        f"{s!r} sparse_k={k}")
                if ri.size and (ri.min() < 0 or ri.max() >= spec.d):
                    raise ValueError(
                        f"request row indexes shard {s!r} outside "
                        f"[0, {spec.d})")
                indn[i, :ri.shape[0]] = ri
                valn[i, :ri.shape[0]] = np.asarray(rv, np.float32)
            shards[s] = SparseRows(ind, val, spec.d)
    ids = {}
    misses = 0
    for name, blk in store.random.items():
        raw = [p.req.entities.get(blk.entity_name) for p in batch]
        # absent key == unseen entity: both resolve to the zero row
        keys = ["\x00missing\x00" if r is None else r for r in raw]
        dense, n_miss = blk.lookup(keys)
        col = host(B, torch.int32)
        coln = col.numpy()
        coln[:] = blk.n_entities
        coln[:n] = dense
        ids[name] = col
        misses += n_miss
    return offsets, shards, ids, misses


class RungExecutor:
    """The device-execution half: collate one admitted batch into its rung
    and dispatch it. No queue, no policy."""

    def __init__(self, ladder: ProgramLadder):
        self.ladder = ladder

    def execute(self, batch: list) -> tuple:
        """(device_out, bucket, n_cold_misses) for one non-empty batch."""
        bucket = self.ladder.bucket_for(len(batch))
        offsets, shards, ids, misses = collate_rung_args(
            self.ladder, batch, bucket)
        faults.kill_point("rung_execute")  # a replica death mid-request
        out_dev = self.ladder.score_padded(offsets, shards, ids)
        return out_dev, bucket, misses


class MicroBatchDispatcher:
    """Bounded-queue, deadline-flushed micro-batcher over a ProgramLadder.

    max_batch: flush size cap; defaults to (and may not exceed) the
        ladder's top rung.
    max_delay_us: oldest-request deadline — the latency the thinnest
        traffic pays to fill batches.
    queue_depth: bound on queued requests; `submit` blocks when full
        unless the admission policy bounds the wait.
    policy: overload policy (`admission.AdmissionPolicy`); default off.
    """

    def __init__(self, ladder: ProgramLadder, *,
                 max_batch: Optional[int] = None,
                 max_delay_us: int = 500,
                 queue_depth: int = 4096,
                 policy: Optional[AdmissionPolicy] = None):
        self.ladder = ladder
        self.store: CoefficientStore = ladder.store
        self.max_batch = int(max_batch or ladder.max_batch)
        if self.max_batch > ladder.max_batch:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the ladder top rung "
                f"{ladder.max_batch}")
        self.max_delay_us = int(max_delay_us)
        self.admission = AdmissionController(policy)
        self._executor = RungExecutor(ladder)
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._retire_q: queue.Queue = queue.Queue(maxsize=4)
        self._lat = QuantileDigest()
        self._lat_lock = threading.Lock()
        self._closed = False
        cuda = ladder.device.type == "cuda"
        self._stream = torch.cuda.Stream(ladder.device) if cuda else None
        self._retire_stream = (torch.cuda.Stream(ladder.device) if cuda
                               else None)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch", daemon=True)
        self._retire_thread = threading.Thread(
            target=self._retire_loop, name="serving-retire", daemon=True)
        self._dispatch_thread.start()
        self._retire_thread.start()

    # ------------------------------------------------------------- client API
    def submit(self, req: ScoreRequest,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to its float score — or
        to a typed `Shed` when admission drops it.

        ``timeout`` bounds the blocking put (overrides the policy's
        ``submit_timeout_s``; 0 = never block)."""
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        p = _Pending(req)
        p.deadline_ns = self.admission.deadline_ns(req, p.t_enqueue)
        reason = self.admission.submit_shed_reason(self._q.qsize())
        if reason is not None:
            return self._shed(p, reason)
        bound = self.admission.submit_timeout_s(timeout)
        if bound is None:
            self._q.put(p)  # blocks when the bounded queue is full
        else:
            try:
                if bound > 0:
                    self._q.put(p, timeout=bound)
                else:
                    self._q.put_nowait(p)
            except queue.Full:
                return self._shed(p, SHED_QUEUE_FULL)
        telemetry.count("serving.admitted")
        return p.future

    def score(self, req: ScoreRequest, timeout: Optional[float] = None):
        """Synchronous scoring: submit + wait. Returns the float score, or
        a `Shed` under overload policy."""
        return self.submit(req).result(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Flush every queued request, stop both threads, gauge the final
        latency percentiles. Every outstanding future resolves. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)  # dispatch sentinel; drains the queue first
        self._dispatch_thread.join(timeout=timeout)
        self._retire_q.put(None)
        self._retire_thread.join(timeout=timeout)
        stats = self.latency_stats()
        if stats["n"]:
            for k in ("p50_ms", "p95_ms", "p99_ms"):
                telemetry.gauge(f"serving.latency_{k}", stats[k])

    def latency_stats(self) -> dict:
        """Request-latency percentiles (ms) over every retired request."""
        with self._lat_lock:
            return self._lat.stats_ms()

    # ------------------------------------------------------------- internals
    def _shed(self, p: _Pending, reason: str) -> Future:
        waited_ms = (time.perf_counter_ns() - p.t_enqueue) / 1e6
        if reason == SHED_DEADLINE:
            telemetry.count("serving.deadline_expired")
        else:
            telemetry.count("serving.shed")
        trace.hop(p.trace, "shed", reason=reason)
        trace.finish(p.trace)
        if not p.future.done():
            p.future.set_result(Shed(reason, queue_depth=self._q.qsize(),
                                     waited_ms=waited_ms))
        return p.future

    def _expire(self, p: _Pending, now_ns: Optional[int] = None) -> bool:
        if not self.admission.expired(p, now_ns):
            return False
        self._shed(p, SHED_DEADLINE)
        return True

    def _dispatch_loop(self) -> None:
        if self._stream is None:
            self._collect_and_flush()
        else:
            with torch.cuda.stream(self._stream):
                self._collect_and_flush()
        self._retire_q.put(None)

    def _collect_and_flush(self) -> None:
        done = False
        while not done:
            first = self._q.get()
            if first is None:
                # drain without waiting: everything already queued still
                # resolves — scored, or shed if its deadline passed
                batch = []
                while True:
                    try:
                        p = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if p is not None and not self._expire(p):
                        batch.append(p)
                while batch:
                    self._flush(batch[:self.max_batch])
                    batch = batch[self.max_batch:]
                return
            if self._expire(first):
                continue
            batch = [first]
            deadline = first.t_enqueue + self.max_delay_us * 1000
            while len(batch) < self.max_batch:
                # greedy first: a backlogged queue fills the batch at once;
                # the deadline only bounds the wait for traffic not yet here
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    wait_s = (deadline - time.perf_counter_ns()) / 1e9
                    if wait_s <= 0:
                        break
                    try:
                        p = self._q.get(timeout=wait_s)
                    except queue.Empty:
                        break
                if p is None:
                    done = True
                    break
                if not self._expire(p):
                    batch.append(p)
            telemetry.gauge("serving.queue_depth", self._q.qsize())
            self._flush(batch)

    def _flush(self, batch: list) -> None:
        # last-chance deadline check before the batch takes rung slots
        now = time.perf_counter_ns()
        batch = [p for p in batch if not self._expire(p, now)]
        n = len(batch)
        if n == 0:
            return
        for p in batch:
            trace.hop(p.trace, "device_flush")
        try:
            with telemetry.span("serving.flush", rows=n):
                out_dev, bucket, misses = self._executor.execute(batch)
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
            telemetry.count("serving.requests", n)
            telemetry.count("serving.batches")
            telemetry.count("serving.batch_rows", n)
            telemetry.count("serving.pad_waste", bucket - n)
            if misses:
                telemetry.count("serving.cold_misses", misses)
            telemetry.gauge("serving.batch_fill", n / bucket)
            telemetry.event("serving_batch", rows=n, bucket=bucket,
                            cold_misses=misses)
            for p in batch:
                trace.hop(p.trace, "retire_wait")
            self._retire_q.put((batch, out_dev, ready))
        except Exception as e:  # delivered to every waiting caller
            for p in batch:
                if p.own_trace:
                    trace.finish(p.trace)
                if not p.future.done():
                    p.future.set_exception(e)

    def _retire_loop(self) -> None:
        if self._retire_stream is None:
            self._retire()
        else:
            with torch.cuda.stream(self._retire_stream):
                self._retire()

    def _retire(self) -> None:
        while True:
            item = self._retire_q.get()
            if item is None:
                return
            batch, out_dev, ready = item
            try:
                if ready is not None:
                    ready.synchronize()
                scores = out_dev.cpu().numpy()
            except Exception as e:  # delivered to every waiting caller
                for p in batch:
                    if p.own_trace:
                        trace.finish(p.trace)
                    p.future.set_exception(e)
                continue
            t_now = time.perf_counter_ns()
            lats = []
            for i, p in enumerate(batch):
                lats.append(t_now - p.t_enqueue)
                trace.finish(p.trace)  # the retire thread closes the trace
                p.future.set_result(float(scores[i]))
            with self._lat_lock:
                self._lat.add_many(lats)
