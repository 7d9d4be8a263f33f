"""Per-request distributed tracing (port of
`photon_tpu/telemetry/trace.py`): trace ids, causally-ordered hop
records, and a bounded reservoir of tail exemplars.

The dispatcher's latency percentiles (`MicroBatchDispatcher.
latency_stats`) say WHAT the p99 is; this module says WHY. One
:class:`TraceContext` follows a request across every thread boundary the
request plane crosses — submit → bounded queue → rung flush → retire
read-back (`serving/dispatcher.py`), and across `ReplicaFleet` failover
attempts with their retry backoff (`serving/fleet.py`):

- **Hop records**: a trace is a causally-ordered list of named hops
  (``queue_wait`` → ``device_flush`` → ``retire_wait``, with
  ``fleet_route``/``replica_dispatch``/``failover_backoff`` around them
  from the fleet). ``switch(name)`` closes the open hop and opens the
  next one — the thread that currently owns the request advances the
  trace, so no hop counts twice and the breakdown sums to the total.
- **Propagation**: within a thread the context rides a `contextvars`
  ContextVar (`attach` / `current`), which is how a fleet-level trace
  crosses into `dispatcher.submit`; across the dispatcher's thread
  boundary it is carried ON the request's ``_Pending`` slot, so the
  retire thread — the one that resolves the future — closes it.
- **Tail exemplars**: a bounded :class:`ExemplarReservoir` keeps the K
  SLOWEST finished traces, each with its full hop breakdown.

THE OFF STATE: tracing is off by default. `begin()` is one module-global
load and one branch when disarmed, every other entry point is
None-guarded, and every hop is host bookkeeping around host queues, so
arming it changes nothing on the device: the same rung launches, the
same argument signatures (the reference pins that with a jaxpr contract;
the port's check is `python -m photon_tpu_torch.telemetry --selftest`'s
``serving_trace_off_is_free``).

Usage::

    from photon_tpu_torch.telemetry import trace

    with trace.tracing(k=8) as reservoir:   # arm + bounded reservoir
        ...drive the dispatcher/fleet...
    for ex in reservoir.snapshot():          # slowest-first exemplars
        print(ex["total_ms"], ex["slowest_hop"], ex["hops"])
"""
from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import os
import threading
import time
from typing import Optional

__all__ = [
    "Hop", "TraceContext", "ExemplarReservoir",
    "armed", "arm_tracing", "disarm_tracing", "tracing", "trace_disabled",
    "begin", "hop", "finish", "attach", "current", "reservoir",
]

_ARMED = False
_RESERVOIR: Optional["ExemplarReservoir"] = None
_SEQ = itertools.count()
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "photon_tpu_torch_trace", default=None)


class Hop:
    """One causally-ordered segment of a request's life. Closed hops have
    an ``end_ns``; the open hop (at most one per trace) does not."""

    __slots__ = ("name", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, start_ns: int, attrs: Optional[dict]):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.attrs = attrs

    @property
    def ns(self) -> int:
        end = self.end_ns if self.end_ns is not None \
            else time.perf_counter_ns()
        return end - self.start_ns

    def to_json(self) -> dict:
        out = {"name": self.name, "ms": round(self.ns / 1e6, 4)}
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class TraceContext:
    """One request's trace: id + ordered hops. Thread-safe: the owning
    thread changes hands (client → dispatch → retire, or fleet worker on
    failover), and a timed-out attempt's late retire must corrupt at most
    its own finish, never the hop list. After `finish` every mutation is
    a no-op, so a straggler thread cannot reopen a deposited trace."""

    __slots__ = ("trace_id", "start_ns", "end_ns", "hops", "_lock", "_done")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or \
            f"t{os.getpid():x}-{next(_SEQ):06x}"
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.hops: list = []
        self._lock = threading.Lock()
        self._done = False

    # ------------------------------------------------------------- mutation
    def switch(self, name: str, **attrs) -> None:
        """Close the open hop (if any) and open ``name`` — the causal
        hand-off point between stages."""
        self._switch(name, time.perf_counter_ns(), attrs)

    def _switch(self, name: str, now: int, attrs: dict) -> None:
        with self._lock:
            if self._done:
                return
            if self.hops and self.hops[-1].end_ns is None:
                self.hops[-1].end_ns = now
            self.hops.append(Hop(name, now, attrs or None))

    def finish(self) -> bool:
        """Close the trace; True for the FIRST finisher only (that caller
        deposits into the reservoir — a late duplicate finish from a
        timed-out failover attempt deposits nothing)."""
        now = time.perf_counter_ns()
        with self._lock:
            if self._done:
                return False
            self._done = True
            if self.hops and self.hops[-1].end_ns is None:
                self.hops[-1].end_ns = now
            self.end_ns = now
            return True

    # -------------------------------------------------------------- reading
    @property
    def total_ns(self) -> int:
        end = self.end_ns if self.end_ns is not None \
            else time.perf_counter_ns()
        return end - self.start_ns

    def breakdown_ms(self) -> dict:
        """Total ms per hop NAME (a repeated hop — e.g. a second
        ``replica_dispatch`` after failover — sums)."""
        with self._lock:
            hops = list(self.hops)
        out: dict = {}
        for h in hops:
            out[h.name] = out.get(h.name, 0.0) + h.ns / 1e6
        return {k: round(v, 4) for k, v in out.items()}

    def slowest_hop(self) -> Optional[str]:
        bd = self.breakdown_ms()
        if not bd:
            return None
        return max(bd.items(), key=lambda kv: kv[1])[0]

    def to_json(self) -> dict:
        with self._lock:
            hops = [h.to_json() for h in self.hops]
        return {"trace_id": self.trace_id,
                "total_ms": round(self.total_ns / 1e6, 4),
                "slowest_hop": self.slowest_hop(),
                "breakdown_ms": self.breakdown_ms(),
                "hops": hops}


class ExemplarReservoir:
    """Bounded keep-the-K-slowest reservoir of finished traces (min-heap
    on total ns, so the cheapest exemplar is evicted first). O(K) memory
    regardless of traffic — the tail-exemplar window of one bench leg or
    serving session."""

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"reservoir k must be >= 1, got {k}")
        self.k = int(k)
        self._heap: list = []  # (total_ns, seq, TraceContext)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.n_offered = 0

    def offer(self, tc: TraceContext) -> None:
        item = (tc.total_ns, next(self._seq), tc)
        with self._lock:
            self.n_offered += 1
            if len(self._heap) < self.k:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)

    def snapshot(self) -> list:
        """Exemplar dicts, SLOWEST first — each with its full hop
        breakdown (the attributable tail)."""
        with self._lock:
            items = sorted(self._heap, key=lambda it: -it[0])
        return [it[2].to_json() for it in items]

    def slowest(self) -> Optional[dict]:
        out = self.snapshot()
        return out[0] if out else None


# ------------------------------------------------------------ arming plane
def armed() -> bool:
    return _ARMED


def arm_tracing(res: Optional[ExemplarReservoir] = None) -> \
        ExemplarReservoir:
    """Arm request tracing process-wide, depositing finished traces into
    ``res`` (a fresh K=8 reservoir by default). Host-side only: no cache
    flush, no program change."""
    global _ARMED, _RESERVOIR
    _RESERVOIR = res if res is not None else ExemplarReservoir()
    _ARMED = True
    return _RESERVOIR


def disarm_tracing() -> None:
    global _ARMED, _RESERVOIR
    _ARMED = False
    _RESERVOIR = None


def reservoir() -> Optional[ExemplarReservoir]:
    return _RESERVOIR


@contextlib.contextmanager
def tracing(k: int = 8):
    """``with trace.tracing(k=8) as res:`` — arm, yield the reservoir,
    disarm (restoring whatever arming state surrounded the block)."""
    was_armed, was_res = _ARMED, _RESERVOIR
    res = arm_tracing(ExemplarReservoir(k))
    try:
        yield res
    finally:
        if was_armed:
            arm_tracing(was_res)
        else:
            disarm_tracing()


@contextlib.contextmanager
def trace_disabled():
    """Force tracing off inside the block (as `taps.tap_disabled`), so an
    armed ambient session cannot change what an off-state check counts.
    Host-flag flip only."""
    global _ARMED
    was = _ARMED
    _ARMED = False
    try:
        yield
    finally:
        _ARMED = was


# ------------------------------------------------------- hot-path helpers
# Each is the ONE branch a tracing-off process pays (None-guarded, like
# telemetry.count's _CURRENT guard).

def begin(name: str = "queue_wait", **attrs) -> Optional[TraceContext]:
    """Start (or continue) the current request's trace and open ``name``.

    Disarmed: one global load + one branch, returns None. Armed: reuses
    a live trace already on the ContextVar (how a fleet-level trace
    crosses into `dispatcher.submit` on the same thread) or starts a
    fresh one."""
    if not _ARMED:
        return None
    tc = _CTX.get()
    if tc is None or tc._done:
        tc = TraceContext()
        # a fresh trace's first hop opens at the trace's own start, so the
        # hops tile its total with no gap between two clock reads
        tc._switch(name, tc.start_ns, attrs)
    else:
        tc.switch(name, **attrs)
    return tc


def hop(tc: Optional[TraceContext], name: str, **attrs) -> None:
    """Advance ``tc`` to hop ``name`` (None-safe: free when disarmed)."""
    if tc is not None:
        tc.switch(name, **attrs)


def finish(tc: Optional[TraceContext]) -> None:
    """Close ``tc`` and deposit it into the armed reservoir. Exactly one
    deposit per trace — late finishers (a timed-out attempt's retire)
    no-op."""
    if tc is None:
        return
    if tc.finish():
        res = _RESERVOIR
        if res is not None:
            res.offer(tc)


@contextlib.contextmanager
def attach(tc: Optional[TraceContext]):
    """Bind ``tc`` as the thread's current trace for the block (the
    ContextVar half of propagation — `ReplicaFleet.score` wraps its
    failover attempts in this so each replica's `submit` continues ONE
    trace)."""
    if tc is None:
        yield None
        return
    token = _CTX.set(tc)
    try:
        yield tc
    finally:
        _CTX.reset(token)


def current() -> Optional[TraceContext]:
    return _CTX.get()


# ----------------------------------------------------------------- contracts
# The off-is-free guarantee, two halves in one spec: (1) the serving rung
# run with tracing disarmed makes no collective and no host sync (tracing
# is host bookkeeping around host queues, it never enters the rung);
# (2) the collated rung ARGUMENTS are signature-identical armed and
# disarmed, so arming tracing never changes a rung's signature (the
# builder raises before returning if they differ).
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import TRANSFER_PRIMITIVES  # noqa: E402


@register_contract(
    name="serving_trace_off_is_free",
    description="serving rung run with request tracing disarmed: zero "
                "collectives, zero host syncs, and zero signature drift — "
                "the collated rung arguments are identical armed and "
                "disarmed",
    collectives={}, forbid=TRANSFER_PRIMITIVES,
    tags=("serving", "telemetry"))
def _contract_serving_trace_off_is_free(device):
    import types

    import numpy as np

    from photon_tpu_torch.serving.dispatcher import (ScoreRequest,
                                                     collate_rung_args)
    from photon_tpu_torch.serving.programs import (ProgramLadder,
                                                   _contract_rung_args,
                                                   _tiny_store)
    from photon_tpu_torch.telemetry.run import SignatureLog

    ladder = ProgramLadder(_tiny_store(device), ladder=(8,),
                           sparse_k={"member": 3}, output_mean=True)
    reqs = [types.SimpleNamespace(req=ScoreRequest(
        features={"global": np.zeros(12, np.float32),
                  "member": (np.asarray([0, 1], np.int32),
                             np.asarray([0.5, -0.25], np.float32))},
        entities={"memberId": f"e{i}"})) for i in range(3)]
    log = SignatureLog()
    with trace_disabled():
        off, shards_off, ids_off, _ = collate_rung_args(ladder, reqs, 8)
    log.record("rung_args", (off, shards_off, ids_off))
    with tracing(k=2):
        on, shards_on, ids_on, _ = collate_rung_args(ladder, reqs, 8)
    log.record("rung_args", (on, shards_on, ids_on))
    if len(log.signatures("rung_args")) != 1:
        raise AssertionError(
            "tracing armed vs disarmed changed the collated rung-argument "
            f"signatures: {log.signatures('rung_args')}")

    def fn(*args):
        with trace_disabled():
            return ladder._fn(*args)

    return fn, _contract_rung_args(ladder, 8)
