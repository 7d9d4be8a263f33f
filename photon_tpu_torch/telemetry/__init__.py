"""Run telemetry spine (port of `photon_tpu/telemetry`): spans,
counters/gauges, and a live per-iteration solver stream across the
resident, streamed, mesh and GAME paths.

::

    from photon_tpu_torch import telemetry

    with telemetry.run("flagship", jsonl_path="out/run.jsonl") as r:
        train_glm(batch, task, config)          # streamed solves emit
    report = r.report()                          # live iteration events

`run.Run` holds the three primitives (spans, counters/gauges, the
iteration stream); `sinks` reads its JSONL file back (`read_jsonl`,
`load_report`, `repair_jsonl_tail`); `taps` is the resident solvers'
opt-in iteration tap; `trace` is per-request tracing with tail
exemplars; `aggregate` merges the per-rank files of a multi-process run;
`health` holds the quantile digest, the watchdog rules and the
`HealthReport`. ``python -m photon_tpu_torch.telemetry --selftest``
smoke-checks them (on the card unless ``--device cpu``).

How this differs from the reference:

- **An always-on registry beside the run.** `count`/`gauge`/`gauge_max`
  update the process-wide `REGISTRY` (one lock an update) whether or not
  a run is attached — the serving path, `parallel/selfcheck.py` and
  `chip_smoke.py` read it through `snapshot()` and clear it with
  `reset()` — and, while a run is attached, the run too, so a run's
  report holds exactly the counters bumped while it was attached.
- **Spans, events, iterations, signatures and memory samples** are the
  reference's off-state: one global load and one branch with no run
  attached, recording nothing; a span checks the profiler's flag too,
  and is a bare `record_function` while torch's profiler collects.
- **The resident tap** folds its loss, |g| and step into the host read
  each solver iteration already makes (no added device sync), instead
  of a compiled-in `jax.debug.callback`.
- **Profiler annotations** are `torch.profiler.record_function` plus an
  NVTX range on CUDA (`run._SpanCM`); device memory comes from
  `torch.cuda.memory_stats`.

This docstring is the HUMAN registry of telemetry names; the
machine-readable twin is `TELEMETRY_REGISTRY` at the bottom of this
module, and ``python -m photon_tpu_torch.lint``'s ``telemetry_sync`` rule
holds all three sides: every counter/gauge literal the package emits is
registered, every registered name is emitted somewhere, and every
registered name appears here. By family (counters unless marked):

- ``faults.*`` — injected_kills, injected_errors, io_retries (also per
  site, ``io_retries.<site>``), backoff_seconds.
- ``checkpoint.*`` — snapshots, bytes, restores, the per-layer
  scope_restores / solver_restores / re_restores / descent_restores,
  gc_snapshots, and the async writer's pack_seconds / commit_seconds.
- ``continual.*`` — plans, touched_entities, deferred_new_keys,
  refreshes, touched_buckets, skipped_buckets, refresh_solves,
  refresh_iterations, probe_entities, swap_refusals; the staleness_s
  gauge.
- ``ingest.*`` — chunks, rows, device_chunks (chunks uploaded by the
  streamed reads), chunks_skipped, python_fallback and
  native_unavailable (the native decoder's fallbacks), worker_chunks,
  worker_deaths, pool_starts, decode_seconds, staging_wait_seconds, the
  chunk cache's cache_hits / cache_misses / cache_builds /
  cache_commits / cache_chunks / cache_bytes / cache_invalid; the
  workers, staging_peak_depth and staging_peak_bytes gauges.
- ``stream.*`` — passes, chunk_uploads, stall_seconds,
  compute_seconds, stalled_passes, prefetch_widened,
  prefetch_narrowed; the prefetch_depth gauge.
- ``solver.*`` — iterations, evaluations, feature_streams,
  linesearch_trials, margin_cache.hits, margin_cache.refreshes,
  host_syncs (the lane L-BFGS's read-backs, also per site:
  ``host_syncs.lane_loop``, the loop's done flag, and
  ``host_syncs.lane_search``, the search's per-trial flag); the gauges
  of the last lane L-BFGS solve, lane.iterations (lock-step),
  lane.trials, lane.searching_lane_trials (lanes searching, summed over
  the trials), lane.lanes, lane.syncs, lane.sync_wait_s (host seconds
  inside the read-backs) and lane.wall_s; and retrace.new_signatures.
- ``score.*`` — the chunked scoring driver's chunks and rows.
- ``train.*`` gauges — dataset_estimate_bytes, hbm_budget_bytes, and
  the last `to_blocked_ell` build's layout.host_pass_s (its numpy host
  passes) and layout.device_s (its uploads and device scatter).
- ``serving.*`` — requests, batches, batch_rows, pad_waste,
  cold_misses, hot_swaps, quant_refusals, admitted, shed,
  deadline_expired, fleet_dispatches, fleet_failovers, fleet_degraded;
  the queue_depth, batch_fill, latency_p50_ms/p95/p99 and
  fleet_replicas gauges.
- ``game.*`` — sweeps, coordinate_updates, grid_points,
  grid_vectorized_lanes, validate_point.
- ``game_re.*`` — blocks, readback_wait_ns, straggler_entities,
  tail_resolves, iters_saved, slot_solves, lockstep_solves,
  capped_lockstep_iters, tail_lockstep_iters; the blocks_in_flight
  gauge.
- ``game_e2e.*`` — pod_scale_runs, streamed_fixed_updates,
  objective_chunks, host_offset_sums, score_stream_chunks,
  score_stream_rows, chunked_fit_points.
- ``eval.*`` — scatter_elems_saved.
- ``kernels.*`` — tile_measures (one per live candidate-tile timing)
  and tile_cache_hits (one per winner reused from the tile cache without
  measuring; `tuning/tile_tuner.py`).
- ``tuning.*`` — rounds, configs, survivor_resolves; the
  round_model_flops gauge.
- ``mesh.*`` — reductions (one per evaluation close, `parallel.mesh.
  psum`), collectives (one per cross-process gather), wire_bytes; and
  parallel.barrier_seconds.
- ``hbm.*`` gauges — bytes_in_use.max and peak_bytes_in_use.max, with
  per-tag suffixes.

Spans open under the families train, score, ingest, solve, game,
game_re, serving, checkpoint, continual, tuning and parallel. Named ones
(`TELEMETRY_REGISTRY['spans']`):

- the lane L-BFGS (`optim/lane_lbfgs.py`): solve.lane_lbfgs (attrs n,
  d, G, history_dtype) around the solve; solve.lane_lbfgs.iter around
  each lock-step iteration, and in it solve.lane_lbfgs.direction (the
  two-loop and the d·g check), solve.lane_lbfgs.matvec (the dz X pass),
  solve.lane_lbfgs.linesearch with one solve.lane_lbfgs.trial per φ,
  solve.lane_lbfgs.rmatvec (the gradient X pass, and the margin refresh
  every 64 iterations) and solve.lane_lbfgs.push (the history update);
  solve.lane_lbfgs.sync around each one-flag read-back;
- the layout build (`data/matrix.py::to_blocked_ell`): train.layout,
  and in it the host passes train.layout.split (the hot/cold split),
  train.layout.buckets (the occurrence buckets) and train.layout.ladder
  (the tail width ladder), and the device work train.layout.hot_block
  (the hot block's scatter) and train.layout.upload.

With no run attached, a span is nothing, unless torch's profiler is
collecting: then it is a bare `torch.profiler.record_function` under its
name, so a profiled region shows the program's spans on the device
events' clock, run or no run. The timeline's names differ between the
two: with no run, a span's own name (``solve.lane_lbfgs.iter``); with a
run, its path of enclosing spans
(``solve.lane_lbfgs/solve.lane_lbfgs.iter``).

The reference's ``game_re.fused_gate_offs`` (its fused one-program
update's gate, ROADMAP queue A item 6) has no emitter in the port and is
not registered; its ``ingest.device_shards`` is the port's
``ingest.device_chunks``.

The multi-process spine's ``parallel.barrier_wait`` span, opened by
`parallel/mesh.py::cluster_barrier`, is what `telemetry.aggregate` reads
to name the straggler rank.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.autograd import profiler as _profiler

from photon_tpu_torch.telemetry.run import Run, Span  # noqa: F401
from photon_tpu_torch.telemetry.sinks import (  # noqa: F401
    load_report,
    read_jsonl,
    repair_jsonl_tail,
)
from photon_tpu_torch.telemetry.taps import (  # noqa: F401
    set_resident_tap,
    solver_tap,
    tap_disabled,
    tap_enabled,
)

__all__ = [
    "Run", "Span", "read_jsonl", "load_report", "repair_jsonl_tail",
    "start_run", "finish_run", "run", "current_run", "enabled",
    "span", "count", "gauge", "gauge_max", "iteration", "event",
    "record_signature", "sample_device_memory", "snapshot", "reset",
    "REGISTRY", "TELEMETRY_REGISTRY",
    "solver_tap", "tap_enabled", "set_resident_tap", "tap_disabled",
]


class Registry:
    """The always-on process-wide counter/gauge registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        """A peak gauge: keeps the largest value set since the reset."""
        with self._lock:
            old = self._gauges.get(name)
            self._gauges[name] = value if old is None else max(old, value)

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


REGISTRY = Registry()
_CURRENT: Optional[Run] = None
_ATTACH_LOCK = threading.Lock()


def snapshot() -> dict:
    """The always-on registry's counters and gauges."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Clear the always-on registry (an attached run keeps its own)."""
    REGISTRY.reset()


# ------------------------------------------------------------- run lifecycle
def start_run(name: str = "run", jsonl_path: Optional[str] = None,
              resident_tap: bool = False, logger=None,
              append: bool = False) -> Run:
    """Create a Run and attach it as the process-wide current run. One run
    at a time: starting while one is attached finishes the old one first."""
    global _CURRENT
    # construct (and close the displaced run) outside the attach lock:
    # file IO a concurrent counter bump must never wait behind
    r = Run(name=name, jsonl_path=jsonl_path, resident_tap=resident_tap,
            logger=logger, append=append)
    with _ATTACH_LOCK:
        old, _CURRENT = _CURRENT, r
        set_resident_tap(resident_tap)
    if old is not None:
        old.close()
    return r


def finish_run() -> Optional[dict]:
    """Close and detach the current run; returns its final report."""
    global _CURRENT
    with _ATTACH_LOCK:
        r, _CURRENT = _CURRENT, None
        set_resident_tap(False)
    return r.close() if r is not None else None


@contextlib.contextmanager
def run(name: str = "run", jsonl_path: Optional[str] = None,
        resident_tap: bool = False, logger=None, append: bool = False):
    """`with telemetry.run(...) as r:` — start_run/finish_run scoped."""
    r = start_run(name, jsonl_path=jsonl_path, resident_tap=resident_tap,
                  logger=logger, append=append)
    try:
        yield r
    finally:
        if _CURRENT is r:
            finish_run()
        else:  # someone else already replaced it; still close ours
            r.close()


def current_run() -> Optional[Run]:
    return _CURRENT


def enabled() -> bool:
    return _CURRENT is not None


# ----------------------------------------------------- hot-path entry points
# Spans, iterations, events, signatures and memory samples are the ONE
# branch a run-less process pays (a span one more check: the profiler's
# flag); counters and gauges also feed REGISTRY.

class _NullSpan:
    """Shared no-op span context manager for the disabled state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    r = _CURRENT
    if r is None:
        if _profiler._is_profiler_enabled:
            return _profiler.record_function(name)
        return _NULL_SPAN
    return r.span(name, **attrs)


def count(name: str, value: float = 1.0) -> None:
    REGISTRY.count(name, value)
    r = _CURRENT
    if r is not None:
        r.count(name, value)


def gauge(name: str, value) -> None:
    REGISTRY.gauge(name, value)
    r = _CURRENT
    if r is not None:
        r.gauge(name, value)


def gauge_max(name: str, value) -> None:
    REGISTRY.gauge_max(name, value)
    r = _CURRENT
    if r is not None:
        r.gauge_max(name, value)


def iteration(solver: str, it: int, loss, grad_norm=None, step=None,
              trials=None, **extra) -> None:
    r = _CURRENT
    if r is not None:
        r.iteration(solver, it, loss, grad_norm=grad_norm, step=step,
                    trials=trials, **extra)


def event(kind: str, **fields) -> None:
    r = _CURRENT
    if r is not None:
        r.event(kind, **fields)


def record_signature(program: str, args) -> None:
    r = _CURRENT
    if r is not None:
        r.record_signature(program, args)


def sample_device_memory(tag: str = "") -> None:
    r = _CURRENT
    if r is not None:
        r.sample_device_memory(tag)


# The machine-readable name registry: the reference's names the port
# emits, plus the port's own (``mesh.*``, ``parallel.barrier_seconds``,
# the ingest plane's staging/pool/decode names, the GAME lock-step
# counters). Entries ending in ".*" / "_*" are prefix globs for
# dynamically suffixed names; `span_families` lists the allowed prefix
# (before the first dot) of every `telemetry.span(...)` name, and
# `spans` the span names the benchmark's readers and PERF.md name.
TELEMETRY_REGISTRY = {
    "counters": (
        "faults.injected_kills", "faults.injected_errors",
        "faults.io_retries", "faults.io_retries.*",
        "faults.backoff_seconds",
        "checkpoint.snapshots", "checkpoint.bytes", "checkpoint.restores",
        "checkpoint.scope_restores", "checkpoint.solver_restores",
        "checkpoint.re_restores", "checkpoint.descent_restores",
        "checkpoint.gc_snapshots", "checkpoint.pack_seconds",
        "checkpoint.commit_seconds",
        "continual.plans", "continual.touched_entities",
        "continual.deferred_new_keys", "continual.refreshes",
        "continual.touched_buckets", "continual.skipped_buckets",
        "continual.refresh_solves", "continual.refresh_iterations",
        "continual.probe_entities", "continual.swap_refusals",
        "ingest.chunks", "ingest.rows", "ingest.device_chunks",
        "ingest.chunks_skipped", "ingest.python_fallback",
        "ingest.native_unavailable",
        "ingest.worker_chunks", "ingest.worker_deaths",
        "ingest.pool_starts", "ingest.decode_seconds",
        "ingest.staging_wait_seconds",
        "ingest.cache_hits", "ingest.cache_misses", "ingest.cache_builds",
        "ingest.cache_commits", "ingest.cache_chunks",
        "ingest.cache_bytes", "ingest.cache_invalid",
        "stream.passes", "stream.chunk_uploads", "stream.stall_seconds",
        "stream.compute_seconds", "stream.stalled_passes",
        "stream.prefetch_widened", "stream.prefetch_narrowed",
        "solver.iterations", "solver.evaluations",
        "solver.feature_streams", "solver.linesearch_trials",
        "solver.margin_cache.hits", "solver.margin_cache.refreshes",
        "solver.host_syncs", "solver.host_syncs.*",
        "retrace.new_signatures",
        "score.chunks", "score.rows",
        "serving.requests", "serving.batches", "serving.batch_rows",
        "serving.pad_waste", "serving.cold_misses", "serving.hot_swaps",
        "serving.quant_refusals", "serving.admitted", "serving.shed",
        "serving.deadline_expired", "serving.fleet_dispatches",
        "serving.fleet_failovers", "serving.fleet_degraded",
        "game.sweeps", "game.coordinate_updates", "game.grid_points",
        "game.grid_vectorized_lanes", "game.validate_point",
        "game_re.blocks", "game_re.readback_wait_ns",
        "game_re.straggler_entities", "game_re.tail_resolves",
        "game_re.iters_saved", "game_re.slot_solves",
        "game_re.lockstep_solves", "game_re.capped_lockstep_iters",
        "game_re.tail_lockstep_iters",
        "game_e2e.pod_scale_runs", "game_e2e.streamed_fixed_updates",
        "game_e2e.objective_chunks",
        "game_e2e.host_offset_sums", "game_e2e.score_stream_chunks",
        "game_e2e.score_stream_rows", "game_e2e.chunked_fit_points",
        "eval.scatter_elems_saved",
        "tuning.rounds", "tuning.configs", "tuning.survivor_resolves",
        "kernels.tile_measures", "kernels.tile_cache_hits",
        "mesh.reductions", "mesh.collectives", "mesh.wire_bytes",
        "parallel.barrier_seconds",
    ),
    "gauges": (
        "stream.prefetch_depth", "ingest.workers",
        "ingest.staging_peak_depth", "ingest.staging_peak_bytes",
        "train.dataset_estimate_bytes", "train.hbm_budget_bytes",
        "train.layout.host_pass_s", "train.layout.device_s",
        "solver.lane.iterations", "solver.lane.trials",
        "solver.lane.searching_lane_trials", "solver.lane.lanes",
        "solver.lane.syncs", "solver.lane.sync_wait_s",
        "solver.lane.wall_s",
        "game_re.blocks_in_flight",
        "serving.queue_depth", "serving.batch_fill",
        "serving.latency_*", "serving.fleet_replicas",
        "hbm.bytes_in_use.max*", "hbm.peak_bytes_in_use.max*",
        "tuning.round_model_flops",
        "continual.staleness_s",
    ),
    "span_families": (
        "train", "score", "ingest", "solve",
        "game", "game_re", "serving", "checkpoint", "continual",
        "tuning", "parallel",
    ),
    "spans": (
        "solve.lane_lbfgs", "solve.lane_lbfgs.iter",
        "solve.lane_lbfgs.direction", "solve.lane_lbfgs.matvec",
        "solve.lane_lbfgs.linesearch", "solve.lane_lbfgs.trial",
        "solve.lane_lbfgs.rmatvec", "solve.lane_lbfgs.push",
        "solve.lane_lbfgs.sync",
        "train.layout", "train.layout.split", "train.layout.buckets",
        "train.layout.ladder", "train.layout.hot_block",
        "train.layout.upload",
    ),
}
