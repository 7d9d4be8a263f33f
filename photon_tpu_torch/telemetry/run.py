"""The `Run` recorder: one process-wide telemetry spine for a training or
scoring run (port of `photon_tpu/telemetry/run.py`).

Three primitives, as the reference's:

- **spans** — nestable host-side timed scopes (`time.perf_counter_ns`).
  Every span also enters `torch.profiler.record_function` under its path,
  so a `utils.profiling.trace` timeline shows it over the device ops it
  launched, and pushes an NVTX range when CUDA is up. Spans exist only
  while a run is attached, so a run-less serving flush pays neither.
  `utils.timing.Timer`/`PhaseTimers` feed spans automatically.
- **counters / gauges** — monotonic totals and last-value gauges;
  thread-safe.
- **iteration stream** — one event per solver iteration (loss,
  grad_norm, step, line-search trials), from the streamed/mesh host
  loops and the GAME descent, and from the resident solvers while the
  tap is armed (`telemetry.taps`).

Sinks: the in-memory `Run.report()` dict, an optional JSONL event file
(`telemetry.sinks`; the reference's record types and keys), and a human
end-of-run summary through `photon_logger` at `Run.close()`.

Torch counterparts of the reference's JAX parts: the XProf
`TraceAnnotation` is `record_function` (+ NVTX); the per-device HBM stats
are `torch.cuda.memory_stats` / `max_memory_allocated` of each CUDA
device (nothing on a process that never initialised CUDA, as the
reference's CPU backend reports nothing); the jaxpr signature log is a
host-side set of argument structures, shapes and dtypes per program (a
new one counts on ``retrace.new_signatures``; torch has no weak types,
so the report's ``weak_type_hazards`` list stays empty).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Run", "Span", "SignatureLog", "signature"]


@dataclasses.dataclass
class Span:
    """One completed (or still-open) timed scope."""

    name: str
    path: str  # "/"-joined enclosing span names + own name
    start_ns: int
    end_ns: Optional[int] = None
    depth: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    error: Optional[str] = None  # exception type name, when one escaped

    @property
    def seconds(self) -> float:
        end = (self.end_ns if self.end_ns is not None
               else time.perf_counter_ns())
        return (end - self.start_ns) / 1e9

    def to_json(self) -> dict:
        out = {"type": "span", "name": self.name, "path": self.path,
               "seconds": round(self.seconds, 6), "depth": self.depth}
        if self.attrs:
            out["attrs"] = self.attrs
        if self.error:
            out["error"] = self.error
        return out


_NVTX: list = []  # [bool] once known: is CUDA available for NVTX ranges


def _nvtx_on() -> bool:
    if not _NVTX:
        _NVTX.append(torch.cuda.is_available())
    return _NVTX[0]


class _SpanCM:
    """The span context manager: exception-safe, nestable, and entering a
    `torch.profiler.record_function` (+ an NVTX range on CUDA) so spans
    land on profiler timelines too."""

    __slots__ = ("_run", "_rec", "_ann", "_nvtx")

    def __init__(self, run: "Run", name: str, attrs: dict):
        self._run = run
        stack = run._span_stack()
        parent = stack[-1] if stack else None
        path = (parent.path + "/" + name) if parent is not None else name
        self._rec = Span(name=name, path=path,
                         start_ns=time.perf_counter_ns(),
                         depth=len(stack), attrs=attrs)
        self._ann = None
        self._nvtx = False

    def __enter__(self) -> Span:
        self._run._span_stack().append(self._rec)
        self._ann = torch.profiler.record_function(self._rec.path)
        self._ann.__enter__()
        if _nvtx_on():
            torch.cuda.nvtx.range_push(self._rec.path)
            self._nvtx = True
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._ann.__exit__(exc_type, exc, tb)
        rec = self._rec
        rec.end_ns = time.perf_counter_ns()
        if exc_type is not None:
            rec.error = exc_type.__name__
        stack = self._run._span_stack()
        # pop defensively: a mis-nested manual start/stop (Timer misuse)
        # must corrupt at most its own record, never the whole stack
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        self._run._record_span(rec)


def signature(tree) -> tuple:
    """Hashable (structure, shapes, dtypes) signature of a program's
    arguments: tensors and arrays by shape, dtype (and a tensor's device
    type), containers and dataclasses by their fields, ints, bools and
    strings by value, any other leaf (a float, an object) by its type
    only — a new float value does not make a new program."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), str(tree.dtype),
                tree.device.type)
    if isinstance(tree, np.ndarray):
        return ("array", tuple(tree.shape), str(tree.dtype))
    if tree is None or isinstance(tree, (bool, int, str)):
        return (tree,)
    if isinstance(tree, dict):
        return ("dict",) + tuple((str(k), signature(tree[k]))
                                 for k in sorted(tree, key=str))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(signature(t) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,) + tuple(
            (f.name, signature(getattr(tree, f.name)))
            for f in dataclasses.fields(tree)
            if not callable(getattr(tree, f.name)))
    return (type(tree).__name__,)


def float_drift(sig) -> list:
    """The floating dtypes other than f32 among the tensors and arrays of
    a `signature` (the counterpart of the reference's weak-type check)."""
    if isinstance(sig, tuple) and sig[:1] in (("tensor",), ("array",)):
        dt = sig[2]
        return [dt] if "float" in dt and dt not in ("torch.float32",
                                                    "float32") else []
    if isinstance(sig, tuple):
        return [d for s in sig for d in float_drift(s)]
    return []


class SignatureLog:
    """Thread-safe record of the distinct argument signatures per program
    name (the port's counterpart of the reference's TraceSignatureLog):
    the serving ladder's, the continual refresh's and a run's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: dict = {}

    def record(self, name: str, args) -> bool:
        """Record ``args``' signature under ``name``; True when it is new."""
        sig = signature(args)
        with self._lock:
            bucket = self._seen.setdefault(name, [])
            if sig in bucket:
                return False
            bucket.append(sig)
            return True

    def signatures(self, name: str) -> list:
        with self._lock:
            return list(self._seen.get(name, []))

    def programs(self) -> int:
        with self._lock:
            return len(self._seen)


class Run:
    """One run's telemetry state. Construct directly for an unattached
    recorder, or via `telemetry.start_run()` to make it the process-wide
    current run the instrumented hot paths report into."""

    def __init__(self, name: str = "run", jsonl_path: Optional[str] = None,
                 resident_tap: bool = False, logger=None,
                 keep_iterations: int = 100_000, append: bool = False):
        self.name = name
        self.resident_tap = bool(resident_tap)
        self.started_unix = time.time()
        self._t0_ns = time.perf_counter_ns()
        self._end_ns: Optional[int] = None
        self._lock = threading.Lock()
        # the JSONL sink gets its OWN lock: serializing file writes under
        # _lock would stall every counter bump from the serving threads
        # behind disk latency
        self._emit_lock = threading.Lock()
        self._tls = threading.local()
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, Any] = {}
        self.iterations: list[dict] = []
        self._iter_cap = int(keep_iterations)
        self._n_iter_events = 0
        self._logger = logger
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self._closed = False
        self.signature_log = SignatureLog()
        if jsonl_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            if append:
                # a resumed run continues the dead run's event log: first
                # truncate a crash-torn final record, then reopen
                from photon_tpu_torch.telemetry.sinks import \
                    repair_jsonl_tail

                repair_jsonl_tail(jsonl_path)
            self._jsonl_file = open(jsonl_path, "a" if append else "w")
        self._emit({"type": "run_start", "name": name,
                    "started_unix": self.started_unix})

    # ------------------------------------------------------------ plumbing
    def _span_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, obj: dict) -> None:
        if self._jsonl_file is None:
            return
        with self._emit_lock:
            f = self._jsonl_file
            if f is None:  # closed concurrently
                return
            # photon: allow(blocking_under_lock, _emit_lock exists to serialize exactly this one-line write — it guards no other state, so nothing can deadlock or stall behind it)
            json.dump(obj, f)
            f.write("\n")

    def _record_span(self, rec: Span) -> None:
        with self._lock:
            self.spans.append(rec)
        j = rec.to_json()
        # run-relative start offset: telemetry.aggregate places the span
        # on a wall clock as run_start.started_unix + t_s
        j["t_s"] = round((rec.start_ns - self._t0_ns) / 1e9, 6)
        self._emit(j)

    # ------------------------------------------------------------- primitives
    def span(self, name: str, **attrs) -> _SpanCM:
        return _SpanCM(self, name, attrs)

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        """A peak gauge: keeps the largest value set during the run."""
        with self._lock:
            old = self.gauges.get(name)
            self.gauges[name] = value if old is None else max(old, value)

    def iteration(self, solver: str, it: int, loss, grad_norm=None,
                  step=None, trials=None, **extra) -> None:
        """One live solver-iteration event. Scalars coerce to host floats
        so the JSONL stream never carries tensors."""
        ev = {"type": "iteration", "solver": solver, "it": int(it),
              "loss": _scalar(loss)}
        if grad_norm is not None:
            ev["grad_norm"] = _scalar(grad_norm)
        if step is not None:
            ev["step"] = _scalar(step)
        if trials is not None:
            ev["trials"] = int(trials)
        for k, v in extra.items():
            ev[k] = _scalar(v)
        with self._lock:
            self._n_iter_events += 1
            if len(self.iterations) < self._iter_cap:
                self.iterations.append(ev)
        self._emit(ev)

    def event(self, kind: str, **fields) -> None:
        """A one-off structured event (JSONL only; not an iteration)."""
        ev = {"type": kind}
        for k, v in fields.items():
            ev[k] = _scalar(v)
        self._emit(ev)

    def record_signature(self, program: str, args) -> None:
        """Dynamic program accounting: a NEW argument signature for
        ``program`` counts on ``retrace.new_signatures``."""
        if self.signature_log.record(program, args):
            self.count("retrace.new_signatures")

    def sample_device_memory(self, tag: str = "") -> None:
        """Device-memory watermark gauges over this process's CUDA devices
        (``hbm.bytes_in_use.max`` = the largest allocated bytes now,
        ``hbm.peak_bytes_in_use.max`` = the largest peak since the last
        `torch.cuda.reset_peak_memory_stats`). Nothing on a process that
        never initialised CUDA."""
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        in_use, peak = [], []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            in_use.append(int(stats.get("allocated_bytes.all.current", 0)))
            peak.append(int(torch.cuda.max_memory_allocated(i)))
        suffix = f".{tag}" if tag else ""
        if in_use:
            self.gauge(f"hbm.bytes_in_use.max{suffix}", max(in_use))
            self.gauge(f"hbm.peak_bytes_in_use.max{suffix}", max(peak))

    # ---------------------------------------------------------------- sinks
    def duration_s(self) -> float:
        end = self._end_ns if self._end_ns is not None \
            else time.perf_counter_ns()
        return (end - self._t0_ns) / 1e9

    def span_totals(self) -> dict[str, float]:
        """Total seconds per span path (the PhaseTimers.summary analog)."""
        with self._lock:
            spans = list(self.spans)
        totals: dict[str, float] = {}
        for s in spans:
            totals[s.path] = totals.get(s.path, 0.0) + s.seconds
        return {k: round(v, 6) for k, v in sorted(totals.items())}

    def report(self) -> dict:
        """The in-memory run report — everything the JSONL stream carries,
        as one dict."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            spans = [s.to_json() for s in self.spans]
            iterations = list(self.iterations)
            n_iter = self._n_iter_events
        return {
            "name": self.name,
            "started_unix": self.started_unix,
            "duration_s": round(self.duration_s(), 6),
            "spans": spans,
            "span_totals": self.span_totals(),
            "counters": counters,
            "gauges": gauges,
            "iterations": iterations,
            "n_iteration_events": n_iter,
            "retrace": {"programs": self.signature_log.programs(),
                        "weak_type_hazards": []},
        }

    def report_compact(self) -> dict:
        """Counters + span totals + duration: the piece small enough to
        embed in a one-line JSON."""
        with self._lock:
            counters = {k: round(v, 6) for k, v in
                        sorted(self.counters.items())}
            gauges = dict(sorted(self.gauges.items()))
            n_iter = self._n_iter_events
        return {"duration_s": round(self.duration_s(), 3),
                "counters": counters, "gauges": gauges,
                "span_totals": self.span_totals(),
                "n_iteration_events": n_iter}

    def summary_lines(self) -> list[str]:
        """The human end-of-run summary photon_logger prints at close()."""
        lines = [f"run '{self.name}': {self.duration_s():.3f}s, "
                 f"{len(self.spans)} span(s), "
                 f"{self._n_iter_events} iteration event(s)"]
        totals = self.span_totals()
        if totals:
            top = sorted(totals.items(), key=lambda kv: -kv[1])[:8]
            lines.append("  time: " + ", ".join(
                f"{k}={v:.3f}s" for k, v in top))
        with self._lock:
            counters = sorted(self.counters.items())
        if counters:
            lines.append("  counters: " + ", ".join(
                f"{k}={v:g}" for k, v in counters))
        return lines

    def close(self) -> dict:
        """Finalize: stamp the end time, snapshot counters/gauges into the
        JSONL stream, log the human summary, close the file. Idempotent;
        returns the final report."""
        if self._closed:
            return self.report()
        self._closed = True
        self._end_ns = time.perf_counter_ns()
        self.sample_device_memory("final")
        with self._lock:
            snapshot = {"type": "run_end",
                        "duration_s": round(self.duration_s(), 6),
                        "counters": dict(self.counters),
                        "gauges": dict(self.gauges),
                        "n_iteration_events": self._n_iter_events}
        self._emit(snapshot)
        log = self._logger
        if log is None:
            from photon_tpu_torch.utils.logging import photon_logger

            log = photon_logger("photon_tpu_torch.telemetry")
        for line in self.summary_lines():
            log.info("%s", line)
        with self._emit_lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None
        return self.report()


def _scalar(v):
    """Host-scalar coercion: 0-d tensors/arrays -> Python numbers, small
    ones -> lists, strings/bools pass through."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.tolist()
    try:
        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        return a.tolist()
    except Exception:
        return repr(v)
