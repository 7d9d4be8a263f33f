"""The performance attribution ledger (port of
`photon_tpu/profiling/ledger.py`): joins each program's STATIC cost
(`profiling.model`: `chunk_cost`, `lane_grid_cost`) with the RUNTIME
seconds the hot paths measure, so a run can answer "what fraction of its
roofline did each program reach, and where did the first-call time go".

One process-wide `Ledger` is attached by `start_ledger()` / `ledger(...)`
(the `telemetry.Run` pattern). Every module-level entry point below
(``measure``/``attribute``/``note_program``/``needs_note``/``dispatch``/
``record_signature``/``sample_hbm``) begins with one global load and one
branch, so a process with no ledger pays nothing more; armed or not, the
ledger adds no device synchronization and no launch (held with
`utils.profiling.count_syncs`, the counterpart of the reference's
``ledger_off_is_free`` jaxpr contract).

Three accounts:

- **Attribution**: measured wall seconds per (program, phase), from
  `measure(...)` regions that close at a read-back the hot path already
  makes (a streamed pass ends in a host read of its sums, so its wall is
  device time plus stream stalls). With the program's static FLOPs and
  bytes this gives achieved FLOP/s and bytes/s and a roofline share in
  (0, 1]: achieved over peak on whichever axis the program loads more,
  clamped at 1 (the model is an estimate). A region that ended before a
  read-back would time the launches only; none is placed so.
- **First calls**: what a program's first call pays once. The reference
  times make_jaxpr, lower and compile; a torch program has none of those
  (``trace_s`` and ``lower_s`` stay ``None``), and its first call pays
  instead the kernel library's first-use load (`kernels.load_library`,
  an nvcc build when ``_build/`` is cold: ``compile_s``) and the
  layout's work plan (`kernels.blocked_ell.layout_plan`: ``plan_s``),
  which `note_program(..., layout=X)` times on a CUDA layout (the
  reference's ``probe=True``). A `dispatch(...)` whose argument signature is new (riding
  `telemetry.run.SignatureLog`) books its wall as ``dispatch_compile_s``.
- **Device memory**: `sample_hbm(phase)` records, per phase, the largest
  allocated bytes now and at peak over the ledger's CUDA devices
  (`torch.cuda.memory_stats`; the peak counter is never reset here). A
  CPU device records nothing, as the reference's CPU backend reports
  none.

Peaks are the device's own: ``PHOTON_TPU_PEAK_FLOPS`` /
``PHOTON_TPU_PEAK_BYTES_PER_S`` first, else a table keyed by the card's
name, else (on the CPU) the reference's CPU pair. A card not in the
table gets no peak, so its utilization is ``None``: the ledger never
guesses. The report's ``peaks_source`` says which.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import torch

from photon_tpu_torch.profiling.model import StaticCost
from photon_tpu_torch.telemetry.run import SignatureLog
from photon_tpu_torch.utils import env as env_knobs

__all__ = [
    "Ledger", "ProgramRecord", "start_ledger", "finish_ledger", "ledger",
    "current_ledger", "enabled", "measure", "attribute", "note_program",
    "needs_note", "dispatch", "record_signature", "sample_hbm",
    "ledger_disabled", "resolve_peaks",
]

# Per-device roofline ceilings (FLOP/s, bytes/s) by CUDA device name: the
# published f32 (non-tensor-core) rate and HBM rate of the part, the pair
# the port's kernel bounds divide by (PERF.md §6).
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": (6.7e13, 3.35e12),
}
# The reference's modeled CPU ceiling (a generous many-core host).
CPU_PEAKS = (1.0e11, 5.0e10)


def resolve_peaks(device=None) -> tuple:
    """(peak FLOP/s, peak bytes/s, source) for ``device`` (default: the
    current CUDA device when one is available, else the CPU): each env
    override first; else the card's `CARD_PEAKS` entry, or `CPU_PEAKS`
    on the CPU; a card not in the table gives None (no guess). ``source``
    names where each came from."""
    env_f = env_knobs.get_raw("PHOTON_TPU_PEAK_FLOPS")
    env_b = env_knobs.get_raw("PHOTON_TPU_PEAK_BYTES_PER_S")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        table = CARD_PEAKS.get(name)
        where = (f"table: {name}" if table is not None
                 else f"no table entry for {name}")
        table = table or (None, None)
    else:
        table, where = CPU_PEAKS, "cpu"
    flops = float(env_f) if env_f else table[0]
    bytes_ = float(env_b) if env_b else table[1]
    if env_f and env_b:
        source = "env"
    elif env_f or env_b:
        source = f"env and {where}"
    else:
        source = where
    return flops, bytes_, source


@dataclasses.dataclass
class ProgramRecord:
    """One program's static account and first-call costs. ``trace_s`` and
    ``lower_s`` have no torch meaning (no program is traced or lowered)
    and stay None; ``compile_s`` is the kernel library's first-use load
    and ``plan_s`` the layout plan's build, both from a probe; ``xla`` is
    always None (no compiled program to ask)."""

    name: str
    static: Optional[StaticCost] = None
    trace_s: Optional[float] = None
    lower_s: Optional[float] = None
    compile_s: Optional[float] = None
    plan_s: Optional[float] = None
    dispatch_compile_s: float = 0.0
    retraces: int = 0
    xla: Optional[dict] = None
    note_error: Optional[str] = None

    def first_call_s(self) -> float:
        return sum(v or 0.0 for v in (self.trace_s, self.lower_s,
                                      self.compile_s, self.plan_s,
                                      self.dispatch_compile_s))

    def to_json(self) -> dict:
        out = {"retraces": self.retraces}
        if self.static is not None:
            out["static"] = self.static.to_json()
        for k in ("trace_s", "lower_s", "compile_s", "plan_s",
                  "dispatch_compile_s"):
            v = getattr(self, k)
            if v:
                out[k] = round(v, 6)
        out["xla"] = self.xla
        if self.note_error:
            out["note_error"] = self.note_error
        return out


class _MeasureCM:
    """Times a block and attributes it to (program, phase); optionally
    books the elapsed wall as first-call time (new-signature dispatches)."""

    __slots__ = ("_ledger", "_program", "_phase", "_calls", "_compile",
                 "_t0")

    def __init__(self, ledger: "Ledger", program: str, phase: str,
                 calls: int, book_compile: bool):
        self._ledger = ledger
        self._program = program
        self._phase = phase
        self._calls = calls
        self._compile = book_compile
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        seconds = (time.perf_counter_ns() - self._t0) / 1e9
        self._ledger.attribute(self._program, self._phase, seconds,
                               calls=self._calls)
        if self._compile:
            self._ledger._book_dispatch_compile(self._program, seconds)


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL_CM = _NullCM()


class Ledger:
    """One run's attribution state. Construct directly for an unattached
    ledger, or via `start_ledger()` for the process-wide one the
    instrumented hot paths report into. ``devices``: the devices whose
    memory `sample_hbm` reads and whose peaks divide (default: the
    current CUDA device when one is available, else the CPU); ``peaks``:
    an explicit (FLOP/s, bytes/s) pair instead of `resolve_peaks`."""

    def __init__(self, name: str = "ledger", peaks: Optional[tuple] = None,
                 devices=None):
        if devices is None:
            devices = ["cuda" if torch.cuda.is_available() else "cpu"]
        elif isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        self.name = name
        if peaks is not None:
            self.peak_flops, self.peak_bytes = peaks
            self.peaks_source = "given"
        else:
            (self.peak_flops, self.peak_bytes,
             self.peaks_source) = resolve_peaks(self.devices[0])
        self._t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self.programs: dict[str, ProgramRecord] = {}
        # (program, phase) -> {"seconds", "calls"}
        self.attributions: dict[tuple, dict] = {}
        self.trace_log = SignatureLog()
        self.hbm: dict[str, dict] = {}  # phase -> watermark gauges

    # ------------------------------------------------------------ programs
    def _record(self, program: str) -> ProgramRecord:
        rec = self.programs.get(program)
        if rec is None:
            rec = self.programs[program] = ProgramRecord(program)
        return rec

    def note_program(self, program: str, cost: StaticCost, args=None,
                     layout=None) -> ProgramRecord:
        """Register ``program``'s static cost (once per name). ``args``:
        the program's arguments at the note, whose signature enters the
        signature account (the reference's note traces the program with
        them). With a CUDA `BlockedEllRows` ``layout`` (the probe), also
        time what the program's first call pays: the blocked-ELL kernel
        library's load (``compile_s``; near 0 once loaded) and the
        layout's plan (``plan_s``; near 0 once built) — work the first
        call would do anyway, so the probe adds none. A probe never takes
        a run down: a failure is recorded as ``note_error``."""
        with self._lock:
            rec = self._record(program)
            if rec.static is not None or rec.note_error is not None:
                return rec
            rec.static = cost
        if layout is not None:
            try:
                compile_s, plan_s = _probe_first_call(layout)
            except Exception as e:  # noqa: BLE001 — recorded, never raised
                with self._lock:
                    rec.note_error = f"{type(e).__name__}: {e}"
                return rec
            with self._lock:
                rec.compile_s, rec.plan_s = compile_s, plan_s
        if args is not None:
            self.record_signature(program, args)
        return rec

    def record_signature(self, program: str, args) -> bool:
        """Signature accounting: True iff ``args``' signature is new for
        ``program``."""
        new = self.trace_log.record(program, args)
        if new:
            with self._lock:
                self._record(program).retraces += 1
        return new

    def _book_dispatch_compile(self, program: str, seconds: float) -> None:
        with self._lock:
            self._record(program).dispatch_compile_s += seconds

    # --------------------------------------------------------- attribution
    def attribute(self, program: str, phase: str, seconds: float,
                  calls: int = 1) -> None:
        key = (program, phase)
        with self._lock:
            slot = self.attributions.get(key)
            if slot is None:
                slot = self.attributions[key] = {"seconds": 0.0, "calls": 0}
            slot["seconds"] += float(seconds)
            slot["calls"] += int(calls)

    def measure(self, program: str, phase: str, calls: int = 1) -> _MeasureCM:
        return _MeasureCM(self, program, phase, calls, False)

    def dispatch(self, program: str, args, phase: str = "dispatch"
                 ) -> _MeasureCM:
        """Measure one dispatch; a new argument signature books the
        elapsed wall as first-call time too. CUDA work is asynchronous:
        unless the region ends in a read-back, this is host dispatch wall
        (with any first-call build), not device time."""
        new = self.record_signature(program, args)
        return _MeasureCM(self, program, phase, 1, new)

    def sample_hbm(self, phase: str) -> None:
        """Per-phase device-memory watermarks over the ledger's CUDA
        devices (``bytes_in_use.max``: allocated bytes now;
        ``peak_bytes_in_use.max``: the allocator's peak since its last
        reset, which the ledger never does), as
        `telemetry.sample_device_memory`. Nothing on the CPU, or before
        CUDA is initialised."""
        cuda = [d for d in self.devices if d.type == "cuda"]
        if not cuda or not torch.cuda.is_initialized():
            return
        in_use, peak = [], []
        for d in cuda:
            stats = torch.cuda.memory_stats(d)
            in_use.append(int(stats.get("allocated_bytes.all.current", 0)))
            peak.append(int(stats.get("allocated_bytes.all.peak", 0)))
        with self._lock:
            slot = self.hbm.setdefault(phase, {})
            slot["bytes_in_use.max"] = max(
                max(in_use), slot.get("bytes_in_use.max", 0))
            slot["peak_bytes_in_use.max"] = max(
                max(peak), slot.get("peak_bytes_in_use.max", 0))

    # --------------------------------------------------------------- report
    def _entry(self, program: str, phase: str, slot: dict) -> dict:
        rec = self.programs.get(program)
        out = {"program": program, "phase": phase,
               "seconds": round(slot["seconds"], 6),
               "calls": slot["calls"]}
        static = rec.static if rec is not None else None
        if static is None or slot["seconds"] <= 0.0:
            return out
        total_flops = static.flops * slot["calls"]
        total_bytes = static.bytes * slot["calls"]
        out["flops_modeled"] = total_flops
        out["bytes_modeled"] = total_bytes
        out["achieved_flops_per_s"] = total_flops / slot["seconds"]
        out["achieved_bytes_per_s"] = total_bytes / slot["seconds"]
        if self.peak_flops is None or self.peak_bytes is None:
            out["utilization"] = None  # no peak for this device: no guess
        else:
            f_frac = (out["achieved_flops_per_s"] / self.peak_flops
                      if self.peak_flops > 0 else 0.0)
            b_frac = (out["achieved_bytes_per_s"] / self.peak_bytes
                      if self.peak_bytes > 0 else 0.0)
            util = max(f_frac, b_frac)
            if util > 0.0:
                # the binding axis's share, clamped into (0, 1]: the model
                # is a ceiling estimate, so >1 means it was loose
                out["utilization"] = min(util, 1.0)
                out["bound"] = ("bandwidth" if b_frac >= f_frac
                                else "compute")
        if static.collective_bytes:
            out["collective_bytes_modeled"] = (static.collective_bytes
                                               * slot["calls"])
        return out

    def duration_s(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e9

    def report(self) -> dict:
        """The whole ledger: attribution entries (most measured time
        first), per-program static and first-call accounts, the
        first-call share, device-memory watermarks, and retrace hazards
        (none: torch has no weak types, so no signature pair differs by a
        weak type alone)."""
        with self._lock:
            attrs = {k: dict(v) for k, v in self.attributions.items()}
            programs = dict(self.programs)
            hbm = {k: dict(v) for k, v in self.hbm.items()}
        entries = [self._entry(p, ph, slot)
                   for (p, ph), slot in attrs.items()]
        entries.sort(key=lambda e: -e["seconds"])
        measured = sum(e["seconds"] for e in entries)
        compile_s = sum(r.first_call_s() for r in programs.values())
        return {
            "name": self.name,
            "duration_s": round(self.duration_s(), 6),
            "peaks": {"flops_per_s": self.peak_flops,
                      "bytes_per_s": self.peak_bytes},
            "peaks_source": self.peaks_source,
            "attribution": entries,
            "programs": {n: r.to_json()
                         for n, r in sorted(programs.items())},
            "compile": {
                "wall_s": round(compile_s, 6),
                "retraces": sum(r.retraces for r in programs.values()),
                "share_of_measured": round(
                    compile_s / measured, 4) if measured > 0 else None,
            },
            "hbm": hbm,
            "retrace_hazards": [],
        }

    def summary_lines(self, top: int = 8) -> list[str]:
        rep = self.report()
        lines = [f"ledger '{self.name}': "
                 f"{len(rep['attribution'])} attribution entr(ies), "
                 f"{len(rep['programs'])} program(s), compile "
                 f"{rep['compile']['wall_s']:.3f}s"]
        for e in rep["attribution"][:top]:
            util = e.get("utilization")
            extra = ""
            if util is not None:
                extra = (f", {100.0 * util:.1f}% of roofline "
                         f"({e['bound']}-bound)")
            lines.append(f"  {e['program']} [{e['phase']}]: "
                         f"{e['seconds']:.3f}s / {e['calls']} call(s)"
                         + extra)
        return lines


def _probe_first_call(layout) -> tuple:
    """(library load s, plan build s) of a CUDA `BlockedEllRows` layout's
    first kernel call; (None, None) for any other matrix, where the first
    call loads and plans nothing."""
    from photon_tpu_torch.data.matrix import BlockedEllRows

    if not isinstance(layout, BlockedEllRows) or not layout.dense.is_cuda:
        return None, None
    from photon_tpu_torch.kernels import blocked_ell as KB

    t0 = time.perf_counter_ns()
    KB.library()
    t1 = time.perf_counter_ns()
    KB.layout_plan(layout)
    t2 = time.perf_counter_ns()
    return (t1 - t0) / 1e9, (t2 - t1) / 1e9


# ----------------------------------------------------- process-wide state
_CURRENT: Optional[Ledger] = None
_ATTACH_LOCK = threading.Lock()


def start_ledger(name: str = "ledger", peaks: Optional[tuple] = None,
                 devices=None) -> Ledger:
    """Attach a fresh process-wide Ledger (replacing any previous one),
    as `telemetry.start_run`."""
    global _CURRENT
    with _ATTACH_LOCK:
        led = Ledger(name=name, peaks=peaks, devices=devices)
        _CURRENT = led
    return led


def finish_ledger() -> Optional[dict]:
    """Detach the current ledger; returns its final report."""
    global _CURRENT
    with _ATTACH_LOCK:
        led, _CURRENT = _CURRENT, None
    return led.report() if led is not None else None


@contextlib.contextmanager
def ledger(name: str = "ledger", peaks: Optional[tuple] = None,
           devices=None):
    """``with profiling.ledger(...) as led:`` — scoped attach/detach."""
    led = start_ledger(name, peaks=peaks, devices=devices)
    try:
        yield led
    finally:
        global _CURRENT
        with _ATTACH_LOCK:
            if _CURRENT is led:
                _CURRENT = None


def current_ledger() -> Optional[Ledger]:
    return _CURRENT


def enabled() -> bool:
    return _CURRENT is not None


@contextlib.contextmanager
def ledger_disabled():
    """Force the ledger detached inside the block."""
    global _CURRENT
    with _ATTACH_LOCK:
        was, _CURRENT = _CURRENT, None
    try:
        yield
    finally:
        with _ATTACH_LOCK:
            _CURRENT = was


# ------------------------------------------------ hot-path entry points
# One module-global load + one branch each when no ledger is attached.

def measure(program: str, phase: str, calls: int = 1):
    led = _CURRENT
    if led is None:
        return _NULL_CM
    return led.measure(program, phase, calls=calls)


def attribute(program: str, phase: str, seconds: float,
              calls: int = 1) -> None:
    led = _CURRENT
    if led is not None:
        led.attribute(program, phase, seconds, calls=calls)


def note_program(program: str, cost: StaticCost, args=None,
                 layout=None) -> None:
    led = _CURRENT
    if led is not None:
        led.note_program(program, cost, args=args, layout=layout)


def needs_note(program: str) -> bool:
    """True iff a ledger is attached and ``program`` has no static cost
    yet: the guard hot paths use before pricing a program."""
    led = _CURRENT
    if led is None:
        return False
    rec = led.programs.get(program)
    return rec is None or (rec.static is None and rec.note_error is None)


def dispatch(program: str, args, phase: str = "dispatch"):
    led = _CURRENT
    if led is None:
        return _NULL_CM
    return led.dispatch(program, args, phase=phase)


def record_signature(program: str, args) -> None:
    led = _CURRENT
    if led is not None:
        led.record_signature(program, args)


def sample_hbm(phase: str) -> None:
    led = _CURRENT
    if led is not None:
        led.sample_hbm(phase)


# ----------------------------------------------------------------- contracts
# The ledger-off guarantee as law, the discipline of telemetry_off_is_free:
# the resident solve with the ledger detached makes no collective, and
# exactly the host syncs of the bare solver on the same problem.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import TRANSFER_PRIMITIVES  # noqa: E402


@register_contract(
    name="ledger_off_is_free",
    description="resident L-BFGS solve with the attribution ledger "
                "detached: zero collectives, host syncs equal to the bare "
                "solver's on the same problem — profiling adds nothing",
    collectives={}, forbid=TRANSFER_PRIMITIVES,
    # the 5-iteration L-BFGS's read-backs (ROADMAP speed item 1), pinned
    # so they can only fall; the bare solve's count is the equality
    max_syncs={"cuda": 20, "cpu": 6},
    tags=("resident", "profiling"))
def _contract_ledger_off_is_free(device):
    from photon_tpu_torch.models.training import (_contract_resident_problem,
                                                  solve)
    from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin

    cfg, obj, batch, w0 = _contract_resident_problem(device, 40, 6, 0)

    def fn(b, w, o):
        with ledger_disabled():
            return solve(o, b, w, cfg)

    def bare(b, w, o):
        return minimize_lbfgs_margin(o, b, w, max_iters=cfg.max_iters,
                                     tolerance=cfg.tolerance,
                                     history=cfg.history)

    return fn, (batch, w0, obj), bare
