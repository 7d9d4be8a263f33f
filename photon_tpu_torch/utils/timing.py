"""Timing utilities (the port's copy of `photon_tpu/utils/timing.py`).

Reference parity: com.linkedin.photon.ml.util.Timer — a start/stop timer the
drivers wrap around each training phase, plus a `Timed` context manager and a
per-phase accumulator for the driver's end-of-run summary.

Telemetry integration: a Timer constructed WITH a name opens a
`photon_tpu_torch.telemetry` span for each start/stop interval (a no-op
with no run attached). `PhaseTimers(span_prefix="train.")` names its
spans ``train.<phase>``. A bare `Timer()` stays a pure stopwatch.
"""
from __future__ import annotations

import time
from typing import Optional

from photon_tpu_torch import telemetry


class Timer:
    """Reference: util.Timer (start/stop/durationSeconds)."""

    def __init__(self, span_name: Optional[str] = None):
        self._t0: Optional[float] = None
        self._elapsed: float = 0.0
        self._span_name = span_name
        self._span_cm = None

    def start(self) -> "Timer":
        if self._t0 is not None:
            raise RuntimeError("timer already running")
        self._t0 = time.perf_counter()
        if self._span_name is not None:
            self._span_cm = telemetry.span(self._span_name)
            self._span_cm.__enter__()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("timer not running")
        self._elapsed += time.perf_counter() - self._t0
        self._t0 = None
        if self._span_cm is not None:
            cm, self._span_cm = self._span_cm, None
            cm.__exit__(None, None, None)
        return self._elapsed

    @property
    def seconds(self) -> float:
        if self._t0 is not None:
            return self._elapsed + (time.perf_counter() - self._t0)
        return self._elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        # close the span with the exception info (exception-safe spans),
        # then stop the stopwatch
        if self._span_cm is not None:
            cm, self._span_cm = self._span_cm, None
            cm.__exit__(exc_type, exc, tb)
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None


class PhaseTimers:
    """Named phase accumulator (the driver's 'timed { ... }' blocks)."""

    def __init__(self, span_prefix: str = ""):
        self.timers: dict[str, Timer] = {}
        self._prefix = span_prefix

    def __call__(self, name: str) -> Timer:
        return self.timers.setdefault(name, Timer(self._prefix + name))

    def summary(self) -> dict[str, float]:
        return {k: t.seconds for k, t in self.timers.items()}
