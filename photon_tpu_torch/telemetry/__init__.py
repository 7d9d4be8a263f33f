"""A minimal process-wide counter/gauge registry (the part of
`photon_tpu/telemetry` the serving path reports through).

The reference records into an opt-in run object; here the registry is
always on and costs one lock per update. ``snapshot()`` reads it,
``reset()`` clears it. Names follow the reference's ``serving.*`` family.
`span`, `event` and `sample_device_memory` are the reference's calls with
no run attached: they record nothing (run objects wait for ROADMAP
queue A item 11).
"""
from __future__ import annotations

import threading


class Registry:
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


def count(name: str, value: float = 1.0) -> None:
    REGISTRY.count(name, value)


def gauge(name: str, value) -> None:
    REGISTRY.gauge(name, value)


def gauge_max(name: str, value) -> None:
    REGISTRY.gauge_max(name, value)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


class _NullSpan:
    """The no-op span context manager (no run attached)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    return _NULL_SPAN


def event(kind: str, **fields) -> None:
    return None


def sample_device_memory(tag: str = "") -> None:
    return None
