"""A minimal process-wide counter/gauge registry (the part of
`photon_tpu/telemetry` the serving path reports through).

The reference records into an opt-in run object; here the registry is
always on and costs one lock per update. ``snapshot()`` reads it,
``reset()`` clears it. Names follow the reference's ``serving.*`` family.
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


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
