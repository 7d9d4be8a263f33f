"""What the benchmark reads from the card: profiler traces (device busy
time, per-kernel device time, idle gaps named by the host's work) and the
count of host-device synchronizations.

`device_events` is the reader of ``chip_smoke.py`` (``device_events``,
``profiled_busy``), frozen here; `count_syncs` is the CUDA branch of
``photon_tpu_torch/utils/profiling.py::count_syncs``, frozen here.
"""
from __future__ import annotations

import contextlib
import heapq
import warnings

import torch

TOP = 10  # entries of each breakdown list
NAME = 160  # characters of a name kept in a breakdown (templates run long)


def _events(prof):
    # the raw trace: the profiler's own event objects take ~0.1 ms each to
    # build on the host (chip_smoke.py's finding)
    return prof.profiler.kineto_results.events()


def device_events(prof) -> list:
    """[(name, start_ns, end_ns)] of every device op (kernel, copy, set);
    a span's image on the device timeline is no op."""
    out = []
    for ev in _events(prof):
        if (str(ev.device_type()).endswith("CUDA")
                and not ev.is_user_annotation()):
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def host_events(prof) -> list:
    """[(name, start_ns, end_ns)] of every host op and span."""
    out = []
    for ev in _events(prof):
        if str(ev.device_type()).endswith("CPU"):
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def union(intervals: list) -> list:
    """The union of [(start, end)] as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_trace(prof, window_s: float) -> dict:
    """Busy seconds (the union of device intervals), per-kernel device
    seconds and launches, the device ops that took most time and the idle
    gaps between device work summed by what the host was doing then (the
    innermost host op or span running at the gap's middle)."""
    dev = device_events(prof)
    busy = union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    kernels: dict = {}
    for name, s, e in dev:
        t, n = kernels.get(name, (0.0, 0))
        kernels[name] = (t + (e - s) / 1e9, n + 1)
    top_ops = sorted(((k, v[0]) for k, v in kernels.items()),
                     key=lambda kv: -kv[1])[:TOP]
    host = sorted(host_events(prof), key=lambda h: h[1])
    gaps: dict = {}
    active: list = []  # heap of (duration, end, name) of started host ops
    i = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        while i < len(host) and host[i][1] <= mid:
            name, s, e = host[i]
            heapq.heappush(active, (e - s, e, name))
            i += 1
        while active and active[0][1] < mid:  # ended before this gap
            heapq.heappop(active)
        label = active[0][2] if active else "(no host op)"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_s, window_s=window_s, kernels=kernels,
                device_ops=[[k[:NAME], v] for k, v in top_ops],
                idle_gaps=[[k[:NAME], v] for k, v in top_gaps])


def kernel_time(trace: dict, symbol: str) -> tuple:
    """(device seconds, launches) of the kernels whose name holds
    ``symbol``."""
    t = n = 0
    for name, (s, k) in trace["kernels"].items():
        if symbol in name:
            t, n = t + s, n + k
    return t, n


@contextlib.contextmanager
def count_syncs():
    """Count the host-device synchronizations made inside the block by the
    card's sync debug mode; yields a dict whose ``"n"`` holds the count
    and ``"sites"`` the count by file and line once the block ends."""
    out = {"n": 0, "sites": {}}
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    out["n"] = len(syncs)
    for w in syncs:
        key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
        out["sites"][key] = out["sites"].get(key, 0) + 1
