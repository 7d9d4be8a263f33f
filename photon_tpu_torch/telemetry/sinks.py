"""JSONL sink helpers: the on-disk face of a `Run` (port of
`photon_tpu/telemetry/sinks.py`; the same record types and keys, so
either package reads the other's file).

The event file is line-delimited JSON, one object per line, written live
as events happen (so a crashed run still leaves its prefix — the same
property the reference gets from Spark's incremental event log). Record
types, discriminated by the ``type`` field:

- ``run_start``  — {name, started_unix}; always the first line.
- ``span``       — {name, path, seconds, depth, attrs?, error?}; written
                   at span EXIT (ordering is by completion, as in any
                   trace log — nest by ``path``).
- ``iteration``  — {solver, it, loss, grad_norm?, step?, trials?, ...};
                   the live per-iteration solver stream.
- ``run_end``    — {duration_s, counters, gauges, n_iteration_events};
                   the final counter/gauge snapshot. Missing when the
                   process died mid-run — readers must treat it as
                   optional.
- anything else  — one-off structured events (`Run.event`), e.g.
                   ``streamed_objective_resolution``.

Counters are NOT streamed per increment (a per-bump line would dominate
the file at chunk rates); they ride the ``run_end`` snapshot. Spans and
iterations are the incremental records.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Optional

__all__ = ["read_jsonl", "load_report", "repair_jsonl_tail"]


def read_jsonl(path: str, kind: Optional[str] = None) -> Iterator[dict]:
    """Iterate the event objects of a run's JSONL file; ``kind`` filters by
    the ``type`` field. Tolerates a truncated final line (a run killed
    mid-write) — everything before it is still served."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                return  # truncated tail from a dead run: stop, don't raise
            if kind is None or obj.get("type") == kind:
                yield obj


def repair_jsonl_tail(path: str) -> int:
    """Truncate a crash-torn FINAL record so the file is append-safe.

    A run killed mid-`_emit` leaves a partial last line. Readers already
    tolerate that (`read_jsonl` stops at the torn tail) — but a run
    REOPENED for append would write its next record onto the same line,
    corrupting one record boundary mid-file and silently hiding every
    event after it from `read_jsonl`. Called by `Run(append=True)` before
    the reopen: scans back from EOF, drops a trailing line that is
    missing its newline or is not valid JSON, and returns the number of
    bytes truncated (0 when the tail was clean). Complete records are
    never touched."""
    if not os.path.exists(path):
        return 0
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return 0
        # read the final partial-or-complete line (bounded back-scan)
        back = min(size, 1 << 20)
        f.seek(size - back)
        tail = f.read(back)
        nl = tail.rfind(b"\n")
        if nl == len(tail) - 1:
            # file ends on a newline: check the LAST complete line still
            # parses (a torn multi-byte write can include the newline)
            prev = tail[:-1].rfind(b"\n")
            last = tail[prev + 1:-1]
            try:
                json.loads(last.decode("utf-8"))
                return 0
            except (json.JSONDecodeError, UnicodeDecodeError):
                cut = size - (len(tail) - (prev + 1))
        else:
            cut = size - (len(tail) - (nl + 1))
        f.truncate(cut)
        return size - cut


def load_report(path: str) -> dict:
    """Reassemble a report-shaped dict from a JSONL event file (the
    offline counterpart of `Run.report()` for a run read back from disk)."""
    spans, iterations, events = [], [], []
    start: dict = {}
    end: dict = {}
    for obj in read_jsonl(path):
        t = obj.get("type")
        if t == "run_start":
            start = obj
        elif t == "run_end":
            end = obj
        elif t == "span":
            spans.append(obj)
        elif t == "iteration":
            iterations.append(obj)
        else:
            events.append(obj)
    totals: dict = {}
    for s in spans:
        totals[s["path"]] = totals.get(s["path"], 0.0) + s["seconds"]
    return {
        "name": start.get("name"),
        "started_unix": start.get("started_unix"),
        "duration_s": end.get("duration_s"),
        "complete": bool(end),
        "spans": spans,
        "span_totals": {k: round(v, 6) for k, v in sorted(totals.items())},
        "counters": end.get("counters", {}),
        "gauges": end.get("gauges", {}),
        "iterations": iterations,
        "n_iteration_events": end.get("n_iteration_events",
                                      len(iterations)),
        "events": events,
    }
