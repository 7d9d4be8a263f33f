"""Cross-rank telemetry aggregation (port of
`photon_tpu/telemetry/aggregate.py`): merge the per-process JSONL event
logs of a `parallel/launch.py` run into ONE cluster report.

Each cluster member writes its own event file (``p<k>.jsonl`` — the same
``p<k>`` prefix convention as the checkpoint payloads), because ranks are
separate processes with separate `Run` recorders. This module reads them
back through `sinks.read_jsonl`'s truncation tolerance (a rank killed
mid-write still contributes its prefix) and produces:

- **per-rank rollups** — counters, span totals, duration, completeness
  (did the rank's ``run_end`` land?);
- **cluster totals** — counters summed across ranks;
- **skew attribution** — per-rank barrier wait (the
  ``parallel.barrier_wait`` span `parallel/mesh.py::cluster_barrier`
  opens, plus the checkpoint commit barrier's wait) and per-rank decode
  work (``ingest.chunks`` vs ``ingest.chunks_skipped``), with the
  STRAGGLER RANK NAMED: under a barrier, the straggler is the rank
  everyone else waits for — it arrives last and waits least, so the
  attribution points at min barrier wait, corroborated by max decode
  work;
- **wall-clock-aligned timelines** — every span carries its offset from
  run start (``t_s``, stamped by `run.Run`); anchored to each rank's own
  ``started_unix`` the spans land on one shared wall clock.
  ``clock_skew_s`` reports the rank start spread — ranks launch
  staggered and hosts disagree on wall time, so readers sort the merged
  timeline rather than trusting cross-rank microsecond alignment.

Degradation, never a crash: a MISSING rank file yields a partial report
with the gap named in ``missing_ranks``; a TORN rank (no run_end) keeps
its surviving prefix with ``complete: false``. Consumed by ``python -m
photon_tpu_torch.parallel --selftest`` and ``python -m
photon_tpu_torch.telemetry --selftest``.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

from photon_tpu_torch.telemetry.sinks import load_report

__all__ = ["rank_files", "aggregate_cluster", "RANK_FILE_RE"]

RANK_FILE_RE = re.compile(r"^p(\d+)\.jsonl$")

_BARRIER_SPAN_KEY = "barrier_wait"


def rank_files(directory: str) -> dict:
    """{rank: path} for every ``p<k>.jsonl`` in ``directory``."""
    out: dict = {}
    if os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            m = RANK_FILE_RE.match(name)
            if m:
                out[int(m.group(1))] = os.path.join(directory, name)
    return out


def _barrier_wait_s(span_totals: dict) -> float:
    """Total barrier-wait seconds in one rank's span totals (matches
    `parallel.barrier_wait` and the checkpoint commit barrier's span by
    path substring, at any nesting depth)."""
    return sum(v for k, v in span_totals.items()
               if _BARRIER_SPAN_KEY in k)


def _skew(per_rank: dict, key) -> dict:
    vals = {rank: key(r) for rank, r in per_rank.items()}
    if not vals:
        return {"per_rank": {}, "spread": 0.0}
    return {"per_rank": {str(k): round(v, 6) for k, v in
                         sorted(vals.items())},
            "spread": round(max(vals.values()) - min(vals.values()), 6)}


def _name_straggler(per_rank: dict) -> Optional[int]:
    """The rank the cluster waits for: min barrier wait when barriers
    were timed (the straggler arrives last, waits least), else max
    decode work, else max duration."""
    if not per_rank:
        return None
    barrier = {k: _barrier_wait_s(r["span_totals"])
               for k, r in per_rank.items()}
    if any(v > 0 for v in barrier.values()):
        return min(barrier, key=barrier.get)
    decode = {k: r["counters"].get("ingest.chunks", 0.0)
              for k, r in per_rank.items()}
    if any(decode.values()):
        return max(decode, key=decode.get)
    return max(per_rank,
               key=lambda k: per_rank[k].get("duration_s") or 0.0)


def aggregate_cluster(source: Union[str, dict],
                      expect_ranks: Optional[int] = None) -> dict:
    """Merge per-rank JSONL logs into one cluster report.

    ``source``: a directory holding ``p<k>.jsonl`` files, or an explicit
    ``{rank: path}`` map. ``expect_ranks``: the launched process count;
    when given (or inferable from the densest rank seen) absent ranks are
    NAMED in ``missing_ranks`` instead of silently shrinking the
    cluster."""
    paths = rank_files(source) if isinstance(source, str) else \
        {int(k): v for k, v in source.items()}
    per_rank: dict = {}
    unreadable: dict = {}
    for rank, path in sorted(paths.items()):
        if not os.path.exists(path):
            unreadable[rank] = "file missing"
            continue
        try:
            rep = load_report(path)
        except OSError as e:
            unreadable[rank] = f"{type(e).__name__}: {e}"
            continue
        per_rank[rank] = {
            "path": path,
            "name": rep.get("name"),
            "started_unix": rep.get("started_unix"),
            "duration_s": rep.get("duration_s"),
            "complete": bool(rep.get("complete")),
            "counters": rep.get("counters", {}),
            "span_totals": rep.get("span_totals", {}),
            "spans": rep.get("spans", []),
        }

    n_expected = int(expect_ranks) if expect_ranks is not None else \
        ((max(paths) + 1) if paths else 0)
    missing = sorted(set(range(n_expected)) - set(per_rank))

    totals: dict = {}
    for r in per_rank.values():
        for k, v in r["counters"].items():
            totals[k] = totals.get(k, 0.0) + v

    # ------------------------------------------------- skew attribution
    barrier = _skew(per_rank, lambda r: _barrier_wait_s(r["span_totals"]))
    decode = _skew(per_rank,
                   lambda r: r["counters"].get("ingest.chunks", 0.0))
    straggler = _name_straggler(per_rank)
    attribution = None
    if straggler is not None:
        s = per_rank[straggler]
        attribution = (
            f"rank {straggler} is the straggler: barrier wait "
            f"{_barrier_wait_s(s['span_totals']):.4f}s (cluster spread "
            f"{barrier['spread']:.4f}s), decoded "
            f"{s['counters'].get('ingest.chunks', 0):.0f} chunks "
            f"(skipped {s['counters'].get('ingest.chunks_skipped', 0):.0f};"
            f" cluster decode spread {decode['spread']:.0f})")

    # -------------------------------------- wall-clock-aligned timeline
    starts = [r["started_unix"] for r in per_rank.values()
              if r["started_unix"] is not None]
    clock_skew_s = round(max(starts) - min(starts), 6) if starts else 0.0
    timeline = []
    for rank, r in sorted(per_rank.items()):
        base = r["started_unix"]
        if base is None:
            continue
        for s in r["spans"]:
            if "t_s" not in s:  # pre-offset span records cannot align
                continue
            timeline.append({
                "rank": rank, "path": s["path"],
                "start_unix": round(base + s["t_s"], 6),
                "seconds": s["seconds"],
            })
    timeline.sort(key=lambda e: (e["start_unix"], e["rank"]))

    ranks_out = {str(k): {kk: vv for kk, vv in r.items() if kk != "spans"}
                 for k, r in sorted(per_rank.items())}
    return {
        "n_ranks": len(per_rank),
        "n_expected": n_expected,
        "complete": (not missing and not unreadable
                     and all(r["complete"] for r in per_rank.values())),
        "missing_ranks": missing,
        **({"unreadable_ranks": {str(k): v for k, v in unreadable.items()}}
           if unreadable else {}),
        "ranks": ranks_out,
        "counters_total": {k: round(v, 6)
                           for k, v in sorted(totals.items())},
        "skew": {
            "barrier_wait_s": barrier,
            "decode_chunks": decode,
            "straggler_rank": straggler,
            **({"attribution": attribution} if attribution else {}),
        },
        "clock_skew_s": clock_skew_s,
        "timeline": timeline,
    }
