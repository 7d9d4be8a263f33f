"""Performance attribution: modeled-against-measured rooflines,
first-call accounting, and the noise-aware bench regression sentinel
(port of `photon_tpu/profiling`).

- `model` — static per-program cost estimates (`StaticCost`): the
  streamed chunk programs (`chunk_cost`) and the lane grid
  (`lane_grid_cost`), priced from the layout's own structure (the port
  has no jaxpr to walk, and no compiled program for XLA's view).
- `ledger` — the process-wide `Ledger` (the `telemetry.Run` pattern):
  attributes measured seconds to the programs that ran, computes achieved
  FLOP/s and bytes/s and roofline shares per (program, phase) against the
  device's own peaks, books first-call costs (the kernel library's load,
  the layout plan) and signature counts, and records per-phase device
  memory. Detached (the default) every entry point is one global load and
  one branch; armed or not it adds no sync and no launch.
- `sentinel` — the bench regression gate: per-leg median/MAD fits over a
  BENCH_r*.json trajectory, robust z-score verdicts.

::

    from photon_tpu_torch import profiling

    with profiling.ledger("flagship") as led:
        train_glm(chunked, task, config)      # instrumented hot paths
    print("\\n".join(led.summary_lines()))

CLI: ``python -m photon_tpu_torch.profiling --report [--json]`` runs a
small streamed-dense solve under a ledger and renders the attribution
report; ``--selftest`` is the smoke the umbrella ``python -m
photon_tpu_torch --selfcheck`` aggregates.
"""
from __future__ import annotations

from photon_tpu_torch.profiling import sentinel  # noqa: F401
from photon_tpu_torch.profiling.ledger import (  # noqa: F401
    Ledger,
    ProgramRecord,
    attribute,
    current_ledger,
    dispatch,
    enabled,
    finish_ledger,
    ledger,
    ledger_disabled,
    measure,
    needs_note,
    note_program,
    record_signature,
    resolve_peaks,
    sample_hbm,
    start_ledger,
)
from photon_tpu_torch.profiling.model import (  # noqa: F401
    StaticCost,
    chunk_cost,
    lane_grid_cost,
)

__all__ = [
    "Ledger", "ProgramRecord", "StaticCost",
    "start_ledger", "finish_ledger", "ledger", "current_ledger",
    "enabled", "measure", "attribute", "note_program", "needs_note",
    "dispatch", "record_signature", "sample_hbm", "ledger_disabled",
    "resolve_peaks", "chunk_cost", "lane_grid_cost", "sentinel",
]
