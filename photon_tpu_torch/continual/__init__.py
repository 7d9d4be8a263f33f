"""Continual training flywheel: delta ingestion → prior warm-started
partial re-solves → atomic serving hot-swap (port of
`photon_tpu/continual`, on one device).

1. `delta` — diff a new data drop against the previous run's
   training-row manifest → a compact `RefreshPlan` of touched entities
   per random-effect coordinate.
2. `refresh` — re-solve ONLY the touched entities: each bucket's touched
   lanes compact into one block padded to a multiple of `REFRESH_LANES`,
   warm-started from the saved coefficients with
   `PriorDistribution.from_variances` priors per lane, through the lane
   solvers full training uses.
3. `swap` — parity-probe old vs new margins on sampled entities, publish
   the new version directory, swing the ``CURRENT.json`` pointer with
   the temp+fsync+rename commit primitive, and reload the live
   `CoefficientStore` atomically — a kill mid-swap leaves the old model
   serving bit-identically.

Counters (`telemetry`): ``continual.plans``, ``touched_entities``,
``deferred_new_keys``, ``touched_buckets``, ``skipped_buckets``,
``refresh_solves``, ``refresh_iterations``, ``refreshes``,
``probe_entities``, ``swap_refusals``; the gauge ``staleness_s``; the
cutover counts on ``serving.hot_swaps``. The reference's ``--selftest``
CLI waits with the other self-test CLIs (ROADMAP queue A item 11).
"""
from __future__ import annotations

from photon_tpu_torch.continual.delta import (  # noqa: F401
    CoordinatePlan,
    RefreshPlan,
    build_manifest,
    diff_manifest,
)
from photon_tpu_torch.continual.refresh import (  # noqa: F401
    REFRESH_LANES,
    CoordinateRefreshStats,
    RefreshResult,
    refresh_game_model,
)
from photon_tpu_torch.continual.swap import (  # noqa: F401
    ParityProbe,
    ParityReport,
    SwapRefused,
    hot_swap,
    open_current,
    parity_probe,
    publish_store,
)

__all__ = [
    "CoordinatePlan", "RefreshPlan", "build_manifest", "diff_manifest",
    "REFRESH_LANES", "CoordinateRefreshStats", "RefreshResult",
    "refresh_game_model",
    "ParityProbe", "ParityReport", "SwapRefused", "hot_swap",
    "open_current", "parity_probe", "publish_store",
]
