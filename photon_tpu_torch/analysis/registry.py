"""The central contract registry (port of `photon_tpu/analysis/
registry.py`): importing every hot-path module registers its
ContractSpecs into `analysis.contracts.REGISTRY` (each spec lives at the
bottom of the module whose program it pins).

Nothing runs until `load_registry()`'s caller asks
`contracts.check_registry` to.

The reference's 51 contracts, each ported next to the port module it
pins (`module:line` of its registration):

- ``blocked_ell_kernel_no_retrace``:
  kernels/blocked_ell.py:678 (reference kernels/blocked_ell.py:489)
- ``blocked_ell_kernel_x_passes``:
  kernels/blocked_ell.py:656 (reference kernels/blocked_ell.py:463)
- ``blocked_ell_lane_x_passes``:
  data/matrix.py:1964 (reference data/matrix.py:1955)
- ``blocked_ell_tiled_x_passes``:
  kernels/blocked_ell.py:713 (reference kernels/blocked_ell.py:531)
- ``blocked_ell_x_passes``:
  data/matrix.py:1946 (reference data/matrix.py:1935)
- ``checkpoint_off_is_free``:
  checkpoint/taps.py:141 (reference checkpoint/taps.py:140)
- ``checkpoint_off_tron_free``:
  checkpoint/taps.py:168 (reference checkpoint/taps.py:162)
- ``continual_re_refresh_solve``:
  continual/refresh.py:351 (reference continual/refresh.py:322)
- ``continual_refresh_no_retrace``:
  continual/refresh.py:370 (reference continual/refresh.py:342)
- ``driver_scoring_chunk``:
  drivers/score.py:445 (reference drivers/score.py:420)
- ``game_fixed_update``:
  game/coordinate_descent.py:391 (reference game/coordinate_descent.py:588)
- ``game_re_budgeted_first_pass``:
  game/random_effect.py:824 (reference game/random_effect.py:753)
- ``game_re_mesh_bucket_solve``:
  game/random_effect.py:839 (reference game/random_effect.py:767)
- ``game_re_straggler_resolve``:
  game/random_effect.py:860 (reference game/random_effect.py:810)
- ``game_re_vmapped_solve``:
  game/random_effect.py:809 (reference game/random_effect.py:742)
- ``game_score_stream_chunk``:
  game/scoring.py:202 (reference game/scoring.py:171)
- ``game_streamed_fixed_evaluation``:
  game/coordinate_descent.py:426 (reference game/coordinate_descent.py:623)
- ``grouped_auc_scatter_free``:
  evaluation/grouped.py:228 (reference evaluation/grouped.py:242)
- ``hybrid_mesh_value_and_grad``:
  parallel/mesh.py:751 (reference parallel/mesh.py:458)
- ``ingest_plane_chunk_invariance``:
  data/ingest_plane.py:734 (reference data/ingest_plane.py:613)
- ``lane_blocked_ell_value_and_grad``:
  ops/objective.py:459 (reference ops/objective.py:504)
- ``ledger_off_is_free``:
  profiling/ledger.py:539 (reference profiling/ledger.py:521)
- ``mesh_stream_donated_no_retrace``:
  optim/streamed.py:1080 (reference optim/streamed.py:1364)
- ``mesh_value_and_grad``:
  parallel/mesh.py:742 (reference parallel/mesh.py:449)
- ``multihost_grad_only_dcn``:
  parallel/mesh.py:762 (reference parallel/mesh.py:470)
- ``resident_grid_lanes``:
  models/training.py:821 (reference models/training.py:1084)
- ``resident_lbfgs_solve``:
  models/training.py:802 (reference models/training.py:1066)
- ``resident_linesearch_trial``:
  ops/objective.py:484 (reference ops/objective.py:531)
- ``resident_value_and_grad``:
  ops/objective.py:419 (reference ops/objective.py:458)
- ``resident_value_and_grad_bf16``:
  ops/objective.py:430 (reference ops/objective.py:470)
- ``serving_admission_program_invariance``:
  serving/admission.py:115 (reference serving/admission.py:157)
- ``serving_fleet_request_path``:
  serving/fleet.py:353 (reference serving/fleet.py:346)
- ``serving_kernel_fused_rung``:
  kernels/serving.py:284 (reference kernels/serving.py:169)
- ``serving_kernel_mode_invariance``:
  kernels/serving.py:304 (reference kernels/serving.py:195)
- ``serving_quantized_rung_invariance``:
  serving/programs.py:364 (reference serving/programs.py:461)
- ``serving_request_margin``:
  serving/programs.py:390 (reference serving/programs.py:494)
- ``serving_request_program``:
  serving/programs.py:351 (reference serving/programs.py:447)
- ``serving_trace_off_is_free``:
  telemetry/trace.py:335 (reference telemetry/trace.py:335)
- ``sharded_blocked_ell_value_and_grad``:
  models/training.py:917 (reference models/training.py:1193)
- ``sharded_hybrid_value_and_grad``:
  models/training.py:876 (reference models/training.py:1118)
- ``sharded_permuted_grid_lanes``:
  models/training.py:896 (reference models/training.py:1164)
- ``sharded_permuted_value_and_grad``:
  models/training.py:885 (reference models/training.py:1140)
- ``streamed_blocked_ell_chunk_partials``:
  ops/objective.py:441 (reference ops/objective.py:482)
- ``streamed_chunk_init``:
  optim/streamed.py:989 (reference optim/streamed.py:1289)
- ``streamed_mesh_blocked_ell_chunk_partials``:
  optim/streamed.py:1044 (reference optim/streamed.py:1331)
- ``streamed_mesh_chunk_init``:
  optim/streamed.py:1004 (reference optim/streamed.py:1299)
- ``streamed_mesh_finish``:
  optim/streamed.py:1030 (reference optim/streamed.py:1313)
- ``streamed_mesh_trial_totals``:
  optim/streamed.py:1110 (reference optim/streamed.py:1400)
- ``telemetry_off_is_free``:
  telemetry/taps.py:81 (reference telemetry/taps.py:109)
- ``tuning_lane_dispatch``:
  tuning/lane_tuner.py:397 (reference tuning/lane_tuner.py:425)
- ``tuning_round_budget``:
  tuning/lane_tuner.py:430 (reference tuning/lane_tuner.py:463)

None is left out. ``mesh_stream_donated_no_retrace`` pins, in the
reference, that buffer donation plus the ring's rotation never retrace;
torch has no buffer donation, so the port holds its other half — the
upload ring dispatches the chunk program with one signature across two
passes — and the communication-free chunk program.
"""
from __future__ import annotations

import importlib

# Every module that registers ContractSpecs, in the reference's order.
HOT_PATH_MODULES = (
    "photon_tpu_torch.data.matrix",         # blocked-ELL X passes
    "photon_tpu_torch.kernels.blocked_ell",  # hand-written X-pass kernels
    "photon_tpu_torch.kernels.serving",     # the int8 serving-rung kernel
    "photon_tpu_torch.data.ingest_plane",   # chunk-program invariance
    "photon_tpu_torch.ops.objective",       # resident evaluation + trial
    "photon_tpu_torch.parallel.mesh",       # mesh value_and_grad (1-D, 2-D)
    "photon_tpu_torch.models.training",     # resident/lane/sharded solves
    "photon_tpu_torch.optim.streamed",      # streamed + mesh-streamed chunks
    "photon_tpu_torch.game.random_effect",  # per-entity lane solves
    "photon_tpu_torch.game.coordinate_descent",  # fixed update, evaluation
    "photon_tpu_torch.game.scoring",        # streamed chunk scorer
    "photon_tpu_torch.drivers.score",       # the scoring driver's chunk
    "photon_tpu_torch.telemetry.taps",      # telemetry-off-is-free
    "photon_tpu_torch.telemetry.trace",     # request-tracing-off-is-free
    "photon_tpu_torch.serving.programs",    # the serving ladder's rungs
    "photon_tpu_torch.serving.admission",   # overload policy invariance
    "photon_tpu_torch.serving.fleet",       # a replica's request path
    "photon_tpu_torch.checkpoint.taps",     # checkpoint-off-is-free
    "photon_tpu_torch.profiling.ledger",    # ledger-off-is-free
    "photon_tpu_torch.evaluation.grouped",  # scatter-free grouped metrics
    "photon_tpu_torch.continual.refresh",   # delta refresh + no retrace
    "photon_tpu_torch.tuning.lane_tuner",   # lane tuner dispatch + budget
)


def load_registry() -> dict:
    """Import all hot-path modules and return {name: ContractSpec}."""
    for mod in HOT_PATH_MODULES:
        importlib.import_module(mod)
    from photon_tpu_torch.analysis.contracts import REGISTRY

    return dict(REGISTRY)
