"""Bayesian hyperparameter tuning (port of `photon_tpu/tuning`;
reference: com.linkedin.photon.ml.hyperparameter).

The reference's `tile_tuner.py` (`CANDIDATE_TILES`, `DEFAULT_TILE`,
`autotune_tiles`, `tile_for`) measures the row tile of its Pallas tiled
kernels. The port's tiled kernels have no row tile to resolve at run
time: their geometry is fixed when they compile (`rows_per_thread` in
`kernels/csrc/blocked_ell.cu`, `BLOCK` in `kernels/blocked_ell.py`), so
those four names wait for a kernel that takes the tile as a launch
parameter (ROADMAP queue A item 11.3)."""
from photon_tpu_torch.tuning.acquisition import (expected_improvement,
                                                 lower_confidence_bound)
from photon_tpu_torch.tuning.gp import GaussianProcess, fit_gp
from photon_tpu_torch.tuning.lane_tuner import (LaneBudget, LaneTuningResult,
                                                RoundBudgetError,
                                                tune_glm_reg_lanes)
from photon_tpu_torch.tuning.search import SearchRange, SearchSpace, candidates
from photon_tpu_torch.tuning.tuner import TuningResult, tune, tune_glm_reg

__all__ = [
    "GaussianProcess", "fit_gp", "expected_improvement",
    "lower_confidence_bound", "SearchRange", "SearchSpace", "candidates",
    "TuningResult", "tune", "tune_glm_reg",
    "LaneBudget", "LaneTuningResult", "RoundBudgetError",
    "tune_glm_reg_lanes",
]
