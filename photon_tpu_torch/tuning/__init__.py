"""Bayesian hyperparameter tuning (port of `photon_tpu/tuning`;
reference: com.linkedin.photon.ml.hyperparameter), and the work-item
tile autotuner of the tiled blocked-ELL kernels (`tile_tuner`:
`CANDIDATE_TILES`, `DEFAULT_TILE`, `autotune_tiles`, `tile_for`)."""
from photon_tpu_torch.tuning.acquisition import (expected_improvement,
                                                 lower_confidence_bound)
from photon_tpu_torch.tuning.gp import GaussianProcess, fit_gp
from photon_tpu_torch.tuning.lane_tuner import (LaneBudget, LaneTuningResult,
                                                RoundBudgetError,
                                                tune_glm_reg_lanes)
from photon_tpu_torch.tuning.search import SearchRange, SearchSpace, candidates
from photon_tpu_torch.tuning.tile_tuner import (CANDIDATE_TILES,
                                                DEFAULT_TILE, autotune_tiles,
                                                tile_for)
from photon_tpu_torch.tuning.tuner import TuningResult, tune, tune_glm_reg

__all__ = [
    "GaussianProcess", "fit_gp", "expected_improvement",
    "lower_confidence_bound", "SearchRange", "SearchSpace", "candidates",
    "TuningResult", "tune", "tune_glm_reg",
    "LaneBudget", "LaneTuningResult", "RoundBudgetError",
    "tune_glm_reg_lanes",
    "CANDIDATE_TILES", "DEFAULT_TILE", "autotune_tiles", "tile_for",
]
