"""Optimizer configuration (port of `photon_tpu/optim/config.py`).

Reference parity: com.linkedin.photon.ml.optimization.{OptimizerType,
OptimizerConfig, GLMOptimizationConfiguration}.
"""
from __future__ import annotations

import dataclasses
import enum

from photon_tpu_torch.optim.regularization import NONE, RegularizationContext


class OptimizerType(enum.Enum):
    LBFGS = "lbfgs"
    OWLQN = "owlqn"  # selected automatically when L1 weight > 0, as in reference
    TRON = "tron"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iters: int = 100
    tolerance: float = 1e-7  # relative convergence tolerance (reference default 1e-7)
    # L-BFGS/OWL-QN history length (Breeze default m=10 in reference LBFGS).
    history: int = 10
    # TRON: max conjugate-gradient iterations per Newton step.
    cg_max_iters: int = 20
    reg: RegularizationContext = NONE
    reg_weight: float = 0.0
    regularize_intercept: bool = True  # reference regularizes the intercept feature
    # Lane grid only (train_glm_grid): the storage dtype of the (m, d, G)
    # L-BFGS/OWL-QN (s, y) history, e.g. "bfloat16" (None: the solver's
    # f32). The steering inner products (rho, gamma, the curvature test)
    # stay f32, computed from the unrounded pair at push time and cached,
    # so only the two-loop direction sees the rounding.
    lane_history_dtype: str | None = None
    # Kernel mode for the solve's X passes, as `photon_tpu_torch.kernels`'
    # ``on``/``off``/``auto``; None inherits the PHOTON_TPU_TORCH_KERNELS
    # env knob. train_glm scopes the whole solve with it.
    kernels: str | None = None

    def effective_optimizer(self) -> OptimizerType:
        """The reference forces OWLQN whenever an L1 term is present."""
        if self.reg.l1_weight(self.reg_weight) > 0.0:
            return OptimizerType.OWLQN
        return self.optimizer
