"""Solver result (port of `photon_tpu/optim/tracker.py`).

Reference parity: com.linkedin.photon.ml.optimization.OptimizationStatesTracker
(loss / gradient-norm per iteration). History tensors are fixed-length
(max_iters + 1) and NaN-padded, as in the reference.

`converged` reports ONLY the gradient/function tolerance criteria;
`failed` reports abnormal termination (line-search failure), as the
reference distinguishes Breeze's FailedLineSearch from convergence.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class OptResult(NamedTuple):
    w: torch.Tensor
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: int  # the solve's loop runs on the host, so it knows;
    #                  a (G,) tensor of per-lane counts for a lane grid
    converged: torch.Tensor  # tolerance criteria met
    failed: torch.Tensor  # abnormal stop (line search failure)
    loss_history: torch.Tensor  # (max_iters + 1,), NaN-padded
    grad_norm_history: torch.Tensor  # (max_iters + 1,), NaN-padded
    # Work counts the host loop keeps (not in the reference): calls of the
    # objective's value_and_grad (OWL-QN; 0 for the margin-cached solvers),
    # Hessian-vector products (TRON) and line-search trials (the lane
    # solvers; each trial is shared by every lane).
    evaluations: int = 0
    hvps: int = 0
    trials: int = 0

    def history(self) -> np.ndarray:
        h = self.loss_history.cpu().numpy()
        return h[~np.isnan(h)]

    def grad_history(self) -> np.ndarray:
        h = self.grad_norm_history.cpu().numpy()
        return h[~np.isnan(h)]
