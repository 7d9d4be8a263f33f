"""Coefficient variance computation (port of `photon_tpu/models/variance.py`).

Reference parity: com.linkedin.photon.ml.optimization.VarianceComputationType
{NONE, SIMPLE, FULL} and DistributedOptimizationProblem.computeVariances:
SIMPLE is var_j = 1 / H_jj, the inverse of the Hessian diagonal. FULL
(diag(H⁻¹) by a dense solve) is still to come (ROADMAP queue A item 4).
"""
from __future__ import annotations

import enum

import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.ops.objective import Objective


class VarianceComputationType(enum.Enum):
    NONE = "none"
    SIMPLE = "simple"
    FULL = "full"


def compute_variances(obj: Objective, w: torch.Tensor, batch: GLMBatch,
                      kind: VarianceComputationType):
    if kind is VarianceComputationType.NONE:
        return None
    if kind is VarianceComputationType.SIMPLE:
        return 1.0 / torch.clamp(obj.hess_diag(w, batch), min=1e-12)
    raise NotImplementedError(
        "FULL variances are not ported yet (ROADMAP queue A item 4); use "
        "SIMPLE")
