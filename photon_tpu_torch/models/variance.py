"""Coefficient variance computation (port of `photon_tpu/models/variance.py`).

Reference parity: com.linkedin.photon.ml.optimization.VarianceComputationType
{NONE, SIMPLE, FULL} and DistributedOptimizationProblem.computeVariances:
SIMPLE is var_j = 1 / H_jj, the inverse of the Hessian diagonal; FULL is
diag(H⁻¹) by a dense solve (small feature spaces only). The lane form
computes either for every lane of a lane-minor solve (a random effect's
entities) at once, FULL as one batched solve.
"""
from __future__ import annotations

import enum

import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.ops import lane_objective as lo
from photon_tpu_torch.ops.objective import Objective


class VarianceComputationType(enum.Enum):
    NONE = "none"
    SIMPLE = "simple"
    FULL = "full"


def _diag_of_inverse(H: torch.Tensor) -> torch.Tensor:
    """diag(H⁻¹) of one (d, d) or a stack of (G, d, d) Hessians, by a dense
    solve against the identity (with the reference's 1e-12 ridge)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.diagonal(torch.linalg.solve(H + 1e-12 * eye, eye.expand_as(H)),
                          dim1=-2, dim2=-1)


def compute_variances(obj: Objective, w: torch.Tensor, batch: GLMBatch,
                      kind: VarianceComputationType):
    if kind is VarianceComputationType.NONE:
        return None
    if kind is VarianceComputationType.SIMPLE:
        return 1.0 / torch.clamp(obj.hess_diag(w, batch), min=1e-12)
    return _diag_of_inverse(obj.full_hessian(w, batch))


def compute_variances_lanes(obj: Objective, l2s, W: torch.Tensor,
                            batch: GLMBatch, kind: VarianceComputationType):
    """(d, G) variances of every lane of a lane-minor solve (None for
    NONE): `compute_variances` per lane."""
    if kind is VarianceComputationType.NONE:
        return None
    if kind is VarianceComputationType.SIMPLE:
        return 1.0 / torch.clamp(lo.hess_diag_lanes(obj, l2s, W, batch),
                                 min=1e-12)
    return _diag_of_inverse(lo.full_hessian_lanes(obj, l2s, W, batch)).t()
