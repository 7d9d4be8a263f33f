"""Task types and inverse links (port of `photon_tpu/ops/losses.py`).

Only what scoring needs is ported so far: `TaskType` and `mean_fn`. The
losses and their derivatives come with the training slice.
"""
from __future__ import annotations

import enum

import torch


class TaskType(enum.Enum):
    """Reference: com.linkedin.photon.ml.TaskType (same values as the JAX
    package's enum, so a task crosses over by ``TaskType(value)``)."""

    LOGISTIC_REGRESSION = "logistic"
    LINEAR_REGRESSION = "linear"
    POISSON_REGRESSION = "poisson"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "smoothed_hinge"


def _identity(z: torch.Tensor) -> torch.Tensor:
    return z


def mean_fn(task: TaskType):
    """Inverse link, for scoring (reference: GeneralizedLinearModel.computeMean)."""
    if task is TaskType.LOGISTIC_REGRESSION:
        return torch.sigmoid
    if task is TaskType.POISSON_REGRESSION:
        return torch.exp
    # linear regression and SVM score with the raw margin.
    return _identity
