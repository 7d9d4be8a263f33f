"""Per-example GLM losses, their first/second derivatives w.r.t. the margin,
and inverse links (port of `photon_tpu/ops/losses.py`).

Conventions (as the reference): margin z = x·w + offset; logistic and
smoothed-hinge labels are y ∈ {0, 1} (the hinge converts to ±1 itself);
linear and Poisson labels are real. The caller multiplies each
per-example loss by the example weight.
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


# ---------------------------------------------------------------- logistic
def _logistic_loss(z, y):
    # log(1 + e^z) - y z; softplus as logaddexp(z, 0), as jax.nn.softplus
    return torch.logaddexp(z, torch.zeros_like(z)) - y * z


def _logistic_d1(z, y):
    return torch.sigmoid(z) - y


def _logistic_d2(z, y):
    s = torch.sigmoid(z)
    return s * (1.0 - s)


# ------------------------------------------------------------------ linear
def _squared_loss(z, y):
    d = z - y
    return 0.5 * d * d


def _squared_d1(z, y):
    return z - y


def _squared_d2(z, y):
    return torch.ones_like(z)


# ----------------------------------------------------------------- poisson
def _poisson_loss(z, y):
    # exp(z) - y z  (log-likelihood up to a constant in y)
    return torch.exp(z) - y * z


def _poisson_d1(z, y):
    return torch.exp(z) - y


def _poisson_d2(z, y):
    return torch.exp(z)


# ---------------------------------------------------- smoothed hinge (Rennie)
def _hinge_margin(z, y):
    return (2.0 * y - 1.0) * z


def _smoothed_hinge_loss(z, y):
    m = _hinge_margin(z, y)
    zero = torch.zeros_like(m)
    return torch.where(m >= 1.0, zero,
                       torch.where(m <= 0.0, 0.5 - m, 0.5 * (1.0 - m) ** 2))


def _smoothed_hinge_d1(z, y):
    ypm = 2.0 * y - 1.0
    m = ypm * z
    dm = torch.where(m >= 1.0, torch.zeros_like(m),
                     torch.where(m <= 0.0, -torch.ones_like(m), m - 1.0))
    return ypm * dm


def _smoothed_hinge_d2(z, y):
    m = _hinge_margin(z, y)
    return ((m > 0.0) & (m < 1.0)).to(z.dtype)


_LOSS = {
    TaskType.LOGISTIC_REGRESSION: (_logistic_loss, _logistic_d1, _logistic_d2),
    TaskType.LINEAR_REGRESSION: (_squared_loss, _squared_d1, _squared_d2),
    TaskType.POISSON_REGRESSION: (_poisson_loss, _poisson_d1, _poisson_d2),
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: (
        _smoothed_hinge_loss,
        _smoothed_hinge_d1,
        _smoothed_hinge_d2,
    ),
}


def loss_fns(task: TaskType):
    """(loss, d_loss/dz, d2_loss/dz2), each elementwise (z, y) -> tensor."""
    return _LOSS[task]


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
