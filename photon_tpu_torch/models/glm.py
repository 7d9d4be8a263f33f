"""GLM containers (port of the `Coefficients`/`GeneralizedLinearModel`
part of `photon_tpu/models/glm.py`).

User-facing coefficients are in ORIGINAL column order; a `BlockedEllRows`
design matrix works in its permuted space, so scoring translates w at the
boundary (one gather)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.matrix import BlockedEllRows, matvec
from photon_tpu_torch.ops.losses import TaskType, mean_fn


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Reference: com.linkedin.photon.ml.model.Coefficients."""

    means: torch.Tensor  # (d,)
    variances: Optional[torch.Tensor] = None  # (d,) or None

    @property
    def dim(self) -> int:
        return int(self.means.shape[0])


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    coefficients: Coefficients
    task: TaskType

    @property
    def weights(self) -> torch.Tensor:
        return self.coefficients.means

    def score(self, X, offsets=0.0) -> torch.Tensor:
        """Raw margin x·w + offset (reference: computeScore)."""
        w = self.coefficients.means
        if isinstance(X, BlockedEllRows):
            w = X.from_model_space(w)
        return matvec(X, w) + offsets

    def predict_mean(self, X, offsets=0.0) -> torch.Tensor:
        """Mean response via the inverse link (reference: computeMean)."""
        return mean_fn(self.task)(self.score(X, offsets))
