"""GLM containers (port of the `Coefficients`/`GeneralizedLinearModel`
part of `photon_tpu/models/glm.py` that `game.model` holds)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.matrix import matvec
from photon_tpu_torch.ops.losses import TaskType


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
        return matvec(X, self.coefficients.means) + offsets
