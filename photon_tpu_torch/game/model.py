"""GAME model containers (port of `photon_tpu/game/model.py`).

A random effect is one dense (num_entities, d) coefficient tensor (and,
when trained with them, its (num_entities, d) variances) plus a key → row
index; scoring a batch is one gather + rowwise dot. Entities unseen at
training time take row E, the appended zero row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from photon_tpu_torch.data.matrix import SparseRows
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops.losses import TaskType, mean_fn


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Reference: model.FixedEffectModel (one GLM + its feature shard)."""

    model: GeneralizedLinearModel
    feature_shard: str

    @property
    def task(self) -> TaskType:
        return self.model.task

    def score(self, X) -> torch.Tensor:
        return self.model.score(X)


def padded_coeffs(coefficients: torch.Tensor, dense_ids) -> torch.Tensor:
    """Per-row coefficients: (E, d) → (n, d), or a grid's (G, E, d) lane
    tables → (G, n, d); id E selects an appended zero row (the unseen
    entity), the convention scoring and the incremental prior share
    (reference: `_padded_coeffs`)."""
    C = coefficients
    zero = C.new_zeros(C.shape[:-2] + (1, C.shape[-1]))
    ids = torch.as_tensor(np.asarray(dense_ids) if not isinstance(
        dense_ids, torch.Tensor) else dense_ids, device=C.device).long()
    return torch.cat([C, zero], dim=-2)[..., ids, :]


def score_rows(X, coeff_rows: torch.Tensor) -> torch.Tensor:
    """Rowwise margin x_i · c_i with per-row coefficients (n, d), or a
    grid's (G, n, d) giving (G, n) lane margins."""
    if isinstance(X, SparseRows):
        idx = X.indices.long().expand(coeff_rows.shape[:-1]
                                      + X.indices.shape[-1:])
        gathered = torch.gather(coeff_rows, -1, idx)
        return torch.einsum("nk,...nk->...n", X.values, gathered)
    return torch.einsum("nd,...nd->...n", X, coeff_rows)


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient matrix (reference: model.RandomEffectModel).

    Row i of `coefficients` belongs to `entity_keys[i]` (sorted keys)."""

    entity_name: str
    feature_shard: str
    task: TaskType
    coefficients: torch.Tensor  # (E, d)
    entity_keys: np.ndarray  # (E,) raw keys, sorted
    key_to_index: dict
    variances: Optional[torch.Tensor] = None  # (E, d) or None

    @property
    def n_entities(self) -> int:
        return int(self.coefficients.shape[0])

    @property
    def dim(self) -> int:
        return int(self.coefficients.shape[1])

    def dense_ids(self, raw_ids) -> np.ndarray:
        """Raw entity keys → dense row ids; unseen keys map to E (zero row).
        Vectorized via searchsorted over the sorted keys."""
        raw = np.asarray(raw_ids)
        keys = np.asarray(self.entity_keys)
        if raw.dtype.kind != keys.dtype.kind:
            # cross-kind lookup: promote to str rather than casting into
            # keys' dtype, which could truncate unseen ids into collisions
            if keys.dtype.kind in "US":
                raw = raw.astype(np.str_)
            else:
                raw = raw.astype(keys.dtype)
        pos = np.searchsorted(keys, raw)
        pos_c = np.clip(pos, 0, len(keys) - 1)
        found = keys[pos_c] == raw
        return np.where(found, pos_c, self.n_entities).astype(np.int32)

    def coeffs_for(self, dense_ids) -> torch.Tensor:
        """(n, d) per-row coefficients; id == E selects the zero row."""
        return padded_coeffs(self.coefficients, dense_ids)

    def score(self, X, dense_ids) -> torch.Tensor:
        return score_rows(X, self.coeffs_for(dense_ids))

    def model_for(self, key) -> GeneralizedLinearModel:
        """One entity's GLM (reference: RandomEffectModel.getModel)."""
        i = self.key_to_index[key]
        var = None if self.variances is None else self.variances[i]
        return GeneralizedLinearModel(
            Coefficients(self.coefficients[i], var), self.task)


CoordinateModel = Union[FixedEffectModel, RandomEffectModel]


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered coordinate-name → model map (reference: model.GameModel)."""

    coordinates: dict  # name -> CoordinateModel (insertion-ordered)
    task: TaskType

    def __getitem__(self, name: str) -> CoordinateModel:
        return self.coordinates[name]

    def names(self):
        return list(self.coordinates)

    def mean(self, total_score: torch.Tensor) -> torch.Tensor:
        return mean_fn(self.task)(total_score)
