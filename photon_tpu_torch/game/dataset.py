"""GAME data container (port of `GameData` from `photon_tpu/game/dataset.py`;
the training-side dataset builders come with the training slice)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GameData:
    """Host-side GAME data: response + per-shard design matrices (numpy
    arrays or `SparseRows`) + per-coordinate raw entity ids."""

    y: np.ndarray  # (n,)
    weights: np.ndarray  # (n,)
    offsets: np.ndarray  # (n,) base offsets
    shards: dict  # feature-shard name -> matrix (n rows)
    entity_ids: dict  # entity-type name -> (n,) raw ids

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    @staticmethod
    def build(y, shards, entity_ids=None, weights=None,
              offsets=None) -> "GameData":
        y = np.asarray(y, np.float32)
        n = y.shape[0]
        weights = (np.ones(n, np.float32) if weights is None
                   else np.asarray(weights, np.float32))
        offsets = (np.zeros(n, np.float32) if offsets is None
                   else np.asarray(offsets, np.float32))
        return GameData(y, weights, offsets, dict(shards),
                        dict(entity_ids or {}))
