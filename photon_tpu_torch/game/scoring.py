"""Offline batch scoring of GAME models (port of the in-memory path of
`photon_tpu/game/scoring.py`; the streamed host-cache path,
`score_chunked_host`, waits for ROADMAP queue A item 6). It scores what
`game.estimator.GameEstimator.fit` returns, on the model's device.

The total score is the base offsets plus every coordinate's margin,
summed in coordinate order — the sum the serving ladder's f32 rungs must
agree with.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.data.matrix import BlockedEllRows, SparseRows, as_tensor
from photon_tpu_torch.game.dataset import GameData
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)


def _model_device(model: GameModel) -> torch.device:
    cm = next(iter(model.coordinates.values()))
    if isinstance(cm, FixedEffectModel):
        return cm.model.weights.device
    return cm.coefficients.device


def _on(X, device):
    if isinstance(X, (SparseRows, BlockedEllRows)):
        return X.to(device)
    return as_tensor(X, device)


def coordinate_scores(model: GameModel, data: GameData) -> dict:
    """Per-coordinate margin contributions on ``data`` (on the model's
    device)."""
    device = _model_device(model)
    out = {}
    for name, cm in model.coordinates.items():
        X = _on(data.shards[cm.feature_shard], device)
        if isinstance(cm, FixedEffectModel):
            out[name] = cm.score(X)
        elif isinstance(cm, RandomEffectModel):
            out[name] = cm.score(X, cm.dense_ids(
                data.entity_ids[cm.entity_name]))
        else:
            raise TypeError(f"unknown coordinate model type: {type(cm)}")
    return out


def score_game(model: GameModel, data: GameData) -> torch.Tensor:
    """Total raw score: base offsets + Σ coordinate margins
    (reference: GameScoringDriver's scoreGameModel)."""
    scores = coordinate_scores(model, data)
    out = as_tensor(data.offsets, _model_device(model)).to(torch.float32)
    for s in scores.values():
        out = out + s
    return out
