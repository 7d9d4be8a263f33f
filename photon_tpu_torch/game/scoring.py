"""Offline batch scoring of GAME models (port of `photon_tpu/game/
scoring.py` on one device). It scores what `game.estimator.GameEstimator.
fit` returns, on the model's device.

The total score is the base offsets plus every coordinate's margin,
summed in coordinate order — the sum the serving ladder's f32 rungs must
agree with.

A fixed effect whose shard is a host `ChunkedMatrix` (the streamed
regime) scores through `score_chunked_host`: each chunk streams through
the device, its margins are copied asynchronously into a pinned HOST
(n,) cache, and the full-dataset score vector never lives on the device,
so the GAME descent sums its offsets on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix, make_chunked_batch
from photon_tpu_torch.data.matrix import (BlockedEllRows, SparseRows,
                                          as_tensor, matvec)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.dataset import GameData
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)


def _model_device(model: GameModel) -> torch.device:
    cm = next(iter(model.coordinates.values()))
    if isinstance(cm, FixedEffectModel):
        return cm.model.weights.device
    return cm.coefficients.device


def _on(X, device):
    if isinstance(X, ChunkedMatrix):
        return X  # streamed chunk by chunk, never resident
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


def score_chunked_host(X: ChunkedMatrix, w, mesh=None,
                       device=None) -> np.ndarray:
    """Margins of a host ChunkedMatrix as a HOST (n_real,) f32 cache
    (reference: `score_chunked_host`). Each chunk streams through the
    upload ring onto ``w``'s device (``device`` for a host ``w``; default
    ``cuda``), takes one matvec there (a chunk ladder's blocked-ELL
    kernels; ``w`` translated into its permuted space once), and its
    margins are copied asynchronously into a pinned host buffer read once
    the stream has closed. ``mesh`` waits for ROADMAP queue A item 10."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded streamed scoring is not ported yet (ROADMAP "
            "queue A item 10)")
    if isinstance(w, torch.Tensor):
        dev = w.device
    else:
        dev = resolve_device(device)
        w = torch.from_numpy(np.asarray(w, np.float32)).to(dev)
    w = w.to(torch.float32)
    if X.permuted:
        w = w[X.perm_cols.to(dev).long()]
    cuda = dev.type == "cuda"
    c = X.chunk_rows
    out = torch.empty((X.n_padded,), dtype=torch.float32, pin_memory=cuda)
    data = make_chunked_batch(X, np.zeros(X.n_real, np.float32))
    for i, b in data.iter_device(device=dev):
        out[i * c:(i + 1) * c].copy_(matvec(b.X, w), non_blocking=True)
        telemetry.count("game_e2e.score_stream_chunks")
    if cuda:
        torch.cuda.current_stream(dev).synchronize()
    telemetry.count("game_e2e.score_stream_rows", int(X.n_real))
    return out.numpy()[:X.n_real]
