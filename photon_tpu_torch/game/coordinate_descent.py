"""Coordinate descent over GAME coordinates (port of `coordinate_descent`
and `CoordinateDescentResult` of `photon_tpu/game/coordinate_descent.py`,
in memory on one device).

Reference parity: com.linkedin.photon.ml.algorithm.CoordinateDescent —
per sweep, per coordinate: train that coordinate with every OTHER
coordinate's scores folded into the offsets, then refresh its scores.
Locked coordinates keep their pretrained model and only contribute
scores; incremental coordinates train against their initial model as an
informative prior, the same prior in every sweep.

The host drives the loop; every score, offset sum and objective stays on
the device (the objectives are read back once, at the end). This is the
reference's plain route: its fused one-program updates are a speed path
to the same models, and the streamed regime (host margin caches) and
checkpoints are not ported yet (ROADMAP queue A items 5 and 6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectCoordinate
from photon_tpu_torch.ops.losses import TaskType, loss_fns

Coordinate = FixedEffectCoordinate | RandomEffectCoordinate


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    objective_history: list  # total weighted loss after each update
    coordinate_stats: dict  # name -> list of per-update OptResult/RETrainStats


def coordinate_device(coord: Coordinate) -> torch.device:
    """The device a coordinate's data lives on."""
    ds = coord.dataset
    if isinstance(coord, FixedEffectCoordinate):
        return ds.y.device
    return ds.device


def _objective_at(task, y, weights, offsets, score):
    loss, _, _ = loss_fns(task)
    return torch.sum(weights * loss(offsets + score, y))


def _sum_scores(base, scores):
    out = base
    for s in scores:
        out = out + s
    return out


def _column(v, dev) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return t.to(dev, torch.float32)


def coordinate_descent(coordinates: dict, y, weights, base_offsets,
                       task: TaskType,
                       update_sequence: Optional[list] = None,
                       n_sweeps: int = 1, locked: frozenset = frozenset(),
                       initial_models: Optional[dict] = None,
                       incremental: frozenset = frozenset(),
                       priors: Optional[dict] = None
                       ) -> CoordinateDescentResult:
    """Run ``n_sweeps`` passes of the update sequence and return the model.

    ``coordinates``: name -> FixedEffectCoordinate | RandomEffectCoordinate.
    ``locked`` coordinates must appear in ``initial_models``; they are
    scored but never retrained. Unlocked coordinates warm-start from
    ``initial_models`` when given. ``incremental`` coordinates also use
    their initial model (or ``priors[name]``) as an informative prior for
    every retrain — the ORIGINAL initial model in every sweep."""
    update_sequence = update_sequence or list(coordinates)
    models = dict(initial_models or {})
    if priors is None:
        priors = {name: models[name] for name in incremental
                  if name in models}
    for name in incremental:
        if name not in priors:
            raise ValueError(
                f"incremental coordinate {name!r} needs an initial model")
    for name in locked:
        if name not in models:
            raise ValueError(
                f"locked coordinate {name!r} needs an initial model")
    dev = coordinate_device(next(iter(coordinates.values())))
    y = _column(y, dev)
    weights = _column(weights, dev)
    base = _column(base_offsets, dev)

    # the scores of pre-existing models are offsets from the start, for
    # every coordinate with a model (score-only ones included)
    scores = {name: coordinates[name].score(models[name])
              for name in coordinates if name in models}
    objective_history: list = []
    coordinate_stats: dict = {name: [] for name in update_sequence}
    for _ in range(n_sweeps):
        for name in update_sequence:
            if name in locked:
                continue
            coord = coordinates[name]
            offsets = _sum_scores(base, tuple(
                s for o, s in scores.items() if o != name))
            model, stats = coord.train(offsets, warm_start=models.get(name),
                                       prior=priors.get(name))
            models[name] = model
            scores[name] = coord.score(model)
            coordinate_stats[name].append(stats)
            objective_history.append(
                _objective_at(task, y, weights, offsets, scores[name]))
    objective_history = ([float(v) for v in torch.stack(
        objective_history).cpu().tolist()] if objective_history else [])
    ordered = {name: models[name] for name in update_sequence}
    for name in coordinates:  # score-only coordinates outside the sequence
        if name in models and name not in ordered:
            ordered[name] = models[name]
    return CoordinateDescentResult(GameModel(ordered, task),
                                   objective_history, coordinate_stats)
