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
to the same models, and checkpoints wait for ROADMAP queue A items 6 and
11.

STREAMED regime: when any coordinate's shard is a host `ChunkedMatrix`
(data larger than device memory), the margin exchange moves to the host,
as the reference's does: every coordinate's score is a host (n,) f32
cache, offsets are numpy sums over those caches, and the tracking
objective sums chunk by chunk (a device partial per slice, the totals in
f64 on the host), so no dataset-sized vector lives on the device. It
keeps the reference's ``game_e2e.*`` counters in `telemetry`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix
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
    """The device a coordinate's data lives on (a chunked shard's: the
    one its chunks stream onto)."""
    return coord.dataset.device


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


# ------------------------------------------------- the streamed regime
def _to_host_score(score) -> np.ndarray:
    if isinstance(score, np.ndarray):
        return score
    return score.detach().to(torch.float32).cpu().numpy()


def _sum_scores_host(base, scores) -> np.ndarray:
    out = np.array(base, np.float32, copy=True)
    for s in scores:
        out += s
    telemetry.count("game_e2e.host_offset_sums")
    return out


def _objective_streamed(task, y, weights, offsets, score, chunk_rows: int,
                        dev) -> float:
    """The tracking objective over host columns, chunk by chunk: one
    device partial sum per slice, the totals summed in f64 on the host."""
    n = int(y.shape[0])
    parts = []
    for lo in range(0, n, chunk_rows):
        sl = slice(lo, min(lo + chunk_rows, n))
        parts.append(_objective_at(
            task, *(torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
                    for v in (y, weights, offsets, score))))
        telemetry.count("game_e2e.objective_chunks")
    return float(np.sum(torch.stack(parts).cpu().numpy().astype(
        np.float64)))


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
    # any coordinate with a host-chunked shard moves the whole descent's
    # margin exchange to the host (the module docstring)
    chunked = {name for name, c in coordinates.items()
               if isinstance(getattr(c.dataset, "X", None), ChunkedMatrix)}
    streamed = bool(chunked)
    if streamed:
        y, weights, base = (_to_host_score(_column(v, "cpu"))
                            for v in (y, weights, base_offsets))
        obj_chunk_rows = min(coordinates[n].dataset.X.chunk_rows
                             for n in chunked)
    else:
        y = _column(y, dev)
        weights = _column(weights, dev)
        base = _column(base_offsets, dev)

    # the scores of pre-existing models are offsets from the start, for
    # every coordinate with a model (score-only ones included)
    scores = {name: coordinates[name].score(models[name])
              for name in coordinates if name in models}
    if streamed:
        scores = {name: _to_host_score(s) for name, s in scores.items()}
    objective_history: list = []
    coordinate_stats: dict = {name: [] for name in update_sequence}
    for _ in range(n_sweeps):
        for name in update_sequence:
            if name in locked:
                continue
            coord = coordinates[name]
            others = tuple(s for o, s in scores.items() if o != name)
            if streamed:
                if name in chunked:
                    telemetry.count("game_e2e.streamed_fixed_updates")
                offsets = _sum_scores_host(base, others)
            else:
                offsets = _sum_scores(base, others)
            model, stats = coord.train(offsets, warm_start=models.get(name),
                                       prior=priors.get(name))
            models[name] = model
            scores[name] = coord.score(model)
            coordinate_stats[name].append(stats)
            if streamed:
                scores[name] = _to_host_score(scores[name])
                objective_history.append(_objective_streamed(
                    task, y, weights, offsets, scores[name], obj_chunk_rows,
                    dev))
            else:
                objective_history.append(
                    _objective_at(task, y, weights, offsets, scores[name]))
    if streamed:
        objective_history = [float(v) for v in objective_history]
    elif objective_history:
        objective_history = [float(v) for v in torch.stack(
            objective_history).cpu().tolist()]
    ordered = {name: models[name] for name in update_sequence}
    for name in coordinates:  # score-only coordinates outside the sequence
        if name in models and name not in ordered:
            ordered[name] = models[name]
    return CoordinateDescentResult(GameModel(ordered, task),
                                   objective_history, coordinate_stats)
