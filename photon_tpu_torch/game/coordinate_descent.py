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
to the same models (ROADMAP speed work, beside item 1); random effects
train on the pipelined block loop (`RandomEffectCoordinate.train`).

Elastic runs: under a `checkpoint` session the descent scopes its state
as ``game-<fingerprint>-<invocation>`` (the fingerprint hashes the
problem, so grid points apart never share state), each update under a
``u<k>`` sub-scope that is cleared when the update completes. After each
complete update it publishes the progress cut — every updated
coordinate's model and SCORES (stored, not recomputed, so a resumed
run's low bits match), the objective history and compact stats — and a
restore skips the done updates (``checkpoint.descent_restores``). In the
streamed regime restored scores stay host caches. Resumed stats carry
the scalars; per-iteration histories and per-entity arrays died with the
original process and come back as NaN or None.

STREAMED regime: when any coordinate's shard is a host `ChunkedMatrix`
(data larger than device memory), the margin exchange moves to the host,
as the reference's does: every coordinate's score is a host (n,) f32
cache, offsets are numpy sums over those caches, and the tracking
objective sums chunk by chunk (a device partial per slice, the totals in
f64 on the host), so no dataset-sized vector lives on the device. It
keeps the reference's ``game_e2e.*`` counters in `telemetry`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import checkpoint as _ckpt
from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix
from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_tpu_torch.game.random_effect import (RandomEffectCoordinate,
                                                 RETrainStats)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops.losses import TaskType, loss_fns
from photon_tpu_torch.optim.tracker import OptResult

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


# ------------------------------------------------- checkpoint (de)hydration
# The reference's payload layout (`photon_tpu/game/coordinate_descent.py`),
# plus the port's work counts in a fixed effect's stats entry.
def _descent_fingerprint(coordinates, update_sequence, n_sweeps, locked,
                         task, n_rows) -> str:
    """Stable identity of one descent invocation: restored state is only
    accepted by a loop solving the SAME problem (grid points with
    different reg weights hash apart)."""
    parts = []
    for name in update_sequence:
        c = coordinates[name]
        cfg = c.config
        parts.append((
            name, type(c).__name__, cfg.effective_optimizer().value,
            cfg.max_iters, cfg.tolerance, cfg.history, cfg.cg_max_iters,
            cfg.reg.reg_type.value, cfg.reg.alpha, float(cfg.reg_weight),
            cfg.regularize_intercept,
            getattr(c, "pipeline_depth", None),
            getattr(c, "straggler_budget", None),
        ))
    ident = repr((task.name, n_sweeps, tuple(update_sequence),
                  tuple(sorted(locked)), int(n_rows), parts))
    return hashlib.sha1(ident.encode()).hexdigest()[:12]


def _model_from_progress(progress, name, kind, coord, task, dev):
    def t(key):
        v = progress.get(key)
        return None if v is None else torch.from_numpy(
            np.ascontiguousarray(v)).to(dev)

    var = t(f"m.{name}.var")
    if kind == "fixed":
        return FixedEffectModel(GeneralizedLinearModel(
            Coefficients(t(f"m.{name}.w"), var), task),
            coord.dataset.shard_name)
    ds = coord.dataset
    return RandomEffectModel(
        entity_name=ds.entity_name, feature_shard=ds.shard_name, task=task,
        coefficients=t(f"m.{name}.coeffs"), entity_keys=ds.entity_keys,
        key_to_index=ds.key_to_index, variances=var)


def _stats_from_entry(entry, models):
    """A per-update stats record from its progress entry: the scalars;
    per-iteration histories come back as NaN."""
    if entry["kind"] == "re":
        return RETrainStats(int(entry["E"]), int(entry["c"]),
                            int(entry["f"]), int(entry["it"]))
    w = models[entry["name"]].model.coefficients.means
    dev = w.device

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    nan = torch.full((1,), float("nan"), dtype=torch.float32, device=dev)
    return OptResult(
        w=w, value=scalar(np.float32(entry["value"])),
        grad_norm=scalar(np.float32(entry["grad_norm"])),
        iterations=int(entry["iterations"]),
        converged=scalar(bool(entry["converged"]), torch.bool),
        failed=scalar(bool(entry["failed"]), torch.bool),
        loss_history=nan, grad_norm_history=nan,
        evaluations=int(entry.get("evaluations", 0)),
        hvps=int(entry.get("hvps", 0)), trials=int(entry.get("trials", 0)))


def _stat_entry(name: str, stats) -> dict:
    if isinstance(stats, RETrainStats):
        return {"name": name, "kind": "re", "E": stats.n_entities,
                "c": stats.n_converged, "f": stats.n_failed,
                "it": stats.total_iterations}
    return {"name": name, "kind": "fixed", "value": float(stats.value),
            "grad_norm": float(stats.grad_norm),
            "iterations": int(stats.iterations),
            "converged": bool(stats.converged),
            "failed": bool(stats.failed),
            "evaluations": int(stats.evaluations), "hvps": int(stats.hvps),
            "trials": int(stats.trials)}


def _progress_payload(updated, models, scores, objective_history,
                      stats_entries, n_done) -> dict:
    payload = {"kind": "descent_progress", "n_done": int(n_done),
               "objective": [float(v) for v in objective_history],
               "stats": list(stats_entries),
               "updated": dict(updated)}
    for name in updated:
        m = models[name]
        if isinstance(m, FixedEffectModel):
            payload[f"m.{name}.w"] = m.model.coefficients.means
            if m.model.coefficients.variances is not None:
                payload[f"m.{name}.var"] = m.model.coefficients.variances
        else:
            payload[f"m.{name}.coeffs"] = m.coefficients
            if m.variances is not None:
                payload[f"m.{name}.var"] = m.variances
        payload[f"s.{name}"] = scores[name]
    return payload


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

    ck = _ckpt.current()
    cd_scope = contextlib.nullcontext()
    if ck is not None:
        fp = _descent_fingerprint(coordinates, update_sequence, n_sweeps,
                                  locked, task, int(y.shape[0]))
        cd_scope = ck.scope(f"game-{fp}-{ck.invocation(fp)}")
    done_updates = 0
    stats_entries: list = []
    updated: dict = {}  # coordinate name -> "fixed" | "re", updated so far
    update_log: list = []  # (sweep, coordinate) per objective_history entry
    with cd_scope:
        progress = ck.restore("progress") if ck is not None else None
        if progress is not None:
            done_updates = int(progress["n_done"])
            objective_history = [float(v) for v in progress["objective"]]
            stats_entries = list(progress["stats"])
            updated = dict(progress["updated"])
            for name, kind in updated.items():
                c_dev = coordinate_device(coordinates[name])
                models[name] = _model_from_progress(
                    progress, name, kind, coordinates[name], task, c_dev)
                s_np = np.asarray(progress[f"s.{name}"], np.float32)
                # the streamed regime's restored scores stay host caches
                scores[name] = (s_np if streamed else
                                torch.from_numpy(s_np).to(c_dev))
            for e in stats_entries:
                coordinate_stats[e["name"]].append(
                    _stats_from_entry(e, models))
            telemetry.count("checkpoint.descent_restores")

        upd = -1
        for sweep in range(n_sweeps):
            telemetry.count("game.sweeps")
            for name in update_sequence:
                if name in locked:
                    continue
                upd += 1
                update_log.append((sweep, name))
                if upd < done_updates:
                    continue  # restored from the checkpoint image above
                telemetry.count("game.coordinate_updates")
                coord = coordinates[name]
                others = tuple(s for o, s in scores.items() if o != name)
                if streamed:
                    if name in chunked:
                        telemetry.count("game_e2e.streamed_fixed_updates")
                    offsets = _sum_scores_host(base, others)
                else:
                    offsets = _sum_scores(base, others)
                # per-update sub-scope: a live random-effect update's
                # bucket-level state lands under u<k>/re
                u_scope = (ck.scope(f"u{upd}") if ck is not None
                           else contextlib.nullcontext())
                with u_scope:
                    model, stats = coord.train(
                        offsets, warm_start=models.get(name),
                        prior=priors.get(name))
                models[name] = model
                scores[name] = coord.score(model)
                coordinate_stats[name].append(stats)
                if streamed:
                    scores[name] = _to_host_score(scores[name])
                    objective_history.append(_objective_streamed(
                        task, y, weights, offsets, scores[name],
                        obj_chunk_rows, dev))
                else:
                    objective_history.append(
                        _objective_at(task, y, weights, offsets,
                                      scores[name]))
                if ck is not None:
                    # the update is complete: drop its sub-scope state,
                    # force its objective to the host, and publish the
                    # progress cut (updates 0..upd done)
                    ck.clear(f"u{upd}", prefix=True)
                    objective_history[-1] = float(objective_history[-1])
                    stats_entries.append(_stat_entry(name, stats))
                    updated[name] = ("fixed" if isinstance(
                        model, FixedEffectModel) else "re")
                    ck.update("progress", _progress_payload(
                        updated, models, scores, objective_history,
                        stats_entries, upd + 1))
                    ck.note_evaluations()
                    ck.maybe_snapshot()
    if streamed:
        objective_history = [float(v) for v in objective_history]
    elif objective_history:
        objective_history = [float(v) for v in torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=dev)
            for v in objective_history]).cpu().tolist()]
    if telemetry.enabled():
        # the GAME iteration stream: one event per coordinate update, in
        # update order, after the one batched read-back of the objectives
        for i, ((sweep, name), obj_v) in enumerate(
                zip(update_log, objective_history)):
            telemetry.iteration("game_descent", i, obj_v,
                                coordinate=name, sweep=sweep)
    ordered = {name: models[name] for name in update_sequence}
    for name in coordinates:  # score-only coordinates outside the sequence
        if name in models and name not in ordered:
            ordered[name] = models[name]
    return CoordinateDescentResult(GameModel(ordered, task),
                                   objective_history, coordinate_stats)


# ----------------------------------------------------------------- contracts
# The GAME descent's fixed-effect update (offsets sum + solve + margins +
# objective) makes no collective and only the solver's pinned read-backs;
# a streamed fixed effect's evaluation on a mesh accumulates its chunk
# partials collective-free and closes with ONE psum.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402


@register_contract(
    name="game_fixed_update",
    description="the fixed-effect coordinate update: offsets sum + L-BFGS "
                "solve + margins + objective with zero communication, its "
                "host syncs held to the solver's pinned read-backs",
    # the 5-iteration L-BFGS's own syncs (ROADMAP speed item 1)
    collectives={}, max_syncs={"cuda": 20, "cpu": 6}, tags=("game",))
def _contract_game_fixed_update(device):
    from photon_tpu_torch.game.dataset import FixedEffectDataset, GameData
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    n, d = 32, 6
    rng = np.random.default_rng(0)
    task = TaskType.LOGISTIC_REGRESSION
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = GameData.build(y, {"g": rng.normal(size=(n, d)).astype(
        np.float32)})
    coord = FixedEffectCoordinate(
        FixedEffectDataset.build(data, "g", device=device), task,
        OptimizerConfig(max_iters=5, tolerance=1e-7, reg=l2(),
                        reg_weight=0.4, history=3))
    dev = torch.device(device)
    yv, wv = _column(y, dev), torch.ones(n, device=dev)

    def fn(base, scores):
        offsets = _sum_scores(base, scores)
        model, _ = coord.train(offsets)
        return _objective_at(task, yv, wv, offsets, coord.score(model))

    base = torch.zeros(n, device=dev)
    scores = (_column(0.1 * rng.normal(size=n), dev),)
    return fn, (base, scores)


@register_contract(
    name="game_streamed_fixed_evaluation",
    description="one streamed fixed-effect objective evaluation on an "
                "8-slot mesh: two chunks' partials accumulate "
                "collective-FREE, then close with exactly ONE psum (the "
                "whole evaluation's communication)",
    collectives={"psum": 1}, tags=("game", "mesh-streamed"))
def _contract_game_streamed_fixed_evaluation(device):
    from photon_tpu_torch.optim.streamed import (_MeshStream, _acc,
                                                 _contract_problem)
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=8, device=device)
    obj, w, data = _contract_problem(device, mesh)
    stream = _MeshStream(data, mesh)
    chunks = [b for _, b in stream.iter_chunks()]
    z = stream.host_margins()

    def fn(o, wv, c0, c1):
        acc = _acc(None, stream.chunk_init(o, wv, c0, z[0]))
        acc = _acc(acc, stream.chunk_init(o, wv, c1, z[1]))
        return stream.finish(o, wv, acc)

    return fn, (obj, w, chunks[0], chunks[1])
