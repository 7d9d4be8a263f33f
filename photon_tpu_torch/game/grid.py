"""Vectorized GAME regularization grids: coordinate descent with a lane
axis (port of `GridFitOutcome`, `fit_game_grid`, `_lane_offsets` and
`lane_re_margins` of `photon_tpu/game/grid.py`, on one device or a
mesh).

Reference parity: com.linkedin.photon.ml.estimators.GameEstimator's grid
mode trains one full job per GameOptimizationConfiguration. Here every
grid point is a LANE: each coordinate update solves all G lanes at once,
sharing every pass over the lane-invariant design matrices.

- The fixed effect solves its G lanes lock-step (the lane L-BFGS, OWL-QN
  or TRON of `models.training._lane_solve`) with (n, G) per-lane offsets —
  every other coordinate's scores differ per lane — so each X pass is one
  (n, d) × (d, G) product.
- A random effect solves (entity × grid point) lanes, entity-major, each
  entity's rows shared by its G lanes through a lane → entity map
  (`RandomEffectCoordinate.solve_block_grid`, `EntityBlocks.grid`), never
  copied G times.
- Scores are (n, G) per coordinate on the device; after each update the
  per-lane objective (G,) stays there too, read back once at the end.

On a mesh (reference: `fit_game_grid(mesh=)`) the fixed batch is
row-sharded over the slots, padded to a slot multiple, its lanes closing
each evaluation with one slot-ordered reduction, and its (n, G) margins
gathered in slot order; a bucket's (entity × grid point) lanes split by
entity over the slots (`RandomEffectCoordinate.solve_block_grid_mesh`),
one gather per bucket. The starts are whole on every process, as the
reference's replicated ``w0s``.

Semantics against the sequential path: the same per grid point — each
lane runs the same sweeps, warm-starting every update from its own
previous state — except that warm starts cannot chain ACROSS grid points
(every lane starts from zeros), the contract of
`models.training.train_glm_grid`. Projection, normalization, priors and
host-chunked or blocked-ELL shards keep the sequential path (the
estimator's gate, `GameEstimator._game_grid_probe` and
`_grid_data_supported`); here they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.dataset import ChunkedMatrix, GLMBatch
from photon_tpu_torch.data.matrix import PERMUTED_LAYOUTS, matvec_lanes
from photon_tpu_torch.game.coordinate_descent import coordinate_device
from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel, padded_coeffs,
                                         score_rows)
from photon_tpu_torch.game.random_effect import RETrainStats
from photon_tpu_torch.game.scoring import mesh_margins
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.models.training import (_lane_result, _lane_solve,
                                              _to_host, lane_weight_arrays,
                                              make_objective)
from photon_tpu_torch.models.variance import compute_variances_lanes
from photon_tpu_torch.ops.losses import TaskType, loss_fns
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.parallel.mesh import SlotRows, check_mesh, local_rows


def _lane_offsets(base: torch.Tensor, scores, G: int) -> torch.Tensor:
    """(n, G) per-lane offsets: the (n,) base plus every other
    coordinate's (n, G) lane scores."""
    total = base[:, None].expand(base.shape[0], G)
    for s in scores:
        total = total + s
    return total.contiguous()


def lane_re_margins(C: torch.Tensor, X, dense_ids) -> torch.Tensor:
    """(G, n) random-effect margins of (G, E, d) lane tables (validation
    scoring); ``dense_ids`` (n,) with E for an unseen entity."""
    return score_rows(X, padded_coeffs(C, dense_ids))


def _lane_objective(task: TaskType, y, weights, offs, margins):
    """(G,) total weighted loss of every lane: (n, G) offsets and
    margins."""
    loss, _, _ = loss_fns(task)
    return torch.sum(weights[:, None] * loss(offs + margins, y[:, None]),
                     dim=0)


@dataclasses.dataclass
class GridFitOutcome:
    """Per-lane results of a vectorized GAME grid fit."""

    lane_models: list  # [GameModel] in lane order
    objective_histories: list  # [[float]] per lane, one entry per update
    coordinate_stats: list  # [{name: [OptResult | RETrainStats]}] per lane
    stacked: dict  # name -> (G, d) W or (G, E, d) C, on the device


def _refuse(coord, name: str) -> None:
    X = coord.dataset.X
    if isinstance(coord, FixedEffectCoordinate):
        if isinstance(X, SlotRows):
            X = X.parts[0]
        if isinstance(X, PERMUTED_LAYOUTS + (ChunkedMatrix,)):
            raise ValueError(
                f"fit_game_grid: coordinate {name!r} has a "
                f"{type(X).__name__} shard; the estimator routes those "
                "sequentially")
    elif coord.dataset.projection is not None:
        raise ValueError(
            "fit_game_grid does not support projected random-effect "
            "coordinates (the estimator routes them sequentially)")
    if coord.normalization is not None and \
            not coord.normalization.is_identity:
        raise ValueError(
            f"fit_game_grid: coordinate {name!r} is normalized; the "
            "estimator routes normalized models sequentially")


def fit_game_grid(coordinates: dict, lane_weights: dict, y, weights,
                  base_offsets, task: TaskType, update_sequence=None,
                  n_sweeps: int = 1, mesh: Optional[object] = None
                  ) -> GridFitOutcome:
    """Run the whole coordinate-descent grid with a lane axis.

    ``coordinates``: name -> FixedEffectCoordinate | RandomEffectCoordinate
    built from the BASE configs (reg weights are per-lane values);
    ``lane_weights``: name -> G reg weights, one per grid point (constant
    for a coordinate the grid does not vary). On the coordinates' device,
    or with ``mesh`` over its slots (the module docstring)."""
    check_mesh(mesh)
    seq = list(update_sequence) if update_sequence else list(coordinates)
    trained = list(dict.fromkeys(seq))
    G = len(next(iter(lane_weights.values())))
    dev = coordinate_device(next(iter(coordinates.values())))

    def col(v):
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        return t.to(dev, torch.float32)

    y, weights, base = col(y), col(weights), col(base_offsets)

    prep: dict = {}
    state: dict = {}
    var_state: dict = {}
    for name in trained:
        coord = coordinates[name]
        _refuse(coord, name)
        l2s, l1s, static_cfg = lane_weight_arrays(coord.config,
                                                  lane_weights[name])
        l2s = l2s.to(dev)
        l1s = None if l1s is None else l1s.to(dev)
        ds = coord.dataset
        if isinstance(coord, FixedEffectCoordinate):
            obj = make_objective(task, coord.config, ds.dim, device=dev)
            cols = None
            if mesh is not None:  # X row-sharded once, its rows kept
                from photon_tpu_torch.data.dataset import mesh_batch

                mb = (mesh_batch(GLMBatch(ds.X, y, weights,
                                          torch.zeros_like(y)), mesh)
                      if ds.mesh is None else ds)
                cols = (mb.X, mb.y, mb.weights)
            prep[name] = (obj, l2s, l1s, static_cfg, cols)
            state[name] = torch.zeros((G, ds.dim), dtype=torch.float32,
                                      device=dev)
        else:
            ents = [torch.from_numpy(b.entity_index).to(dev).long()
                    for b in ds.blocks]
            ids = torch.from_numpy(ds.entity_dense).to(dev)
            prep[name] = (ents, l2s, l1s, static_cfg, ids)
            state[name] = torch.zeros((G, ds.n_entities, ds.dim),
                                      dtype=torch.float32, device=dev)
        var_state[name] = None

    scores: dict = {}
    history: list = []  # (G,) device objectives, one per update
    stats_acc: dict = {name: [] for name in trained}
    for _ in range(n_sweeps):
        for name in seq:
            coord = coordinates[name]
            ds = coord.dataset
            offs = _lane_offsets(
                base, tuple(s for o, s in scores.items() if o != name), G)
            if isinstance(coord, FixedEffectCoordinate):
                obj, l2s, l1s, cfg, cols = prep[name]
                if cols is None:
                    batch = GLMBatch(ds.X, y, weights, offs)
                else:
                    batch = GLMBatch(*cols, local_rows(
                        mesh, offs, cols[0].n_rows))
                res = _lane_solve(obj, batch, state[name].t().contiguous(),
                                  l2s, l1s, cfg)
                var = compute_variances_lanes(obj, l2s, res.w, batch,
                                              coord.variance)
                margins = (matvec_lanes(ds.X, res.w) if cols is None
                           else mesh_margins(cols[0], res.w,
                                             int(y.shape[0])))
                res = _lane_result(res)
                state[name] = res.w
                var_state[name] = None if var is None else var.t()
                stats_acc[name].append(("fixed", res))
            else:
                ents_b, l2s, l1s, cfg, ids = prep[name]
                C, V = state[name], var_state[name]
                E, d = int(C.shape[1]), int(C.shape[2])
                acc = torch.zeros((3, G), dtype=torch.int64, device=dev)
                its_pe = torch.zeros((G, E), dtype=torch.int64, device=dev)
                for block, ents in zip(ds.blocks, ents_b):
                    e = int(ents.shape[0])
                    W0 = C[:, ents, :].permute(2, 1, 0).reshape(d, e * G)
                    if mesh is None:
                        w, var, conv, fail, its = coord.solve_block_grid(
                            block, offs, W0, l2s, l1s, cfg)
                    else:
                        w, var, conv, fail, its = \
                            coord.solve_block_grid_mesh(
                                mesh, block, offs, W0, l2s, l1s, cfg)
                    C[:, ents, :] = w.reshape(d, e, G).permute(2, 1, 0)
                    if var is not None:
                        if V is None:
                            V = torch.zeros_like(C)
                        V[:, ents, :] = var.reshape(d, e, G).permute(2, 1, 0)
                    per = torch.stack([conv.to(torch.int64),
                                       fail.to(torch.int64),
                                       its.to(torch.int64)]).reshape(3, e, G)
                    acc += per.sum(dim=1)
                    its_pe[:, ents] = per[2].t()
                var_state[name] = V
                margins = lane_re_margins(C, ds.X, ids).t()
                stats_acc[name].append(("random", (E, acc, its_pe)))
            scores[name] = margins
            history.append(_lane_objective(task, y, weights, offs, margins))

    histories = torch.stack(history).t().cpu().double().tolist() \
        if history else [[] for _ in range(G)]
    return GridFitOutcome(
        lane_models=_lane_models(coordinates, trained, state, var_state,
                                 task, G),
        objective_histories=histories,
        coordinate_stats=_lane_stats(trained, stats_acc, G),
        stacked=state)


def _lane_models(coordinates, trained, state, var_state, task, G) -> list:
    """One GameModel per lane, its tables views of the stacked state."""
    out = []
    for g in range(G):
        coords_g = {}
        for name in trained:
            coord = coordinates[name]
            ds = coord.dataset
            v = var_state[name]
            if isinstance(coord, FixedEffectCoordinate):
                glm = GeneralizedLinearModel(
                    Coefficients(state[name][g],
                                 None if v is None else v[g]), task)
                coords_g[name] = FixedEffectModel(glm, ds.shard_name)
            else:
                coords_g[name] = RandomEffectModel(
                    entity_name=ds.entity_name, feature_shard=ds.shard_name,
                    task=task, coefficients=state[name][g],
                    entity_keys=ds.entity_keys, key_to_index=ds.key_to_index,
                    variances=None if v is None else v[g])
        out.append(GameModel(coords_g, task))
    return out


def _lane_stats(trained, stats_acc, G) -> list:
    """Per lane, per coordinate, its per-update stats, from one host
    transfer: an `OptResult` per fixed update, `RETrainStats` (with the
    lane's iterations per entity) per random one."""
    flat = []
    for name in trained:
        for kind, payload in stats_acc[name]:
            if kind == "fixed":
                flat += [payload.value, payload.grad_norm,
                         payload.iterations, payload.converged,
                         payload.failed, payload.loss_history,
                         payload.grad_norm_history]
            else:
                flat += [payload[1], payload[2]]
    host = iter(_to_host(flat) if flat else [])
    per_name = {}
    for name in trained:
        ups = []
        for kind, payload in stats_acc[name]:
            if kind == "fixed":
                parts = [next(host) for _ in range(7)]
                ups.append(("fixed", payload, parts))
            else:
                ups.append(("random", payload[0], next(host), next(host)))
        per_name[name] = ups
    out = []
    for g in range(G):
        stats_g = {}
        for name in trained:
            lst = []
            for up in per_name[name]:
                if up[0] == "fixed":
                    res, (value, gnorm, its, conv, fail, hist, ghist) = \
                        up[1], up[2]
                    lst.append(OptResult(
                        w=res.w[g], value=value[g], grad_norm=gnorm[g],
                        iterations=int(its[g]), converged=conv[g],
                        failed=fail[g], loss_history=hist[g],
                        grad_norm_history=ghist[g],
                        evaluations=res.evaluations, hvps=res.hvps,
                        trials=res.trials))
                else:
                    E, acc, its_pe = up[1], up[2], up[3]
                    lst.append(RETrainStats(
                        E, int(acc[0, g]), int(acc[1, g]), int(acc[2, g]),
                        its_pe[g].numpy()))
            stats_g[name] = lst
        out.append(stats_g)
    return out
