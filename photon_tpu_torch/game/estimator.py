"""GameEstimator: train GAME models over candidate configurations and
select the best on validation data (port of `photon_tpu/game/
estimator.py`: `FixedEffectConfig`, `RandomEffectConfig`,
`GameFitResult`, `GameEstimator`).

Reference parity: com.linkedin.photon.ml.estimators.GameEstimator — fit()
takes a sequence of per-coordinate configurations and trains one GameModel
per configuration, each warm-started from the previous one when enabled,
evaluates each on the validation data, and `best_model` picks by the
evaluator's direction (GameTrainingDriver.selectBestModel). Datasets (the
entity bucketing) and coordinates are cached across grid points and
across fits of the same data.

A reg-weight grid without warm starts takes the reference's vectorized
paths where its ``would_vectorize`` does: a lone fixed effect over one
sweep is one `train_glm_grid` sweep plus one batched scoring pass per
matrix (`_fit_fixed_grid`); a GAME model whose grid varies only reg
weights runs every grid point as a lane of one coordinate descent
(`game.grid.fit_game_grid`, dense and `SparseRows` shards only, as the
reference's `_grid_data_supported`).

On the port's device (CUDA unless ``device="cpu"``), one device; the
validation data moves there once per fit and every metric runs there. A
fixed effect's shard may be a host `ChunkedMatrix`: its solves stream and
the descent exchanges its margins on the host. A random effect's
``straggler_budget`` caps its first pass and re-solves the lanes left
over as one gathered block (`RandomEffectCoordinate.train`).

With ``mesh`` (a `parallel.mesh.Mesh`) every coordinate gets it: a fixed
effect's shard is row-sharded over the slots once per dataset and solves
through `train_glm(mesh=)`, a random effect's buckets split their entity
lanes over the slots, and the data, the descent's offsets and scores and
every model live on the mesh's home device, whole on every process.
Both vectorized grids run on it, as in the reference: the fixed-effect
grid through `train_glm_grid(mesh=)`, the lane-axis GAME grid through
`fit_game_grid(mesh=)`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix
from photon_tpu_torch.data.matrix import (PERMUTED_LAYOUTS,
                                          SHARDED_LAYOUTS, HybridRows,
                                          last_column_is_intercept)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.evaluation.evaluator import (Evaluator,
                                                   default_evaluator,
                                                   evaluate_with_entity)
from photon_tpu_torch.game.coordinate_descent import (CoordinateDescentResult,
                                                      coordinate_descent)
from photon_tpu_torch.game.dataset import (FixedEffectDataset, GameData,
                                           RandomEffectDataset)
from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import FixedEffectModel, GameModel
from photon_tpu_torch.game.random_effect import RandomEffectCoordinate
from photon_tpu_torch.game.scoring import score_game
from photon_tpu_torch.models.variance import VarianceComputationType
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig
from photon_tpu_torch.parallel.mesh import check_mesh


@dataclasses.dataclass(frozen=True)
class FixedEffectConfig:
    """Reference: FixedEffectCoordinateConfiguration (shard + optimizer)."""

    feature_shard: str
    optimizer: OptimizerConfig = OptimizerConfig()


@dataclasses.dataclass(frozen=True)
class RandomEffectConfig:
    """Reference: RandomEffectCoordinateConfiguration (entity type, shard,
    optimizer, active-data cap, projection, and the block loop's knobs)."""

    entity_name: str
    feature_shard: str
    optimizer: OptimizerConfig = OptimizerConfig()
    active_cap: Optional[int] = None
    projection: Optional[object] = None  # game.projector.ProjectionConfig
    pipeline_depth: int = 1
    straggler_budget: Optional[int] = None


CoordinateConfig = FixedEffectConfig | RandomEffectConfig

# Auto-mode lane-axis gate of the reference: reg-weight spread (max/min
# across lanes) above which lock-step lanes are assumed to lose to the
# sequential path.
_GRID_SKEW_MAX = 1e4


@dataclasses.dataclass
class GameFitResult:
    """One (configuration → model) outcome."""

    model: GameModel
    descent: CoordinateDescentResult
    configs: dict  # name -> CoordinateConfig actually used
    validation_score: Optional[float] = None


@dataclasses.dataclass
class GameEstimator:
    """Reference: estimators.GameEstimator."""

    task: TaskType
    coordinate_configs: dict  # name -> CoordinateConfig (order = sequence)
    update_sequence: Optional[list] = None
    n_sweeps: int = 2
    mesh: Optional[object] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    locked: frozenset = frozenset()
    incremental: frozenset = frozenset()
    warm_start: bool = True
    # the validation metric (default: the task's, `default_evaluator`)
    evaluator: Optional[Evaluator] = None
    # entity-id column the sharded evaluators group by (default: the first
    # random-effect coordinate's entity type)
    evaluator_entity: Optional[str] = None
    # coordinate name → a NormalizationType (the context built from that
    # coordinate's design matrix) or a prebuilt NormalizationContext
    normalization: dict = dataclasses.field(default_factory=dict)
    vectorized_grid: Optional[bool] = None
    device: Optional[object] = None
    # per-training-data caches of bucketed datasets and coordinates, kept
    # across fit() calls; keyed by the GameData object's identity, with a
    # strong reference so an id() is never reused while cached
    _caches: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)

    def _caches_for(self, data) -> tuple[dict, dict]:
        entry = self._caches.get(id(data))
        if entry is None or entry[0] is not data:
            entry = (data, {}, {})
            self._caches[id(data)] = entry
        return entry[1], entry[2]

    @staticmethod
    def _dataset_key(cfg: CoordinateConfig) -> tuple:
        """Fields that change the dataset (not just the solve)."""
        if isinstance(cfg, FixedEffectConfig):
            return ("fixed", cfg.feature_shard)
        return ("random", cfg.entity_name, cfg.feature_shard,
                cfg.active_cap, cfg.projection)

    def _device(self):
        return self.mesh.home if self.mesh is not None else self.device

    def _build_dataset(self, data: GameData, cfg: CoordinateConfig):
        if isinstance(cfg, FixedEffectConfig):
            return FixedEffectDataset.build(data, cfg.feature_shard,
                                            device=self.device,
                                            mesh=self.mesh)
        return RandomEffectDataset.build(
            data, cfg.entity_name, cfg.feature_shard,
            active_cap=cfg.active_cap, projection=cfg.projection,
            device=self._device())

    def _build_coordinates(self, datasets: dict, configs: dict,
                           cache: Optional[dict] = None) -> dict:
        """Coordinates cached by (dataset key, optimizer config, block-loop
        knobs), so a grid point that changes only OTHER coordinates reuses
        this one."""
        coords = {}
        for name, cfg in configs.items():
            knobs = ((cfg.pipeline_depth, cfg.straggler_budget)
                     if isinstance(cfg, RandomEffectConfig) else ())
            key = (self._dataset_key(cfg), cfg.optimizer, knobs)
            if cache is not None and key in cache:
                coords[name] = cache[key]
                continue
            norm = self._normalization_for(name, datasets[name])
            if isinstance(cfg, FixedEffectConfig):
                coord = FixedEffectCoordinate(
                    datasets[name], self.task, cfg.optimizer,
                    mesh=self.mesh, variance=self.variance,
                    normalization=norm)
            else:
                coord = RandomEffectCoordinate(
                    datasets[name], self.task, cfg.optimizer,
                    mesh=self.mesh, variance=self.variance,
                    normalization=norm, pipeline_depth=cfg.pipeline_depth,
                    straggler_budget=cfg.straggler_budget)
            if cache is not None:
                cache[key] = coord
            coords[name] = coord
        return coords

    def _normalization_for(self, name: str, dataset):
        """This coordinate's NormalizationContext (built from the dataset's
        design matrix when a bare NormalizationType was given; the
        intercept-last convention detected, not assumed)."""
        from photon_tpu_torch.data.normalization import (NormalizationContext,
                                                         NormalizationType)

        spec = self.normalization.get(name)
        if spec is None:
            return None
        if isinstance(spec, NormalizationContext):
            return spec
        if isinstance(spec, NormalizationType):
            X = getattr(dataset, "host", None)
            X = dataset.X if X is None else X  # a row-sharded shard's own
            icpt = -1 if last_column_is_intercept(X) else None
            if spec is NormalizationType.STANDARDIZATION and icpt is None:
                raise ValueError(
                    f"normalization[{name!r}]: STANDARDIZATION requires an "
                    "intercept column (all-ones, last) in the feature shard")
            return NormalizationContext.build(X, spec, intercept_index=icpt)
        raise TypeError(
            f"normalization[{name!r}] must be a NormalizationType or "
            f"NormalizationContext, got {type(spec)}")

    def fit(self, data: GameData, validation: Optional[GameData] = None,
            config_grid: Optional[list] = None,
            initial_models: Optional[dict] = None) -> list:
        """Train one GameModel per candidate configuration, each scored on
        ``validation`` (its ``validation_score``) when given.

        ``config_grid``: list of {name -> CoordinateConfig} overrides, one
        model per entry (None: one model with ``coordinate_configs``).
        Successive models warm-start from the previous one when
        ``warm_start`` — except on the vectorized grid paths, whose lanes
        run concurrently from zeros. Datasets are cached per (shard,
        entity, active_cap, projection), so overrides that change only the
        optimizer reuse the bucketed blocks."""
        check_mesh(self.mesh)
        dev = resolve_device(self._device())
        grid = config_grid or [self.coordinate_configs]
        telemetry.count("game.grid_points", len(grid))
        evaluator = self.evaluator or default_evaluator(self.task)
        if self._chunked_shards(data):
            # the streamed regime: fixed effects stream their host-chunked
            # shards; the descent exchanges margins on the host
            telemetry.count("game_e2e.chunked_fit_points", len(grid))
        dataset_cache, coord_cache = self._caches_for(data)
        if validation is not None:
            # one transfer for the whole grid: every point scores the same
            # validation shards
            validation = validation.to_device(dev)
        chain_warm = self.warm_start
        if self.would_vectorize(grid, initial_models):
            if self.n_sweeps == 1 and not self._chunked_shards(data):
                probe = self._fixed_only_reg_grid(grid)
                if probe is not None and self._fixed_seq_ok(probe):
                    # a lone fixed effect, one sweep: one train_glm_grid
                    return self._fit_fixed_grid(probe, data, validation,
                                                evaluator, dataset_cache)
            lanes = self._game_grid_probe(grid)
            if lanes is not None:
                if self._grid_data_supported(data):
                    return self._fit_game_grid(lanes, data, validation,
                                               evaluator, dataset_cache,
                                               coord_cache)
                # the vectorized contract (no warm starts across grid
                # points) holds on the unsupported-layout fallback too, so
                # results do not depend on the matrix representation
                chain_warm = False

        results: list[GameFitResult] = []
        prev_models = dict(initial_models or {})
        # incremental priors come from the USER's initial models and stay
        # fixed across the whole grid (warm starts move, priors don't)
        user_priors = {n: prev_models[n] for n in self.incremental
                       if n in prev_models}
        missing = self.incremental - set(user_priors)
        if missing:
            raise ValueError(
                f"incremental coordinates {sorted(missing)} need "
                "initial_models")
        for overrides in grid:
            configs = {**self.coordinate_configs, **overrides}
            datasets = self._datasets_for(data, configs, dataset_cache)
            coords = self._build_coordinates(datasets, configs, coord_cache)
            with telemetry.span("game.fit_point", index=len(results)):
                descent = coordinate_descent(
                    coords, data.y, data.weights, data.offsets, self.task,
                    update_sequence=self.update_sequence,
                    n_sweeps=self.n_sweeps, locked=self.locked,
                    initial_models=prev_models,
                    incremental=self.incremental, priors=user_priors)
            result = GameFitResult(descent.model, descent, configs)
            if validation is not None:
                telemetry.count("game.validate_point")
                result.validation_score = self._evaluate(
                    evaluator, score_game(descent.model, validation),
                    validation)
            results.append(result)
            if chain_warm:
                prev_models = dict(descent.model.coordinates)
        return results

    # ------------------------------------------- the reference's grid gate
    def would_vectorize(self, grid, initial_models=None, data=None) -> bool:
        """Whether the reference's fit(config_grid=grid) would take a
        vectorized grid path (the one-program fixed-effect grid, or the
        lane-axis GAME grid); with ``data``, also whether its layouts are
        ones that path supports. The same answer as the reference's."""
        vectorize = (self.vectorized_grid is True
                     or (self.vectorized_grid is None
                         and not self.warm_start
                         and self._grid_reg_skew(grid) <= _GRID_SKEW_MAX))
        if not (vectorize and len(grid) >= 2
                and not self.locked and not self.incremental
                and not initial_models):
            return False
        if self.n_sweeps == 1 and (data is None
                                   or not self._chunked_shards(data)):
            probe = self._fixed_only_reg_grid(grid)
            if probe is not None and self._fixed_seq_ok(probe):
                return True
        if self._game_grid_probe(grid) is None:
            return False
        return data is None or self._grid_data_supported(data)

    def _chunked_shards(self, data: GameData) -> bool:
        """Whether any coordinate's shard is host-chunked: those solves
        are host loops, so every vectorized grid path falls back to the
        sequential sweep."""
        return any(isinstance(data.shards[c.feature_shard], ChunkedMatrix)
                   for c in self.coordinate_configs.values())

    def _grid_reg_skew(self, grid) -> float:
        """Max over coordinates of the grid's reg-weight spread (a zero
        weight among positive ones counts as ≤ 1e-4)."""
        skew = 1.0
        for name in set().union(*[set(g) for g in grid]) if grid else ():
            ws = [float(g[name].optimizer.reg_weight)
                  for g in grid if name in g]
            pos = [w for w in ws if w > 0.0]
            if not pos:
                continue
            lo = min(pos)
            if len(pos) < len(ws):
                lo = min(lo / 10.0, 1e-4)
            skew = max(skew, max(pos) / lo)
        return skew

    def _fixed_seq_ok(self, probe) -> bool:
        return (self.update_sequence is None
                or list(self.update_sequence) == [probe[0]])

    def _game_grid_probe(self, grid) -> Optional[dict]:
        """{name: [reg_weight per grid point]} when every override varies
        only its coordinate's reg weight and nothing needs the sequential
        path (no projection, no normalization); None otherwise."""
        if any(v is not None for v in self.normalization.values()):
            return None
        names = set(self.coordinate_configs)
        if self.update_sequence is not None and \
                set(self.update_sequence) - names:
            return None
        for cfg in self.coordinate_configs.values():
            if (isinstance(cfg, RandomEffectConfig)
                    and cfg.projection is not None):
                return None
        lanes: dict = {n: [] for n in names}
        for overrides in grid:
            if set(overrides) - names:
                return None
            for n, base in self.coordinate_configs.items():
                cfg = overrides.get(n, base)
                if type(cfg) is not type(base):
                    return None
                strip = lambda c: dataclasses.replace(  # noqa: E731
                    c, optimizer=dataclasses.replace(c.optimizer,
                                                     reg_weight=0.0))
                if strip(cfg) != strip(base):
                    return None
                lanes[n].append(float(cfg.optimizer.reg_weight))
        return lanes

    def _grid_data_supported(self, data: GameData) -> bool:
        """Layouts the lane-axis grid runs: dense or SparseRows, and a
        `HybridRows` fixed effect without a mesh (reference:
        `_grid_data_supported`). A permuted layout (its coefficient-space
        translation lives at the train_glm boundary the grid bypasses), a
        sharded one and a chunked one keep the sequential path, on a mesh
        or not; so does a `HybridRows` shard of a random effect or on a
        mesh."""
        for cfg in self.coordinate_configs.values():
            X = data.shards[cfg.feature_shard]
            if isinstance(X, PERMUTED_LAYOUTS + SHARDED_LAYOUTS
                          + (ChunkedMatrix,)):
                return False
            if isinstance(X, HybridRows) and (
                    self.mesh is not None
                    or not isinstance(cfg, FixedEffectConfig)):
                return False
        return True

    def _fixed_only_reg_grid(self, grid):
        """(name, base_config, [reg_weight per grid point]) when the model
        is a single fixed effect and the grid varies only its weight."""
        if len(self.coordinate_configs) != 1:
            return None
        ((name, base),) = self.coordinate_configs.items()
        if not isinstance(base, FixedEffectConfig):
            return None
        weights = []
        for overrides in grid:
            if set(overrides) - {name}:
                return None
            cfg = {**self.coordinate_configs, **overrides}[name]
            if (not isinstance(cfg, FixedEffectConfig)
                    or cfg.feature_shard != base.feature_shard):
                return None
            if (dataclasses.replace(cfg.optimizer, reg_weight=0.0)
                    != dataclasses.replace(base.optimizer, reg_weight=0.0)):
                return None
            weights.append(float(cfg.optimizer.reg_weight))
        return name, base, weights

    def _datasets_for(self, data: GameData, configs: dict,
                      dataset_cache: dict) -> dict:
        datasets = {}
        for name, cfg in configs.items():
            key = self._dataset_key(cfg)
            if key not in dataset_cache:
                dataset_cache[key] = self._build_dataset(data, cfg)
            datasets[name] = dataset_cache[key]
        return datasets

    def _fit_fixed_grid(self, probe, data: GameData, validation,
                        evaluator: Evaluator, dataset_cache) -> list:
        """The vectorized fixed-effect grid: one `train_glm_grid` sweep
        (the lanes share every X pass), then one batched scoring pass per
        matrix — the training rows for each lane's objective, the
        validation rows for its metric."""
        from photon_tpu_torch.models.glm import (Coefficients,
                                                 GeneralizedLinearModel,
                                                 score_models)
        from photon_tpu_torch.models.training import train_glm_grid
        from photon_tpu_torch.ops.losses import loss_fns

        name, base, weights = probe
        ds = self._datasets_for(data, {name: base}, dataset_cache)[name]
        norm = self._normalization_for(name, ds)
        telemetry.count("game.grid_vectorized_lanes", len(weights))
        batch = ds.batch(data.offsets)
        grid = train_glm_grid(batch, self.task, base.optimizer, weights,
                              variance=self.variance, normalization=norm,
                              mesh=self.mesh, device=ds.device)
        dev = ds.device
        models = [GeneralizedLinearModel(Coefficients(
            m.coefficients.means.to(dev),
            None if m.coefficients.variances is None
            else m.coefficients.variances.to(dev)), self.task)
            for m, _ in grid]
        # each lane's unregularized weighted training loss (what the
        # descent's objective_history records), from one scoring pass
        loss, _, _ = loss_fns(self.task)
        if self.mesh is not None:  # every slot's rows, gathered
            from photon_tpu_torch.game.scoring import mesh_margins

            def col(v):
                return torch.as_tensor(np.asarray(v, np.float32)).to(dev)

            y, wts = col(data.y), col(data.weights)
            W = torch.stack([m.coefficients.means for m in models])
            margins = mesh_margins(ds.X, W.t(), ds.n).t() \
                + col(data.offsets)
        else:
            y, wts = batch.y, batch.weights
            margins = score_models(models, ds.X, batch.offsets)
        objectives = torch.sum(wts * loss(margins, y),
                               dim=1).cpu().tolist()
        val_margins = None
        if validation is not None:
            val_margins = score_models(
                models, validation.shards[base.feature_shard],
                validation.offsets)
        results = []
        for i, (model, (_, res)) in enumerate(zip(models, grid)):
            cfg_i = FixedEffectConfig(
                base.feature_shard,
                dataclasses.replace(base.optimizer, reg_weight=weights[i]))
            game_model = GameModel(
                {name: FixedEffectModel(model, base.feature_shard)},
                self.task)
            descent = CoordinateDescentResult(
                model=game_model, objective_history=[objectives[i]],
                coordinate_stats={name: [res]})
            r = GameFitResult(game_model, descent, {name: cfg_i})
            if val_margins is not None:
                telemetry.count("game.validate_point")
                r.validation_score = self._evaluate(
                    evaluator, val_margins[i], validation)
            results.append(r)
        return results

    def _fit_game_grid(self, lanes: dict, data: GameData, validation,
                       evaluator: Evaluator, dataset_cache,
                       coord_cache) -> list:
        """The lane-axis GAME grid (`game.grid.fit_game_grid`): every grid
        point a lane of one coordinate descent; validation scores every
        lane in one pass per coordinate."""
        from photon_tpu_torch.game.grid import fit_game_grid, lane_re_margins
        from photon_tpu_torch.models.glm import _score_many

        configs = self.coordinate_configs
        datasets = self._datasets_for(data, configs, dataset_cache)
        coords = self._build_coordinates(datasets, configs, coord_cache)
        G = len(next(iter(lanes.values())))
        telemetry.count("game.grid_vectorized_lanes", G)
        outcome = fit_game_grid(
            coords, lanes, data.y, data.weights, data.offsets, self.task,
            update_sequence=self.update_sequence, n_sweeps=self.n_sweeps,
            mesh=self.mesh)
        val_scores = None
        if validation is not None:
            total = validation.offsets[None, :]
            for name in outcome.lane_models[0].names():
                cfg = configs[name]
                Xv = validation.shards[cfg.feature_shard]
                if isinstance(cfg, FixedEffectConfig):
                    total = total + _score_many(outcome.stacked[name], Xv)
                else:
                    model0 = outcome.lane_models[0].coordinates[name]
                    ids = model0.dense_ids(
                        validation.entity_ids[cfg.entity_name])
                    total = total + lane_re_margins(outcome.stacked[name],
                                                    Xv, ids)
            val_scores = total
        results = []
        for g in range(G):
            configs_g = {
                name: dataclasses.replace(
                    cfg, optimizer=dataclasses.replace(
                        cfg.optimizer, reg_weight=lanes[name][g]))
                for name, cfg in configs.items()}
            descent = CoordinateDescentResult(
                model=outcome.lane_models[g],
                objective_history=outcome.objective_histories[g],
                coordinate_stats=outcome.coordinate_stats[g])
            r = GameFitResult(outcome.lane_models[g], descent, configs_g)
            if val_scores is not None:
                telemetry.count("game.validate_point")
                r.validation_score = self._evaluate(
                    evaluator, val_scores[g], validation)
            results.append(r)
        return results

    def evaluate_scores(self, evaluator: Evaluator, scores,
                        validation: GameData) -> float:
        """The validation metric of ``scores`` (the drivers report extra
        evaluators on the best model through it)."""
        return self._evaluate(evaluator, scores, validation)

    def _evaluate(self, evaluator: Evaluator, scores,
                  validation: GameData) -> float:
        """The evaluator on the scores' device; a sharded one groups by
        ``evaluator_entity`` (default: the first random-effect
        coordinate's entity type), as the reference's per-entity
        validation evaluators do."""
        if not evaluator.needs_groups:
            return evaluator.evaluate(scores, validation.y,
                                      validation.weights)
        entity = self.evaluator_entity
        if entity is None:
            for cfg in self.coordinate_configs.values():
                if isinstance(cfg, RandomEffectConfig):
                    entity = cfg.entity_name
                    break
        return evaluate_with_entity(evaluator, scores, validation.y,
                                    validation.weights,
                                    validation.entity_ids, entity)

    def best_model(self, results: list) -> GameFitResult:
        """Pick by validation metric in the evaluator's direction
        (reference: GameTrainingDriver.selectBestModel); a result without
        a validation score competes by its final training objective."""
        evaluator = self.evaluator or default_evaluator(self.task)
        best = None
        for r in results:
            if r.validation_score is not None:
                if best is None or evaluator.better_than(
                        r.validation_score, best.validation_score):
                    best = r
            else:
                obj = (r.descent.objective_history[-1]
                       if r.descent.objective_history else float("inf"))
                best_obj = (best.descent.objective_history[-1]
                            if best is not None
                            and best.descent.objective_history
                            else float("inf"))
                if best is None or obj < best_obj:
                    best = r
        if best is None:
            raise ValueError("no fit results to select from")
        return best
