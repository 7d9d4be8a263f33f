"""GameEstimator: train GAME models over candidate configurations (port of
`FixedEffectConfig`, `RandomEffectConfig`, `GameFitResult` and the
sequential path of `GameEstimator.fit` of `photon_tpu/game/estimator.py`).

Reference parity: com.linkedin.photon.ml.estimators.GameEstimator — fit()
takes a sequence of per-coordinate configurations and trains one GameModel
per configuration, each warm-started from the previous one when enabled;
datasets (the entity bucketing) and coordinates are cached across grid
points and across fits of the same data.

On the port's device (CUDA unless ``device="cpu"``), one device. A
fixed effect's shard may be a host `ChunkedMatrix`: its solves stream
(the pod-scale regime's single-device form) and the descent exchanges
its margins on the host. Not ported yet, each raising with its ROADMAP
queue A item: the vectorized grid paths (`would_vectorize` gives the
reference's answer; where it says they would run, fit raises — item 6,
`game/grid.py`), validation data (item 7, with the evaluators and
selection by a validation metric) and meshes (item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix
from photon_tpu_torch.data.matrix import (BlockedEllRows,
                                          last_column_is_intercept)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.coordinate_descent import (CoordinateDescentResult,
                                                      coordinate_descent)
from photon_tpu_torch.game.dataset import (FixedEffectDataset, GameData,
                                           RandomEffectDataset)
from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectCoordinate
from photon_tpu_torch.models.variance import VarianceComputationType
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig


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
    """Reference: estimators.GameEstimator (its sequential path)."""

    task: TaskType
    coordinate_configs: dict  # name -> CoordinateConfig (order = sequence)
    update_sequence: Optional[list] = None
    n_sweeps: int = 2
    mesh: Optional[object] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    locked: frozenset = frozenset()
    incremental: frozenset = frozenset()
    warm_start: bool = True
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

    def _build_dataset(self, data: GameData, cfg: CoordinateConfig):
        if isinstance(cfg, FixedEffectConfig):
            return FixedEffectDataset.build(data, cfg.feature_shard,
                                            device=self.device)
        return RandomEffectDataset.build(
            data, cfg.entity_name, cfg.feature_shard,
            active_cap=cfg.active_cap, projection=cfg.projection,
            device=self.device)

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
            icpt = -1 if last_column_is_intercept(dataset.X) else None
            if spec is NormalizationType.STANDARDIZATION and icpt is None:
                raise ValueError(
                    f"normalization[{name!r}]: STANDARDIZATION requires an "
                    "intercept column (all-ones, last) in the feature shard")
            return NormalizationContext.build(dataset.X, spec,
                                              intercept_index=icpt)
        raise TypeError(
            f"normalization[{name!r}] must be a NormalizationType or "
            f"NormalizationContext, got {type(spec)}")

    def _refuse_unported(self, validation) -> None:
        if validation is not None:
            raise NotImplementedError(
                "validation-time evaluation (validation= data, evaluators) "
                "is not ported yet (ROADMAP queue A item 7)")
        if self.mesh is not None:
            raise NotImplementedError(
                "meshes (multi-device GAME) are not ported yet (ROADMAP "
                "queue A item 10)")

    def fit(self, data: GameData, validation: Optional[GameData] = None,
            config_grid: Optional[list] = None,
            initial_models: Optional[dict] = None) -> list:
        """Train one GameModel per candidate configuration.

        ``config_grid``: list of {name -> CoordinateConfig} overrides, one
        model per entry (None: one model with ``coordinate_configs``).
        Successive models warm-start from the previous one when
        ``warm_start``. Datasets are cached per (shard, entity,
        active_cap, projection), so overrides that change only the
        optimizer reuse the bucketed blocks."""
        resolve_device(self.device)
        self._refuse_unported(validation)
        grid = config_grid or [self.coordinate_configs]
        if self._chunked_shards(data):
            # the streamed regime: fixed effects stream their host-chunked
            # shards; the descent exchanges margins on the host
            telemetry.count("game_e2e.chunked_fit_points", len(grid))
        dataset_cache, coord_cache = self._caches_for(data)
        chain_warm = self.warm_start
        if self.would_vectorize(grid, initial_models):
            if self.would_vectorize(grid, initial_models, data):
                raise NotImplementedError(
                    "this config grid takes the reference's vectorized grid "
                    "path (game/grid.py, or one train_glm_grid program for "
                    "a lone fixed effect), which is not ported yet (ROADMAP "
                    "queue A item 6); set vectorized_grid=False or "
                    "warm_start=True to run it sequentially")
            # the reference keeps the vectorized contract (no warm starts
            # across grid points) on its unsupported-layout fallback
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
            datasets = {}
            for name, cfg in configs.items():
                key = self._dataset_key(cfg)
                if key not in dataset_cache:
                    dataset_cache[key] = self._build_dataset(data, cfg)
                datasets[name] = dataset_cache[key]
            coords = self._build_coordinates(datasets, configs, coord_cache)
            descent = coordinate_descent(
                coords, data.y, data.weights, data.offsets, self.task,
                update_sequence=self.update_sequence,
                n_sweeps=self.n_sweeps, locked=self.locked,
                initial_models=prev_models, incremental=self.incremental,
                priors=user_priors)
            results.append(GameFitResult(descent.model, descent, configs))
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
        """Layouts the lane-axis grid runs: dense or SparseRows."""
        for cfg in self.coordinate_configs.values():
            X = data.shards[cfg.feature_shard]
            if isinstance(X, (BlockedEllRows, ChunkedMatrix)):
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

    def best_model(self, results: list) -> GameFitResult:
        """The result with the lowest final training objective (selection
        by a validation metric waits for evaluation, ROADMAP item 7)."""
        best = None
        for r in results:
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
