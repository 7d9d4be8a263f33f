"""GAME training driver: Avro files in → validated best model out.

Reference parity: com.linkedin.photon.ml.cli.game.training.GameTrainingDriver
(scopt CLI → feature shards → coordinate configs → GameEstimator.fit over the
regularization grid → validation model selection → save best model to HDFS).
Here the same pipeline is a dataclass config + `run_training()`, with a JSON
CLI.

Hyperparameter search: the reference's grid mode maps to the cartesian
product of each coordinate's `reg_weights`.

The port's copy of `photon_tpu/drivers/train.py`, its in-memory path
(``python -m photon_tpu_torch.drivers.train --config job.json``, on the
GPU unless ``run_training(..., device="cpu")``): read (pure-Python Avro),
validate, summarize, normalize, down-sample, `GameEstimator.fit` over the
grid with validation, the extra evaluators, `best_model`, save, and
``output_mode="ALL"`` with per-point resume. What is not ported raises
naming its ROADMAP queue A item: ``checkpoint_dir`` and ``tuning_iters``
(item 11), the streamed regimes and their knobs (item 8b), meshes (item
10). Decoding stays on the host; the data moves to the device once.

One deliberate difference from the reference: in ``output_mode="ALL"``
every saved point's ``training_manifest.json`` is the training-row
manifest (`continual.delta.build_manifest`), as ``best_model/``'s is; the
reference writes the models.json rows gathered so far there (ROADMAP
§C9).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint.store import commit_bytes
from photon_tpu_torch.continual.delta import build_manifest
from photon_tpu_torch.data.feature_bags import FeatureShardConfig
from photon_tpu_torch.data.ingest import GameDataConfig, read_game_data
from photon_tpu_torch.data.matrix import SparseRows, _host
from photon_tpu_torch.data.model_io import load_game_model, save_game_model
from photon_tpu_torch.data.normalization import (
    NormalizationContext,
    NormalizationType,
)
from photon_tpu_torch.data.sampling import (binary_down_sample,
                                            default_down_sample)
from photon_tpu_torch.data.statistics import FeatureSummary
from photon_tpu_torch.data.streaming import scan_ingest
from photon_tpu_torch.data.validators import (DataValidationType,
                                              validate_game_data)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.drivers.index import load_index_map_dir
from photon_tpu_torch.evaluation.evaluator import (evaluator_name,
                                                   parse_evaluator)
from photon_tpu_torch.game.coordinate_descent import CoordinateDescentResult
from photon_tpu_torch.game.dataset import GameData
from photon_tpu_torch.game.estimator import (
    FixedEffectConfig,
    GameEstimator,
    GameFitResult,
    RandomEffectConfig,
)
from photon_tpu_torch.game.scoring import score_game
from photon_tpu_torch.models.variance import VarianceComputationType
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim import regularization as reg
from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType
from photon_tpu_torch.utils.logging import photon_logger
from photon_tpu_torch.utils.timing import PhaseTimers


@dataclasses.dataclass(frozen=True)
class CoordinateSpec:
    """JSON-friendly description of one coordinate (reference:
    CoordinateConfiguration in the driver's config language)."""

    feature_shard: str
    entity_name: Optional[str] = None  # None → fixed effect
    optimizer: str = "lbfgs"  # lbfgs | owlqn | tron
    max_iters: int = 100
    tolerance: float = 1e-7
    reg_type: str = "none"  # none | l1 | l2 | elastic_net
    reg_weight: float = 0.0
    reg_weights: Optional[Sequence[float]] = None  # grid-search values
    reg_alpha: float = 0.5  # elastic-net mixing
    regularize_intercept: bool = True
    active_cap: Optional[int] = None  # random-effect active-data bound

    def reg_context(self) -> reg.RegularizationContext:
        t = self.reg_type.lower()
        if t == "none":
            return reg.NONE
        if t == "l1":
            return reg.l1()
        if t == "l2":
            return reg.l2()
        if t == "elastic_net":
            return reg.elastic_net(self.reg_alpha)
        raise ValueError(f"unknown reg_type {self.reg_type!r}")

    def optimizer_config(self, reg_weight: Optional[float] = None) -> OptimizerConfig:
        return OptimizerConfig(
            optimizer=OptimizerType[self.optimizer.upper()],
            max_iters=self.max_iters,
            tolerance=self.tolerance,
            reg=self.reg_context(),
            reg_weight=self.reg_weight if reg_weight is None else float(reg_weight),
            regularize_intercept=self.regularize_intercept,
        )

    def coordinate_config(self, reg_weight: Optional[float] = None):
        opt = self.optimizer_config(reg_weight)
        if self.entity_name is None:
            return FixedEffectConfig(self.feature_shard, opt)
        return RandomEffectConfig(
            self.entity_name, self.feature_shard, opt, active_cap=self.active_cap
        )


@dataclasses.dataclass
class TrainingParams:
    """Reference: GameTrainingDriver's scopt parameter set."""

    train_path: str
    output_dir: str
    task: str = "LOGISTIC_REGRESSION"
    validation_path: Optional[str] = None
    feature_shards: dict = dataclasses.field(default_factory=dict)
    # shard name -> {"bags": [...], "has_intercept": bool}
    coordinates: dict = dataclasses.field(default_factory=dict)
    # coordinate name -> CoordinateSpec (or its dict form)
    entity_fields: Sequence[str] = ()
    update_sequence: Optional[Sequence[str]] = None
    n_sweeps: int = 2
    normalization: str = "none"  # applied to every shard (reference: one flag)
    data_validation: str = "validate_full"
    variance_type: str = "none"
    down_sampling_rate: Optional[float] = None  # binary tasks: negatives only
    sparse_k: Optional[int] = None
    # The reference's streamed regimes and ingest plane (ROADMAP queue A
    # item 8b): streaming=None keeps the reference's header-only row count
    # and raises above streaming_threshold_rows, where the reference would
    # stream; streaming=True, streamed_objective=True, an explicit
    # hbm_budget_bytes, ingest_workers > 0 and chunk_cache_dir raise.
    streaming: Optional[bool] = None
    streaming_threshold_rows: int = 2_000_000
    streaming_chunk_rows: int = 65536
    streamed_objective: Optional[bool] = None
    hbm_budget_bytes: Optional[int] = None
    objective_chunk_rows: int = 1 << 20
    streaming_feature_dtype: Optional[str] = None
    ingest_workers: int = 0
    chunk_cache_dir: Optional[str] = None
    # Directory of prebuilt frozen index maps (the indexing driver's
    # output; reference: consuming FeatureIndexingJob's PalDB maps).
    # Features absent from the maps — e.g. pruned by min_count — are
    # dropped at ingestion instead of being assigned fresh ids.
    index_map_dir: Optional[str] = None
    warm_start: bool = True
    # Tri-state passthrough to GameEstimator.vectorized_grid: None (default)
    # vectorizes fixed-effect-only reg grids only when warm_start is False.
    vectorized_grid: Optional[bool] = None
    evaluator_entity: Optional[str] = None
    # Validation evaluators (reference: GameTrainingDriver evaluatorTypes):
    # the FIRST selects the best model; ALL are computed on the best model
    # and reported in TrainingOutput.validation_metrics. Strings like
    # "AUC", "RMSE", "PRECISION@5", "SHARDED_AUC". Empty → the task's
    # default evaluator.
    evaluators: Sequence[str] = ()
    # The reference's GP reg-weight tuner (tuning_iters > 0 raises: ROADMAP
    # queue A item 11)
    tuning_iters: int = 0
    tuning_range: tuple = (1e-4, 1e4)
    tuning_batch: int = 1
    seed: int = 0
    # Incremental training (reference: --initial-model + PriorDistribution):
    # warm-start every coordinate from the saved model; coordinates listed in
    # incremental_coordinates also use it as an informative prior.
    initial_model_dir: Optional[str] = None
    incremental_coordinates: Sequence[str] = ()
    # Partial retraining (reference: partialRetrainLockedCoordinates): listed
    # coordinates keep the initial model and only contribute scores.
    locked_coordinates: Sequence[str] = ()
    # Per-shard feature summary output (reference: GameTrainingDriver
    # summarizationOutputDir → BasicStatisticalSummary per shard). Relative
    # paths land under output_dir.
    summarization_output_dir: Optional[str] = None
    # BEST saves only the selected model (best_model/); ALL additionally
    # saves every grid point under models/m_<sha1-prefix>/ — directories
    # are keyed by the point's full configuration signature, and
    # models/models.json is the authoritative index mapping each row to
    # its directory, scores, and reg weights (reference:
    # GameTrainingDriver's model output dir holds ALL trained models,
    # tagged by their optimization configuration, alongside the
    # best-model dir chosen on validation).
    output_mode: str = "BEST"  # BEST | ALL
    # Restart story for long grid sweeps (the analog of rerunning a died
    # Spark job against its HDFS outputs). With resume=True (requires
    # output_mode=ALL), every grid point is CHECKPOINTED to its
    # models/m_<hash>/ dir + models.json as soon as it finishes training,
    # and a rerun loads the
    # points whose full configuration signature matches instead of
    # retraining them — so set resume=True from the FIRST run of a long
    # sweep, and a crash at point k costs only point k. Warm starts chain
    # through loaded models. Grid mode only; incompatible with
    # incremental_coordinates (per-point fits would drift the priors).
    resume: bool = False
    # The reference's persistent XLA compilation cache: XLA-only, so the
    # port accepts it and logs that it has no effect.
    compilation_cache_dir: Optional[str] = None
    # The reference's crash-consistent solver snapshots (checkpoint_dir
    # raises: ROADMAP queue A item 11)
    checkpoint_dir: Optional[str] = None
    checkpoint_every_s: Optional[float] = 30.0  # wall-clock cadence
    checkpoint_every_evals: Optional[int] = None  # evaluation cadence
    checkpoint_keep: int = 2  # snapshot retention (older dirs GC'd)
    checkpoint_resume: bool = True  # restore a committed snapshot if any
    checkpoint_async: bool = True  # commit on the writer thread

    def __post_init__(self):
        if self.output_mode.upper() not in ("BEST", "ALL"):
            raise ValueError(
                f"output_mode must be BEST or ALL, got {self.output_mode!r}")
        if self.resume and self.output_mode.upper() != "ALL":
            raise ValueError(
                "resume=True needs output_mode=ALL (completed grid points "
                "are recovered from the models/ directory it writes)")
        if self.resume and self.tuning_iters > 0:
            raise ValueError(
                "resume applies to grid mode only (tuning_iters must be 0)")
        if self.resume and self.incremental_coordinates:
            raise ValueError(
                "resume is not supported with incremental_coordinates: "
                "per-point fits would re-derive the priors from the "
                "previous grid point instead of the user's initial model")
        self.coordinates = {
            k: (v if isinstance(v, CoordinateSpec) else CoordinateSpec(**v))
            for k, v in self.coordinates.items()
        }
        self.feature_shards = {
            k: FeatureShardConfig.coerce(v)
            for k, v in self.feature_shards.items()
        }


@dataclasses.dataclass
class TrainingOutput:
    best: GameFitResult
    results: list
    model_dir: str
    timings: dict
    # evaluator name -> value for the BEST model on validation, one entry
    # per TrainingParams.evaluators (reference: the driver logs every
    # configured validation evaluator, not only the selection metric).
    validation_metrics: dict = dataclasses.field(default_factory=dict)
    # grid points recovered from a previous run's models/ (resume=True)
    n_resumed: int = 0


def _binary_task(task: TaskType) -> bool:
    """Tasks that get the negatives-only down-sampler (reference:
    BinaryClassificationDownSampler vs DefaultDownSampler dispatch) — ONE
    site, shared by the row-dropping and weight-form paths so the
    streaming tri-state can never flip the sampler family."""
    return task in (TaskType.LOGISTIC_REGRESSION,
                    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def _apply_down_sampling(data: GameData, task: TaskType, rate: float,
                         seed: int) -> GameData:
    """Reference: the driver's DownSampler applied to training data."""
    if _binary_task(task):
        idx, w = binary_down_sample(data.y, rate, data.weights, seed)
    else:
        idx, w = default_down_sample(data.n, rate, data.weights, seed)
    shards = {}
    for name, X in data.shards.items():
        if isinstance(X, SparseRows):
            shards[name] = SparseRows(_host(X.indices)[idx],
                                      _host(X.values)[idx], X.n_features)
        else:
            shards[name] = _host(X)[idx]
    return GameData(
        y=data.y[idx], weights=w, offsets=data.offsets[idx], shards=shards,
        entity_ids={k: np.asarray(v)[idx] for k, v in data.entity_ids.items()},
    )


def _config_grid(coordinates: dict) -> Optional[list]:
    """Cartesian product over every coordinate's reg_weights list."""
    names = [n for n, s in coordinates.items() if s.reg_weights]
    if not names:
        return None
    combos = itertools.product(*(coordinates[n].reg_weights for n in names))
    return [
        {n: coordinates[n].coordinate_config(wt) for n, wt in zip(names, combo)}
        for combo in combos
    ]


def _refuse_unported(params: TrainingParams, mesh) -> None:
    """Raise for every option whose path is not ported, naming its ROADMAP
    queue A item, before any data is read."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes (multi-device training) are not ported yet (ROADMAP "
            "queue A item 10)")
    if params.checkpoint_dir:
        raise NotImplementedError(
            "checkpoint_dir (crash-consistent solver snapshots) is not "
            "ported yet (ROADMAP queue A item 11)")
    if params.tuning_iters > 0:
        raise NotImplementedError(
            "tuning_iters > 0 (the GP reg-weight tuner, _tune) is not "
            "ported yet (ROADMAP queue A item 11)")
    streamed = {
        "streaming=True": params.streaming is True,
        "streamed_objective=True": params.streamed_objective is True,
        "hbm_budget_bytes": params.hbm_budget_bytes is not None,
        "ingest_workers > 0": params.ingest_workers > 0,
        "chunk_cache_dir": bool(params.chunk_cache_dir),
    }
    asked = [k for k, v in streamed.items() if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the streamed training regimes and the "
            "ingest plane are not ported yet (ROADMAP queue A item 8b)")


def run_training(params: TrainingParams, mesh=None,
                 device=None) -> TrainingOutput:
    """The full reference pipeline on ``device`` (default ``cuda``): read →
    validate → (summarize, normalize, down-sample) → train over the config
    grid → select best on validation → save."""
    _refuse_unported(params, mesh)
    dev = resolve_device(device)
    log = photon_logger("photon_tpu_torch.train", params.output_dir)
    timers = PhaseTimers(span_prefix="train.")
    task = TaskType[params.task]
    mode = DataValidationType(params.data_validation)
    if params.compilation_cache_dir:
        log.info("compilation_cache_dir=%r has no effect: it is the JAX "
                 "package's XLA cache", params.compilation_cache_dir)

    with timers("read"):
        data_cfg = GameDataConfig(
            shards=params.feature_shards,
            entity_fields=tuple(params.entity_fields))
        prebuilt_maps = None
        if params.index_map_dir:
            prebuilt_maps = load_index_map_dir(params.index_map_dir,
                                               params.feature_shards)
        if params.streaming is None:
            # the reference's auto-streaming check: a header-only scan
            n_train_rows = scan_ingest(params.train_path,
                                       GameDataConfig(shards={})).n_rows
            if n_train_rows > params.streaming_threshold_rows:
                raise NotImplementedError(
                    f"{n_train_rows} training rows exceed "
                    f"streaming_threshold_rows="
                    f"{params.streaming_threshold_rows}, where the reference "
                    "streams its ingest; streaming ingestion is not ported "
                    "yet (ROADMAP queue A item 8b) — raise the threshold or "
                    "set streaming=False to read in memory")
        data, index_maps = read_game_data(
            params.train_path, data_cfg, index_maps=prebuilt_maps,
            sparse_k=params.sparse_k)
        validation = None
        if params.validation_path:
            validation, _ = read_game_data(
                params.validation_path, data_cfg, index_maps=index_maps,
                sparse_k=params.sparse_k)
        log.info("read %d training rows, %d shards", data.n,
                 len(data.shards))

    with timers("validate"):
        validate_game_data(data, task, mode)
        if validation is not None:
            validate_game_data(validation, task, mode)

    # Summaries and normalization are computed BEFORE down-sampling:
    # statistics describe the dataset, down-sampling is a training trick.
    summaries = {}
    if params.summarization_output_dir is not None:
        summary_dir = params.summarization_output_dir
        if not os.path.isabs(summary_dir):
            summary_dir = os.path.join(params.output_dir, summary_dir)
        os.makedirs(summary_dir, exist_ok=True)
        with timers("summarize"):
            for shard_name in params.feature_shards:
                s = FeatureSummary.compute(data.shards[shard_name],
                                           device=dev)
                s.save(os.path.join(summary_dir, f"{shard_name}.json"))
                summaries[shard_name] = s
        log.info("wrote feature summaries for %d shards to %s",
                 len(summaries), summary_dir)

    norm_type = NormalizationType(params.normalization)
    normalization = {}
    if norm_type is not NormalizationType.NONE:
        for name, spec in params.coordinates.items():
            shard_cfg = params.feature_shards[spec.feature_shard]
            icpt = -1 if shard_cfg.has_intercept else None
            if norm_type is NormalizationType.STANDARDIZATION and icpt is None:
                raise ValueError(
                    f"standardization requires an intercept in shard "
                    f"{spec.feature_shard!r}"
                )
            if spec.feature_shard in summaries:
                # one stats pass feeds both outputs (the reference builds
                # the NormalizationContext from the same summary object)
                normalization[name] = NormalizationContext.from_summary(
                    summaries[spec.feature_shard], norm_type,
                    intercept_index=icpt)
            else:
                normalization[name] = NormalizationContext.build(
                    data.shards[spec.feature_shard], norm_type,
                    intercept_index=icpt)

    if params.down_sampling_rate is not None:
        with timers("down_sample"):
            n0 = data.n
            data = _apply_down_sampling(
                data, task, params.down_sampling_rate, params.seed)
            log.info("down-sampled %d -> %d rows", n0, data.n)

    initial_models = None
    if params.initial_model_dir:
        with timers("load_initial_model"):
            initial_game, _ = load_game_model(params.initial_model_dir,
                                              device=dev)
            initial_models = dict(initial_game.coordinates)
        log.info("loaded initial model with coordinates %s",
                 list(initial_models))

    evals = [parse_evaluator(s) for s in params.evaluators]
    estimator = GameEstimator(
        task=task,
        evaluator=evals[0] if evals else None,
        coordinate_configs={
            n: s.coordinate_config() for n, s in params.coordinates.items()
        },
        update_sequence=(list(params.update_sequence)
                         if params.update_sequence else None),
        n_sweeps=params.n_sweeps,
        variance=VarianceComputationType[params.variance_type.upper()],
        locked=frozenset(params.locked_coordinates),
        incremental=frozenset(params.incremental_coordinates),
        warm_start=params.warm_start,
        evaluator_entity=params.evaluator_entity,
        normalization=normalization,
        vectorized_grid=params.vectorized_grid,
        device=dev,
    )

    n_resumed = 0
    with timers("train"):
        if params.resume:
            results, n_resumed = _fit_grid_resumable(
                estimator, params, data, validation, initial_models,
                index_maps, log, dev)
        else:
            results = estimator.fit(
                data, validation=validation,
                config_grid=_config_grid(params.coordinates),
                initial_models=initial_models)
    telemetry.sample_device_memory("post_train")
    best = estimator.best_model(results)
    if best.validation_score is not None:
        log.info("best validation score: %.6f", best.validation_score)

    validation_metrics: dict = {}
    if evals and validation is not None:
        # evals[0] is the selection metric fit() already computed for the
        # best model; only the extra evaluators need a fresh scoring pass.
        validation_metrics[evaluator_name(evals[0])] = best.validation_score
        if len(evals) > 1:
            val_dev = validation.to_device(dev)
            scores = score_game(best.model, val_dev)
            for ev in evals[1:]:
                try:
                    validation_metrics[evaluator_name(ev)] = \
                        estimator.evaluate_scores(ev, scores, val_dev)
                except ValueError as e:
                    # an extra metric must never destroy a finished run
                    # (the model is saved below either way)
                    log.warning("skipping %s: %s", ev.kind.name, e)
        log.info("validation metrics (best model): %s", validation_metrics)

    with timers("save"):
        # Training-row manifest: the delta baseline a continual refresh
        # diffs the next data drop against, beside the coefficients.
        manifest = build_manifest(data)
        model_dir = os.path.join(params.output_dir, "best_model")
        save_game_model(
            model_dir, best.model,
            {n: index_maps[params.coordinates[n].feature_shard]
             for n in best.model.names()},
            manifest=manifest,
        )
        if params.output_mode.upper() == "ALL":
            models_dir = os.path.join(params.output_dir, "models")
            os.makedirs(models_dir, exist_ok=True)
            gsig = _global_signature(params, False)
            rows = []
            sigs = _point_signatures(gsig, [r.configs for r in results])
            # Skip rewriting only points the CURRENT resume run persisted or
            # signature-verified — rows of the models.json it just wrote
            # (rows are appended only AFTER a successful model save, so a
            # partially-written dir from a crash mid-save is never listed
            # and gets overwritten here).
            checkpointed: set = set()
            if params.resume:
                mpath = os.path.join(models_dir, "models.json")
                if os.path.exists(mpath):
                    with open(mpath) as fh:
                        checkpointed = {
                            m.get("config_sig") for m in json.load(fh)
                            if os.path.isdir(m.get("dir", ""))}
            for r, sig in zip(results, sigs):
                point_dir = _sig_dir(models_dir, sig)
                if sig not in checkpointed:
                    save_game_model(
                        point_dir, r.model,
                        {n: index_maps[params.coordinates[n].feature_shard]
                         for n in r.model.names()},
                        manifest=manifest,
                    )
                rows.append(_manifest_row(point_dir, r, best=r is best,
                                          sig=sig))
            # atomic models.json replace FIRST, then prune directories no
            # row references — a crash between the two only leaves orphans
            _write_manifest(os.path.join(models_dir, "models.json"), rows)
            keep = {os.path.basename(m["dir"]) for m in rows}
            keep.add("models.json")
            for name in os.listdir(models_dir):
                p = os.path.join(models_dir, name)
                if os.path.isdir(p) and name not in keep:
                    shutil.rmtree(p, ignore_errors=True)
            log.info("saved all %d models under %s", len(results),
                     os.path.join(params.output_dir, "models"))
    log.info("timings: %s", timers.summary())
    return TrainingOutput(best, results, model_dir, timers.summary(),
                          validation_metrics=validation_metrics,
                          n_resumed=n_resumed)


def _global_signature(params: TrainingParams, streaming: bool,
                      streamed_obj: bool = False) -> str:
    """Every training-wide knob that changes what a grid point's model
    means: data, sweeps, normalization, sampling, warm-start mode, …
    Baked into each point's signature so resume can never hand back a
    model trained under different global settings."""
    return repr((
        params.task, params.n_sweeps,
        tuple(params.update_sequence or ()),
        params.normalization, params.data_validation,
        params.down_sampling_rate, params.seed, params.sparse_k,
        params.train_path, params.index_map_dir,
        tuple(sorted(params.locked_coordinates)),
        params.warm_start, params.variance_type,
        # validation knobs: a resumed point's stored validation_score is
        # only comparable to fresh points' scores if it was computed on
        # the same validation data with the same SELECTION metric
        # (evaluators[0]). Extra evaluators are reporting-only and are
        # recomputed fresh on the best model every run, so they must not
        # invalidate checkpoints.
        params.validation_path,
        (params.evaluators[0] if params.evaluators else None),
        params.evaluator_entity,
        tuple(sorted(
            (k, tuple(v.bags), v.has_intercept, v.dense_threshold)
            for k, v in params.feature_shards.items())),
        # streaming knobs that change the trained model: the storage dtype
        # casts features, and down-sampling switches to its weight-0 form.
        # `streaming` is the RESOLVED mode (the same train_path resolves
        # the same way every run, so resume stays stable). The RESOLVED
        # streamed-objective mode rides along: chunked f32 accumulation
        # reorders sums, so a resumed point must have trained in the same
        # regime.
        bool(streaming), params.streaming_feature_dtype,
        bool(streamed_obj),
    ))


def _point_signatures(global_sig: str, configs_list) -> list:
    """Signatures for a whole grid, disambiguating DUPLICATE points: under
    warm starts two identical configs at different grid positions train
    different models (different warm-start chains), so the k-th occurrence
    of a signature gets a '#k' suffix. Occurrence order is stable under
    grid widening, so resume still matches."""
    seen: dict = {}
    out = []
    for configs in configs_list:
        sig = _point_signature(global_sig, configs)
        k = seen.get(sig, 0)
        seen[sig] = k + 1
        out.append(sig if k == 0 else f"{sig}#{k}")
    return out


def _point_signature(global_sig: str, configs: dict) -> str:
    """global signature + every per-coordinate knob that changes the
    trained model (not just reg weights — a stale model trained under
    different settings must never be resumed as this one)."""
    parts = []
    for n, c in sorted(configs.items()):
        o = c.optimizer
        parts.append((
            n, type(c).__name__, c.feature_shard,
            getattr(c, "entity_name", None), getattr(c, "active_cap", None),
            o.optimizer.value, o.max_iters, o.tolerance, o.history,
            o.cg_max_iters, o.reg.reg_type.value, o.reg.alpha,
            float(o.reg_weight), o.regularize_intercept,
        ))
    return global_sig + "|" + repr(parts)


def _sig_dir(models_dir: str, sig: str) -> str:
    """Content-keyed model directory: the layout is keyed by signature so
    no write can ever clobber a directory another signature maps to."""
    return os.path.join(models_dir,
                        "m_" + hashlib.sha1(sig.encode()).hexdigest()[:16])


def _manifest_row(point_dir: str, r, best: bool, sig: str) -> dict:
    hist = r.descent.objective_history
    return {
        "dir": point_dir,
        "validation_score": r.validation_score,
        "best": best,
        "reg_weights": {n: c.optimizer.reg_weight
                        for n, c in r.configs.items()},
        "config_sig": sig,
        "objective": (float(hist[-1]) if hist else None),
    }


def _write_manifest(path: str, rows: list) -> None:
    """Atomic replace: a preemption mid-write must never leave truncated
    JSON (the resume feature's own failure scenario). Rides the repo-wide
    commit primitive — the hand-rolled tmp+replace this used to carry
    skipped the fsync, so a power loss could still publish a torn file."""
    commit_bytes(path, json.dumps(rows, indent=2).encode())


def _fit_grid_resumable(estimator: GameEstimator, params: TrainingParams,
                        data, validation, initial_models, index_maps, log,
                        device):
    """Fit the grid one point at a time, CHECKPOINTING each point the
    moment it finishes, and loading points a previous (possibly died) run
    already completed. Warm starts chain through loaded models exactly as
    through freshly trained ones (note: under warm starts a resumed
    point's model reflects the chain it was originally trained in).

    One deliberate trade-off: a FRESH run (nothing resumable) whose grid
    the estimator would run as ONE vectorized program keeps that path —
    it is a single device program and loses almost nothing on a crash;
    per-point checkpointing engages exactly where it pays, on the slow
    sequential sweeps."""
    models_dir = os.path.join(params.output_dir, "models")
    manifest_path = os.path.join(models_dir, "models.json")
    completed: dict = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            for m in json.load(fh):
                if m.get("config_sig") and os.path.isdir(m["dir"]):
                    completed[m["config_sig"]] = m

    grid = _config_grid(params.coordinates) or [
        {n: s.coordinate_config() for n, s in params.coordinates.items()}
    ]
    base = {n: s.coordinate_config() for n, s in params.coordinates.items()}
    gsig = _global_signature(params, False)
    sigs = _point_signatures(gsig, [{**base, **ov} for ov in grid])
    if (not any(s in completed for s in sigs)
            and estimator.would_vectorize(grid, initial_models, data=data)):
        # nothing to resume and the whole sweep is one device program:
        # points are persisted together in the save phase.
        return estimator.fit(data, validation=validation, config_grid=grid,
                             initial_models=initial_models), 0

    os.makedirs(models_dir, exist_ok=True)
    # merge view keyed by signature: flushing a fresh point must never
    # clobber manifest rows of completed points later in the grid order
    manifest_by_sig = dict(completed)
    results: list = []
    n_resumed = 0
    prev_models = dict(initial_models or {})
    for overrides, sig in zip(grid, sigs):
        configs = {**base, **overrides}
        hit = completed.get(sig)
        if hit is not None:
            model, _ = load_game_model(hit["dir"], device=device)
            obj = hit.get("objective")
            r = GameFitResult(
                model,
                CoordinateDescentResult(
                    model, [] if obj is None else [obj], {}),
                configs,
                validation_score=hit["validation_score"],
            )
            n_resumed += 1
        else:
            r = estimator.fit(data, validation=validation,
                              config_grid=[overrides],
                              initial_models=prev_models)[0]
            point_dir = _sig_dir(models_dir, sig)
            save_game_model(
                point_dir, r.model,
                {n: index_maps[params.coordinates[n].feature_shard]
                 for n in r.model.names()})
            manifest_by_sig[sig] = _manifest_row(point_dir, r, best=False,
                                                 sig=sig)
            # checkpoint the manifest NOW (atomically): a crash at the
            # next point loses only that point ("best" flags are
            # finalized in the save phase)
            _write_manifest(manifest_path, list(manifest_by_sig.values()))
        results.append(r)
        if params.warm_start:
            prev_models = dict(r.model.coordinates)
    if n_resumed:
        log.info("resumed %d/%d grid points from %s", n_resumed,
                 len(grid), manifest_path)
    return results, n_resumed


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="photon-tpu GAME training driver (PyTorch port)")
    p.add_argument("--config", required=True, help="JSON TrainingParams file")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="the reference's solver snapshots (not ported: "
                        "ROADMAP queue A item 11)")
    p.add_argument("--resume", dest="ckpt_resume", action="store_true",
                   default=None)
    p.add_argument("--no-resume", dest="ckpt_resume", action="store_false")
    p.add_argument("--ingest-workers", type=int, default=None,
                   help="the reference's ingest plane (not ported: "
                        "ROADMAP queue A item 8b)")
    p.add_argument("--chunk-cache-dir", default=None,
                   help="the reference's chunk cache (not ported: "
                        "ROADMAP queue A item 8b)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        params = TrainingParams(**json.load(f))
    if args.checkpoint_dir is not None:
        params.checkpoint_dir = args.checkpoint_dir
    if args.ckpt_resume is not None:
        params.checkpoint_resume = args.ckpt_resume
    if args.ingest_workers is not None:
        params.ingest_workers = args.ingest_workers
    if args.chunk_cache_dir is not None:
        params.chunk_cache_dir = args.chunk_cache_dir
    out = run_training(params, device=args.device)
    print(json.dumps({
        "model_dir": out.model_dir,
        "validation_score": out.best.validation_score,
        "n_models": len(out.results),
    }))


if __name__ == "__main__":
    main()
