"""GAME training driver: Avro files in → validated best model out.

Reference parity: com.linkedin.photon.ml.cli.game.training.GameTrainingDriver
(scopt CLI → feature shards → coordinate configs → GameEstimator.fit over the
regularization grid → validation model selection → save best model to HDFS).
Here the same pipeline is a dataclass config + `run_training()`, with a JSON
CLI.

Hyperparameter search: the reference's grid mode maps to the cartesian
product of each coordinate's `reg_weights`; its Bayesian search
(HyperparameterTuner) to ``tuning_iters > 0``, which runs the GP tuner
(`tuning.tune`) over the log reg weights of every regularized coordinate,
each evaluation a `GameEstimator.fit` with validation, in any read regime.

The port's copy of `photon_tpu/drivers/train.py`
(``python -m photon_tpu_torch.drivers.train --config job.json``, on the
GPU unless ``run_training(..., device="cpu")``): read (the native Avro
decoder, pure Python as its fallback), validate, summarize, normalize,
down-sample, `GameEstimator.fit` over the grid with validation, the extra
evaluators, `best_model`, save, and ``output_mode="ALL"`` with per-point
resume. Three read regimes, as the reference's:

- in memory (`read_game_data`), at or below ``streaming_threshold_rows``
  training rows (a header-only count) or with ``streaming=False``;
- streamed to the device (`_read_streaming`): frozen maps from one
  native pass, then chunks straight into preallocated device tensors
  (`data.streaming.stream_to_device`), validated and summarized chunk by
  chunk — above the threshold or with ``streaming=True``;
- the streamed objective (`_read_streamed_objective`): shards used only
  by fixed effects stay on the host as chunks the streamed solvers
  re-upload every pass (`stream_to_host`), when the device-resident
  estimate exceeds the device budget (`hbm_budget_bytes`, else the
  card's memory) or with ``streamed_objective=True``.

``ingest_workers`` and ``chunk_cache_dir`` engage the ingest plane
(`data.ingest_plane`) in both streamed regimes. ``checkpoint_dir`` opens
a process-wide `checkpoint` session over the train phase (relative paths
land under ``output_dir``): the streamed solves and GAME's descent
snapshot into it at the ``checkpoint_every_s`` / ``checkpoint_every_evals``
cadence, and a rerun with the same params resumes from the last commit
(``checkpoint_resume``).

With ``mesh`` (a `parallel.mesh.Mesh`, in process or across processes)
the data lands whole on the mesh's home device — the entity bucketing
reads every row — and `GameEstimator(mesh=)` shards it: the fixed
effects row-sharded over the slots, the random effects' entity lanes
split over them. A streamed objective's chunks stream row-sharded over
the slots. The auto-trip's budget pools the mesh's cards (the smallest
card's budget times the distinct cards across the processes). Only
process 0 writes the model directories; the log lines name the mesh.

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

from photon_tpu_torch import checkpoint, telemetry
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
                                            default_down_sample,
                                            down_sample_weights)
from photon_tpu_torch.data.statistics import FeatureSummary
from photon_tpu_torch.data.streaming import (build_index_maps_streaming,
                                             scan_ingest, stream_to_device,
                                             stream_to_host)
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
from photon_tpu_torch.parallel.mesh import check_mesh
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
    # Streaming ingestion (reference: AvroDataReader reads partitioned data
    # through Spark and never materializes the dataset on one host).
    # Tri-state: None streams when the container-block headers count more
    # than `streaming_threshold_rows` rows; True forces it; False keeps
    # the one-shot reader. Streaming needs frozen index maps (built in one
    # bounded pass, or prebuilt via index_map_dir), validates + summarizes
    # chunk by chunk, lands data straight in preallocated device tensors,
    # and expresses down-sampling as weight-0 rows (identical weighted
    # objective; the row count is unchanged).
    streaming: Optional[bool] = None
    streaming_threshold_rows: int = 2_000_000
    streaming_chunk_rows: int = 65536
    # Streamed-objective (out-of-device-memory) mode: shards used only by
    # fixed effects live on the HOST as chunks and every solver evaluation
    # streams them through the device (optim/streamed.py). Tri-state: None
    # trips when the device-resident estimate exceeds the device budget
    # (`hbm_budget_bytes`, else the card's memory; on the CPU only an
    # explicit budget trips it); True forces it; False never.
    streamed_objective: Optional[bool] = None
    hbm_budget_bytes: Optional[int] = None
    # Rows per host chunk of a streamed-objective shard.
    objective_chunk_rows: int = 1 << 20
    # Storage dtype for streamed feature values ("bfloat16" halves the
    # device bytes of big shards; compute stays f32). None keeps float32.
    streaming_feature_dtype: Optional[str] = None
    # The ingest plane (data/ingest_plane.py): ingest_workers > 0 decodes
    # Avro container blocks in that many spawn worker processes (chunk
    # order bit-identical to the serial reader; a dead worker degrades
    # that chunk to in-process decode); chunk_cache_dir commits decoded
    # chunks once (mmap-able .npy + manifest) and every later run with the
    # same key opens them and never touches Avro. Relative cache paths
    # land under output_dir.
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
    # Bayesian reg-weight search (reference: HyperparameterTuner): GP
    # rounds over log reg weights of every regularized coordinate
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
    # Crash-consistent solver snapshots: a `checkpoint` session over the
    # train phase (relative paths land under output_dir)
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


def run_training(params: TrainingParams, mesh=None,
                 device=None) -> TrainingOutput:
    """The full reference pipeline on ``device`` (default ``cuda``): read
    (in memory, streamed to the device, or the streamed objective) →
    validate → (summarize, normalize, down-sample) → train over the config
    grid → select best on validation → save."""
    check_mesh(mesh)
    dev = mesh.home if mesh is not None else resolve_device(device)
    on_mesh = ("" if mesh is None else
               f" (mesh of {mesh.n_slots} slots over "
               f"{mesh.process_count} process(es))")
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
        n_train_rows = None
        train_block_index = None
        streaming = params.streaming
        if streaming is None:
            # resolved into a LOCAL: the caller's config stays a reusable
            # tri-state. The header-only scan records the block index the
            # ingest plane reuses.
            scan0 = scan_ingest(params.train_path, GameDataConfig(shards={}))
            n_train_rows = scan0.n_rows
            train_block_index = scan0.block_index
            streaming = n_train_rows > params.streaming_threshold_rows
            log.info("%d training rows against streaming_threshold_rows=%d:"
                     " %s", n_train_rows, params.streaming_threshold_rows,
                     "streaming" if streaming else "in memory")
        stream_stats: dict = {}
        streamed_obj = False
        # An EXPLICIT hbm_budget_bytes opts into the streamed-objective
        # check even below the streaming threshold.
        frozen_maps = None
        if (streaming or params.streamed_objective
                or (params.streamed_objective is None
                    and params.hbm_budget_bytes is not None)):
            # frozen maps built ONCE (one native pass that also counts
            # rows and records the block index), shared by the estimate
            # and whichever streamed read runs
            scan = scan_ingest(params.train_path, data_cfg, prebuilt_maps)
            frozen_maps = scan.index_maps
            train_block_index = scan.block_index
            if n_train_rows is None:
                n_train_rows = scan.n_rows
            streamed_obj = _resolve_streamed_objective(
                params, frozen_maps, n_train_rows, dev, log, mesh)
        if streamed_obj:
            index_maps = frozen_maps
            chunked = _streamable_shards(params)
            data, validation, stream_stats, n_real = \
                _read_streamed_objective(
                    params, data_cfg, task, mode, index_maps,
                    n_train_rows, chunked, dev,
                    block_index=train_block_index)
            log.info(
                "streamed objective engaged: %d rows; host-chunked "
                "shards %s (%d-row chunks), resident shards %s%s",
                n_real, sorted(chunked), params.objective_chunk_rows,
                sorted(set(params.feature_shards) - chunked),
                "" if mesh is None else
                f"; chunks row-shard over the {mesh.n_slots}-slot mesh")
        elif streaming:
            data, validation, index_maps, stream_stats, n_real = \
                _read_streaming(params, data_cfg, task, mode, frozen_maps,
                                dev, n_train_rows,
                                block_index=train_block_index)
            log.info("streamed %d training rows to %s, %d shards%s",
                     n_real, dev, len(data.shards), on_mesh)
        else:
            data, index_maps = read_game_data(
                params.train_path, data_cfg,
                index_maps=(frozen_maps if frozen_maps is not None
                            else prebuilt_maps),
                sparse_k=params.sparse_k)
            validation = None
            if params.validation_path:
                validation, _ = read_game_data(
                    params.validation_path, data_cfg, index_maps=index_maps,
                    sparse_k=params.sparse_k)
            log.info("read %d training rows, %d shards%s", data.n,
                     len(data.shards), on_mesh)

    with timers("validate"):
        # the streamed reads validated every chunk inside the read pass
        if not streaming and not streamed_obj:
            validate_game_data(data, task, mode)
            if validation is not None:
                validate_game_data(validation, task, mode)

    # Summaries and normalization are computed BEFORE down-sampling in
    # every read regime: statistics describe the dataset, down-sampling is
    # a training trick — and the model must not change when the streaming
    # tri-state flips as the data grows.
    summaries = {}
    if params.summarization_output_dir is not None:
        summary_dir = params.summarization_output_dir
        if not os.path.isabs(summary_dir):
            summary_dir = os.path.join(params.output_dir, summary_dir)
        os.makedirs(summary_dir, exist_ok=True)
        with timers("summarize"):
            for shard_name in params.feature_shards:
                # the streamed reads merged chunk summaries in the read
                s = (stream_stats[shard_name] if shard_name in stream_stats
                     else FeatureSummary.compute(data.shards[shard_name],
                                                 device=dev))
                s.save(os.path.join(summary_dir, f"{shard_name}.json"))
                summaries[shard_name] = s
        log.info("wrote feature summaries for %d shards to %s",
                 len(summaries), summary_dir)
    elif stream_stats:
        # normalization-only statistics (no summary files asked for)
        summaries = dict(stream_stats)

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
            if streaming or streamed_obj:
                # streamed data: dropped rows become weight-0 rows (the
                # same weighted objective; rows are not re-indexed, and no
                # weight-0 row enters a random effect's active set)
                new_w = down_sample_weights(
                    np.asarray(data.y), params.down_sampling_rate,
                    np.asarray(data.weights), params.seed,
                    binary=_binary_task(task))
                log.info("down-sampled to %d weight-carrying rows of %d",
                         int((new_w > 0).sum()), data.n)
                data = GameData(data.y, np.asarray(new_w, np.float32),
                                data.offsets, data.shards, data.entity_ids)
            else:
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
        mesh=mesh,
        device=dev,
    )

    if streamed_obj:
        re_coords = sorted(n for n, s in params.coordinates.items()
                           if s.entity_name is not None)
        if re_coords:
            # the composed GAME regime: streamed fixed-effect coordinate(s)
            # + resident random-effect buckets
            telemetry.count("game_e2e.pod_scale_runs")
            log.info(
                "GAME end-to-end streamed regime: fixed-effect "
                "coordinate(s) solve out of device memory on host-chunked "
                "shards %s; random-effect coordinate(s) %s train resident%s;"
                " inter-coordinate scores exchange through host margin "
                "caches", sorted(_streamable_shards(params)), re_coords,
                "" if mesh is None else
                f", their lanes split over the {mesh.n_slots}-slot mesh")

    ckpt_active = False
    if params.checkpoint_dir:
        ckpt_dir = params.checkpoint_dir
        if not os.path.isabs(ckpt_dir):
            ckpt_dir = os.path.join(params.output_dir, ckpt_dir)
        sess = checkpoint.start_session(
            ckpt_dir, every_s=params.checkpoint_every_s,
            every_evals=params.checkpoint_every_evals,
            keep=params.checkpoint_keep, resume=params.checkpoint_resume,
            async_writer=params.checkpoint_async)
        ckpt_active = True
        if sess.restored_any():
            log.info("checkpoint/restore: resuming training from the last "
                     "committed snapshot in %s", ckpt_dir)
        else:
            log.info("checkpoint/restore: snapshotting to %s (every_s=%s, "
                     "every_evals=%s, keep=%d)", ckpt_dir,
                     params.checkpoint_every_s,
                     params.checkpoint_every_evals, params.checkpoint_keep)

    n_resumed = 0
    try:
        with timers("train"):
            if params.tuning_iters > 0:
                results = _tune(estimator, params, data, validation, log,
                                initial_models, dev)
            elif params.resume:
                results, n_resumed = _fit_grid_resumable(
                    estimator, params, data, validation, initial_models,
                    index_maps, log, dev, streaming, streamed_obj)
            else:
                results = estimator.fit(
                    data, validation=validation,
                    config_grid=_config_grid(params.coordinates),
                    initial_models=initial_models)
    finally:
        if ckpt_active:
            # drain the writer either way: on success a rerun restores the
            # complete state; on a crash the last commit is the resume point
            checkpoint.finish_session()
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

    writer = mesh is None or mesh.process_index == 0
    with timers("save"):
        # Training-row manifest: the delta baseline a continual refresh
        # diffs the next data drop against, beside the coefficients.
        manifest = build_manifest(data)
        model_dir = os.path.join(params.output_dir, "best_model")
        if writer:  # every process holds the same models
            save_game_model(
                model_dir, best.model,
                {n: index_maps[params.coordinates[n].feature_shard]
                 for n in best.model.names()},
                manifest=manifest,
            )
        if writer and params.output_mode.upper() == "ALL":
            models_dir = os.path.join(params.output_dir, "models")
            os.makedirs(models_dir, exist_ok=True)
            gsig = _global_signature(params, streaming, streamed_obj)
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


def _ingest_cache_dir(params: TrainingParams):
    """chunk_cache_dir resolved like checkpoint_dir: relative paths land
    under the run's output dir."""
    d = params.chunk_cache_dir
    if d and not os.path.isabs(d):
        d = os.path.join(params.output_dir, d)
    return d


def _stats_hook(params: TrainingParams, task: TaskType,
                mode: DataValidationType, stats: dict):
    """(hook factory) for the streamed reads: each chunk is validated, and
    the shards that need statistics (summaries, normalization) fold their
    chunk summaries into ``stats`` (numpy, f64; merged by Chan's update).
    Statistics see the chunks as decoded, so they are exact over the real
    rows."""
    need_stats = set()
    if params.summarization_output_dir is not None:
        need_stats |= set(params.feature_shards)
    if NormalizationType(params.normalization) is not NormalizationType.NONE:
        need_stats |= {s.feature_shard for s in params.coordinates.values()}

    def make_hook(collect_stats: bool):
        def hook(chunk):
            validate_game_data(chunk, task, mode)
            if collect_stats:
                for s in need_stats:
                    cs = FeatureSummary.compute_host(chunk.shards[s])
                    stats[s] = cs if s not in stats else stats[s].merge(cs)
        return hook

    return make_hook, bool(need_stats)


def _read_streaming(params: TrainingParams, data_cfg: GameDataConfig,
                    task: TaskType, mode: DataValidationType,
                    prebuilt_maps, device, n_train_rows=None,
                    block_index=None):
    """Bounded-host-memory read (reference: AvroDataReader + the training
    driver never materialize the dataset on one host): frozen index maps
    from one block-stream pass, then chunks land straight in their device
    tensors (`stream_to_device`, a stall-driven `AdaptivePrefetch` over
    its staging buffers), with per-chunk validation and mergeable summary
    statistics folded into the same pass. The scalar columns come back to
    the host (12 bytes a row: the estimator's entity bucketing and
    down-sampling read them there); the shards stay on the device."""
    from photon_tpu_torch.data.ingest_plane import (AdaptivePrefetch,
                                                    DecodePool)
    from photon_tpu_torch.data.matrix import _host

    index_maps = build_index_maps_streaming(
        params.train_path, data_cfg, prebuilt_maps)
    stats: dict = {}
    make_hook, collect = _stats_hook(params, task, mode, stats)
    with DecodePool() as pool:  # one worker start for both reads
        data, n_real = stream_to_device(
            params.train_path, data_cfg, index_maps,
            chunk_rows=params.streaming_chunk_rows, sparse_k=params.sparse_k,
            feature_dtype=params.streaming_feature_dtype,
            chunk_hook=make_hook(collect), n_rows=n_train_rows,
            prefetch=AdaptivePrefetch(), workers=params.ingest_workers,
            cache_dir=_ingest_cache_dir(params), block_index=block_index,
            device=device, pool=pool)
        validation = None
        if params.validation_path:
            validation, _ = stream_to_device(
                params.validation_path, data_cfg, index_maps,
                chunk_rows=params.streaming_chunk_rows,
                sparse_k=params.sparse_k,
                feature_dtype=params.streaming_feature_dtype,
                chunk_hook=make_hook(False), workers=params.ingest_workers,
                cache_dir=_ingest_cache_dir(params), device=device,
                pool=pool)
    data = GameData(_host(data.y), _host(data.weights), _host(data.offsets),
                    data.shards, data.entity_ids)
    return data, validation, index_maps, stats, n_real


def _streamable_shards(params: TrainingParams) -> set:
    """Shards eligible for host-chunking: used by fixed-effect coordinates
    ONLY (random-effect bucketing gathers rows, so its shards must stay
    resident; shards no coordinate uses stay resident too)."""
    fixed = {s.feature_shard for s in params.coordinates.values()
             if s.entity_name is None}
    re = {s.feature_shard for s in params.coordinates.values()
          if s.entity_name is not None}
    return fixed - re


def _detect_hbm_budget(device, mesh=None) -> Optional[int]:
    """The device's memory budget for the auto-trip: the card's free
    bytes plus what this process's allocator already holds (the room the
    dataset could take), from ``torch.cuda.mem_get_info``. With ``mesh``
    the smallest of this process's slot cards (other processes' cards
    cannot be asked; a mesh is homogeneous in practice). None on the
    CPU: there the streamed objective engages only when asked for or
    given an explicit ``hbm_budget_bytes``."""
    import torch

    devs = ([torch.device(device)] if mesh is None
            else list(dict.fromkeys(mesh.slot_devices)))
    if devs[0].type != "cuda":
        return None
    room = []
    for dev in devs:
        free, _total = torch.cuda.mem_get_info(dev)
        room.append(int(free) + int(torch.cuda.memory_reserved(dev)))
    return min(room)


def _mesh_cards(mesh) -> int:
    """Distinct cards under a mesh: this process's slot devices times
    the processes (slots sharing a card pool nothing)."""
    return len(set(mesh.slot_devices)) * mesh.process_count


def _estimate_device_bytes(n_rows: int, index_maps: dict,
                           params: TrainingParams) -> int:
    """Device-resident footprint estimate of the dataset from the frozen
    maps + header row count alone (no data read): scalars at 12 B/row,
    dense shards at d×value bytes, sparse shards at k×(index+value)."""
    val_bytes = 2 if params.streaming_feature_dtype in ("bfloat16",
                                                        "float16") else 4
    total = 12 * n_rows
    for s, cfg in params.feature_shards.items():
        d = index_maps[s].n_features
        if d <= cfg.dense_threshold:
            total += n_rows * d * val_bytes
        elif params.sparse_k is not None:
            total += n_rows * params.sparse_k * (4 + val_bytes)
    return int(total)


def _resolve_streamed_objective(params: TrainingParams, index_maps: dict,
                                n_rows: int, device, log, mesh=None) -> bool:
    """The streamed-objective tri-state, resolved: forced True/False wins;
    None trips when the device-resident estimate exceeds the budget
    (``hbm_budget_bytes``, else `_detect_hbm_budget`; on the CPU, with no
    budget given, it stays resident). Under a mesh the budget is pooled:
    the per-card budget times the mesh's distinct cards (a streamed mesh
    solve gives each card its slots' rows). Every resolution is logged at
    INFO — estimate, budget, mesh, verdict — so a surprising regime choice
    is diagnosable from the run log."""
    forced = params.streamed_objective
    if forced is False:
        log.info("streamed objective: OFF (forced by streamed_objective="
                 "False)")
        return False
    if forced:
        if not _streamable_shards(params):
            raise ValueError(
                "streamed_objective=True needs at least one shard used "
                "exclusively by fixed-effect coordinates (random-effect "
                "shards must stay resident for entity bucketing)")
        log.info("streamed objective: ON (forced by streamed_objective="
                 "True)")
        return True
    est = _estimate_device_bytes(n_rows, index_maps, params)
    budget = (params.hbm_budget_bytes if params.hbm_budget_bytes
              else _detect_hbm_budget(device, mesh))
    if budget is not None and mesh is not None:
        budget *= _mesh_cards(mesh)
    telemetry.gauge("train.dataset_estimate_bytes", est)
    if budget is None:
        log.info(
            "streamed objective auto-resolution: dataset estimate %.3f GiB "
            "(%d rows) on %s, which has no device budget and none was "
            "given (hbm_budget_bytes): verdict resident", est / 2**30,
            n_rows, device)
        return False
    chunked = _streamable_shards(params)
    verdict = est > budget and bool(chunked)
    telemetry.gauge("train.hbm_budget_bytes", budget)
    log.info(
        "streamed objective auto-resolution: dataset estimate %.3f GiB "
        "(%d rows), device budget %.3f GiB (%s%s), verdict %s",
        est / 2**30, n_rows, budget / 2**30,
        "hbm_budget_bytes" if params.hbm_budget_bytes else str(device),
        "" if mesh is None else
        f", pooled over the {_mesh_cards(mesh)} card(s) of a "
        f"{mesh.n_slots}-slot mesh",
        "STREAM" if verdict else "resident")
    if est > budget and not chunked:
        log.warning(
            "dataset estimate %.3f GiB exceeds the device budget %.3f GiB "
            "but no shard is fixed-effect-only; staying device-resident "
            "(expect an out-of-memory error at this scale)",
            est / 2**30, budget / 2**30)
    return verdict


def _read_streamed_objective(params: TrainingParams,
                             data_cfg: GameDataConfig, task: TaskType,
                             mode: DataValidationType, index_maps: dict,
                             n_train_rows: int, chunked_shards: set,
                             device, block_index=None):
    """The out-of-device-memory read: training data lands HOST-resident —
    the fixed-effect shards as uniform ChunkedMatrix chunks the streamed
    solvers re-upload pass by pass, everything else as host numpy the
    GAME layer moves as needed. Per-chunk validation and mergeable
    statistics ride the same pass, as in `_read_streaming`. Validation
    data streams to the device (it is scored, not solved)."""
    from photon_tpu_torch.data.ingest_plane import DecodePool

    stats: dict = {}
    make_hook, collect = _stats_hook(params, task, mode, stats)
    with DecodePool() as pool:  # one worker start for both reads
        data, n_real = stream_to_host(
            params.train_path, data_cfg, index_maps,
            chunked_shards=chunked_shards,
            chunk_rows=params.streaming_chunk_rows,
            objective_chunk_rows=params.objective_chunk_rows,
            sparse_k=params.sparse_k,
            feature_dtype=params.streaming_feature_dtype,
            chunk_hook=make_hook(collect), n_rows=n_train_rows,
            workers=params.ingest_workers,
            cache_dir=_ingest_cache_dir(params), block_index=block_index,
            pool=pool)
        validation = None
        if params.validation_path:
            validation, _ = stream_to_device(
                params.validation_path, data_cfg, index_maps,
                chunk_rows=params.streaming_chunk_rows,
                sparse_k=params.sparse_k,
                feature_dtype=params.streaming_feature_dtype,
                chunk_hook=make_hook(False), workers=params.ingest_workers,
                cache_dir=_ingest_cache_dir(params), device=device,
                pool=pool)
    return data, validation, stats, n_real


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
                        device, streaming: bool = False,
                        streamed_obj: bool = False):
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
    gsig = _global_signature(params, streaming, streamed_obj)
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
            mesh = estimator.mesh
            if mesh is None or mesh.process_index == 0:
                save_game_model(
                    point_dir, r.model,
                    {n: index_maps[params.coordinates[n].feature_shard]
                     for n in r.model.names()})
            manifest_by_sig[sig] = _manifest_row(point_dir, r, best=False,
                                                 sig=sig)
            # checkpoint the manifest NOW (atomically): a crash at the
            # next point loses only that point ("best" flags are
            # finalized in the save phase)
            if mesh is None or mesh.process_index == 0:
                _write_manifest(manifest_path,
                                list(manifest_by_sig.values()))
        results.append(r)
        if params.warm_start:
            prev_models = dict(r.model.coordinates)
    if n_resumed:
        log.info("resumed %d/%d grid points from %s", n_resumed,
                 len(grid), manifest_path)
    return results, n_resumed


def _tune(estimator: GameEstimator, params: TrainingParams, data,
          validation, log, initial_models=None, device=None) -> list:
    """GP search over the log reg weights of every regularized coordinate
    (reference: HyperparameterTuner driven by GameEstimator evaluations),
    the GP on the run's device."""
    from photon_tpu_torch.evaluation.evaluator import default_evaluator
    from photon_tpu_torch.tuning import SearchRange, SearchSpace, tune

    if validation is None:
        raise ValueError("tuning_iters > 0 requires validation_path")
    names = [n for n, s in params.coordinates.items()
             if s.reg_type.lower() != "none"]
    if not names:
        raise ValueError("tuning requires at least one regularized coordinate")
    evaluator = estimator.evaluator or default_evaluator(estimator.task)
    lo, hi = params.tuning_range
    space = SearchSpace([SearchRange(lo, hi, log_scale=True)] * len(names))
    results: list = []

    def evaluate_batch(X) -> list:
        grid = [{n: params.coordinates[n].coordinate_config(w)
                 for n, w in zip(names, x)} for x in np.atleast_2d(X)]
        out = []
        for r in estimator.fit(data, validation=validation, config_grid=grid,
                               initial_models=initial_models):
            results.append(r)
            score = r.validation_score
            # the tuner minimizes: flip metrics where higher is better
            out.append(-score if evaluator.higher_is_better else score)
        return out

    batch = max(1, int(params.tuning_batch))
    if batch > 1:
        # the gate fit() itself applies, probed here so that a sequential
        # "batched" tune says so
        probe = [{n: params.coordinates[n].coordinate_config(w)
                  for n in names} for w in (lo, hi)]
        if not estimator.would_vectorize(probe, initial_models=initial_models,
                                         data=data):
            log.info(
                "tuning_batch=%d requested but the reg grid would not "
                "vectorize (warm starts, locked/incremental coordinates, "
                "or an unsupported matrix layout); tuning point-at-a-time",
                batch)
            batch = 1
    outcome = tune(None, space, n_iters=params.tuning_iters,
                   seed=params.seed, batch_size=batch,
                   evaluate_batch=evaluate_batch, device=device)
    log.info("tuner best reg weights: %s -> %.6f",
             dict(zip(names, outcome.best_x)), outcome.best_y)
    return results


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="photon-tpu GAME training driver (PyTorch port)")
    p.add_argument("--config", required=True, help="JSON TrainingParams file")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="crash-consistent solver snapshots (relative paths "
                        "land under output_dir); a rerun resumes from the "
                        "last committed snapshot")
    p.add_argument("--resume", dest="ckpt_resume", action="store_true",
                   default=None)
    p.add_argument("--no-resume", dest="ckpt_resume", action="store_false")
    p.add_argument("--ingest-workers", type=int, default=None,
                   help="decode Avro container blocks in this many worker "
                        "processes (the ingest plane; overrides the "
                        "config's ingest_workers; 0 = in-process)")
    p.add_argument("--chunk-cache-dir", default=None,
                   help="decode-once columnar chunk cache directory "
                        "(overrides the config's chunk_cache_dir; "
                        "relative paths land under output_dir). A rerun "
                        "with an unchanged dataset/config/index-map key "
                        "opens mmap'd chunks and never touches Avro")
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
