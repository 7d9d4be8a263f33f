"""Prior warm-started partial re-solves: the flywheel's training half
(port of `photon_tpu/continual/refresh.py`).

Reference parity: Photon-ML's incremental training
(`function.PriorDistribution` + GameTrainingDriver `--initial-model`):
the previous run's posterior (coefficient means + variances) becomes a
Gaussian prior and warm start for the next solve. The reference still
re-solves EVERY entity; here the delta plan (`continual.delta`) says
which entities actually gained evidence, and only those re-solve:

- the fixed effect stays FROZEN (it is every row's offset — retraining it
  is a full-retrain decision, not an hourly one); its scores, plus every
  other coordinate's scores from the previous model, form the offsets of
  the partial re-solve exactly as a locked coordinate's do in
  `game.coordinate_descent`;
- each touched random-effect bucket gathers ONLY its touched lanes —
  the batch by `data.matrix.EntityBlocks.take` and
  `game.random_effect.take_lanes`, the warm starts (the previous
  model's coefficients) and the per-entity priors
  (`game.random_effect.align_entity_priors` × ``prior_scale``) by
  `parallel.mesh.compact_rows` — into one block whose touched count is
  zero-padded to a multiple of `REFRESH_LANES`;
- the padded block runs through `RandomEffectCoordinate.solve_lanes`,
  the lane solvers full training uses, with the priors per lane, in that
  function's `lane_chunk(m, e_pad)` chunks: one lock-step solve per chunk
  costs its host launches per iteration, so the block is not cut into a
  solve per 64 lanes as the reference's scan is. The fixed pad target is
  what makes shapes repeat: a refresh whose touched counts pad to the
  same targets records the same signatures (`RefreshResult.signatures`,
  on the port's `telemetry.run.SignatureLog`);
- with ``mesh`` (reference: `refresh_game_model(mesh=)`) the pad quantum
  rounds up to a slot multiple, and the padded block's lanes split over
  the slots, each local slot solving its contiguous share on its device
  (`RandomEffectCoordinate.solve_lanes_mesh`), the results gathered in
  slot order (one gather per bucket). The refreshed model, its publish
  and the serving hot swap stay on one device.

A zero lane (weight-0 rows, start 0, prior precision 0) has a zero
gradient: it converges at iteration 0, and an entity's result does not
depend on which lanes share its solve. Untouched entities keep their
previous coefficients and variances BIT-identically (the refresh only
scatters touched rows); entities new to the drop are deferred
(`CoordinatePlan.new_keys`) — the previous entity space is the serving
hot-swap's shape contract. The reference's jaxpr contracts on this path
(``continual_re_refresh_solve``, ``continual_refresh_no_retrace``) wait
for the port of `analysis/` (ROADMAP queue A item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.game.dataset import RandomEffectDataset
from photon_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_tpu_torch.game.random_effect import (RandomEffectCoordinate,
                                                 align_entity_priors,
                                                 take_lanes)
from photon_tpu_torch.models.variance import VarianceComputationType
from photon_tpu_torch.parallel.mesh import (check_mesh, compact_rows,
                                            pad_to_multiple)
from photon_tpu_torch.telemetry.run import SignatureLog, float_drift

# Fixed lane quantum of compacted refresh blocks: every touched count pads
# to a multiple of this, so a bucket's solve shapes depend on its height,
# its dim and its padded count — not on WHICH entities were touched.
REFRESH_LANES = 64

# The refresh path's live signature log (the serving ProgramLadder
# pattern): every compacted solve records here, and
# `RefreshResult.assert_no_retrace` proves repeated refreshes reuse the
# same shapes.
_SIG_LOG = SignatureLog()
_SIG_NAME = "continual.re_refresh_solve"


@dataclasses.dataclass
class CoordinateRefreshStats:
    """One coordinate's partial re-solve accounting."""

    n_touched: int
    n_deferred_new: int
    buckets_touched: int
    buckets_skipped: int
    solve_dispatches: int
    total_iterations: int
    n_converged: int
    n_failed: int


@dataclasses.dataclass
class RefreshResult:
    """A refreshed GameModel + the accounting that makes the delta path
    auditable (what re-solved, what was skipped, what took new shapes)."""

    model: GameModel
    stats: dict  # coordinate name -> CoordinateRefreshStats
    # coordinate name -> raw keys of the refreshed entities whose solve
    # failed (a line search that found no decrease), for the operator
    failed_keys: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def signatures() -> list:
        """Distinct compacted-solve argument signatures seen process-wide
        (one per (bucket height, dim, padded count) — NOT per refresh)."""
        return _SIG_LOG.signatures(_SIG_NAME)

    @staticmethod
    def assert_no_retrace(baseline: int) -> int:
        """Prove a refresh added no signatures over ``baseline`` (the
        count captured after the warming refresh) and that no floating
        argument drifted off f32 (the counterpart of the reference's
        weak-type check). Returns the current distinct-signature count."""
        sigs = _SIG_LOG.signatures(_SIG_NAME)
        if len(sigs) > baseline:
            raise AssertionError(
                f"{len(sigs)} refresh solve signatures exceed the warmed "
                f"baseline of {baseline}: the delta path took new shapes")
        drift = sorted({d for s in sigs for d in float_drift(s)})
        if drift:
            raise AssertionError(
                f"dtype drift in refresh solve arguments: {drift}")
        return len(sigs)


def _other_scores_host(prev_model: GameModel, drop, skip: str) -> np.ndarray:
    """offsets + every coordinate's previous-model margin EXCEPT `skip`,
    as one host (n,) f32 vector — the locked-coordinate offsets of the
    partial re-solve."""
    from photon_tpu_torch.game.scoring import coordinate_scores

    out = np.asarray(drop.offsets, np.float32).copy()
    for name, s in coordinate_scores(prev_model, drop).items():
        if name != skip:
            out += s.cpu().numpy().astype(np.float32, copy=False)
    return out


def _optimizer_config(cname: str, cfg):
    """An OptimizerConfig, or the estimator's RandomEffectConfig (its
    optimizer; a projected one is refused)."""
    if cfg is None:
        raise KeyError(
            f"no OptimizerConfig for refreshed coordinate {cname!r}; pass "
            "the config it trained with")
    if hasattr(cfg, "projection"):
        if cfg.projection is not None:
            raise ValueError(
                "continual refresh does not support projected random-"
                f"effect spaces (coordinate {cname!r}); rebuild the drop "
                "without projection")
        return cfg.optimizer
    return cfg


def refresh_game_model(
    prev_model: GameModel,
    drop,
    plan,
    configs: dict,
    *,
    mesh=None,
    variance: Optional[VarianceComputationType] = None,
    prior_scale: float = 1.0,
    lane_chunk: int = REFRESH_LANES,
) -> RefreshResult:
    """Partial re-solve of every coordinate the plan touches, on the
    previous model's device.

    ``configs``: coordinate name → the OptimizerConfig of its per-entity
    solves (typically the config it trained with), or the estimator's
    `RandomEffectConfig` (a projected one raises ``ValueError``).
    ``variance``: variance recomputation for refreshed entities; default
    SIMPLE when the previous model carries variances (so the NEXT refresh
    has a posterior to build priors from), NONE otherwise.
    ``prior_scale``: the reference's incremental-weight multiplier on the
    prior precision (1.0 = trust the previous posterior as-is).
    ``lane_chunk``: the pad quantum of a bucket's touched count (rounded
    up to a multiple of ``mesh``'s slots, over which the solves split).
    """
    check_mesh(mesh)
    coords = dict(prev_model.coordinates)
    stats: dict = {}
    failed: dict = {}
    with telemetry.span("continual.refresh", touched=plan.n_touched):
        for cname, cplan in plan.coordinates.items():
            cm = prev_model.coordinates.get(cname)
            if not isinstance(cm, RandomEffectModel):
                raise TypeError(
                    f"refresh plan names coordinate {cname!r} which is not "
                    "a random effect in the previous model")
            cfg = _optimizer_config(cname, configs.get(cname))
            if cplan.n_touched == 0:
                stats[cname] = CoordinateRefreshStats(
                    0, int(cplan.new_keys.shape[0]), 0, 0, 0, 0, 0, 0)
                continue
            var_kind = variance
            if var_kind is None:
                var_kind = (VarianceComputationType.SIMPLE
                            if cm.variances is not None
                            else VarianceComputationType.NONE)
            with telemetry.span("continual.refresh_coordinate",
                                coordinate=cname, touched=cplan.n_touched):
                coords[cname], stats[cname], failed[cname] = \
                    _refresh_coordinate(
                        prev_model, cm, cplan, drop, cfg, variance=var_kind,
                        prior_scale=prior_scale, lane_chunk=lane_chunk,
                        mesh=mesh)
        telemetry.count("continual.refreshes")
    return RefreshResult(GameModel(coords, prev_model.task), stats, failed)


def _refresh_coordinate(prev_model: GameModel, cm: RandomEffectModel,
                        cplan, drop, cfg, *, variance, prior_scale,
                        lane_chunk, mesh=None):
    """One coordinate's compacted partial re-solve; returns the refreshed
    RandomEffectModel, its stats and the raw keys of its failed solves."""
    out_dev = cm.coefficients.device
    dev = out_dev if mesh is None else mesh.home
    if mesh is not None:
        lane_chunk = pad_to_multiple(int(lane_chunk), mesh.n_slots)
    ds = RandomEffectDataset.build(drop, cplan.entity_name,
                                   cm.feature_shard, device=dev)
    d = cm.dim
    if ds.dim != d:
        raise ValueError(
            f"drop shard {cm.feature_shard!r} has dim {ds.dim} but the "
            f"previous model's {cplan.name!r} coordinate has dim {d}; the "
            "refresh keeps the previous feature space — rebuild the drop "
            "with the saved feature index")
    offsets_dev = torch.from_numpy(
        _other_scores_host(prev_model, drop, cplan.name)).to(dev)

    # Alignment: drop-dataset entities → previous-model rows. Warm starts
    # and priors come from the previous posterior; rows of the previous
    # coefficient matrix are the scatter targets.
    pid = cm.dense_ids(ds.entity_keys)  # (E_ds,) rows in prev model
    w0_all = cm.coeffs_for(pid).to(dev, torch.float32)  # (E_ds, d)
    pm_all, pp_all = align_entity_priors(cm, ds.entity_keys, d)
    if prior_scale != 1.0:
        pp_all = (pp_all * np.float32(prior_scale)).astype(np.float32)
    pm_all, pp_all = (torch.from_numpy(a).to(dev) for a in (pm_all, pp_all))

    touched_set = set(np.asarray(cplan.touched_keys).astype(np.str_).tolist())
    ds_touched = np.asarray(
        [str(k) in touched_set for k in np.asarray(ds.entity_keys).tolist()],
        bool)

    coeffs = cm.coefficients.cpu().numpy().astype(np.float32)  # a copy
    variances = None
    if variance is not VarianceComputationType.NONE:
        variances = (cm.variances.cpu().numpy().astype(np.float32)
                     if cm.variances is not None else np.zeros_like(coeffs))

    coord = RandomEffectCoordinate(ds, cm.task, cfg, variance=variance,
                                   mesh=mesh)
    buckets_touched = buckets_skipped = dispatches = 0
    total_iters = n_conv = n_fail = 0
    failed = []
    for block in ds.blocks:
        lanes = np.nonzero(ds_touched[block.entity_index])[0]
        if lanes.size == 0:
            buckets_skipped += 1
            telemetry.count("continual.skipped_buckets")
            continue
        buckets_touched += 1
        telemetry.count("continual.touched_buckets")
        n2 = int(lanes.size)
        e_pad = pad_to_multiple(n2, int(lane_chunk))
        # THE compaction: touched lanes only, padded to the fixed quantum —
        # zero lanes carry weight 0 and converge at iteration 0
        ents = torch.from_numpy(block.entity_index.astype(np.int64)).to(dev)
        batch = take_lanes(ds.block_batch(block, offsets_dev), lanes, e_pad)
        W0, PM, PP = (t.t().contiguous() for t in compact_rows(
            (w0_all[ents], pm_all[ents], pp_all[ents]), lanes,
            pad_rows=e_pad))
        _SIG_LOG.record(_SIG_NAME, (batch.X.dense, batch.X.indices,
                                    batch.X.values, batch.y, batch.weights,
                                    batch.offsets, W0, PM, PP))
        with telemetry.span("continual.refresh_solve", m=block.m,
                            touched=n2):
            if mesh is not None:
                w2, conv2, fail2, it2, var = coord.solve_lanes_mesh(
                    coord.block_objective(block), batch, W0, PM, PP)
            else:
                res, var = coord.solve_lanes(coord.block_objective(block),
                                             batch, W0, PM, PP)
                w2, conv2, fail2, it2 = (t.cpu().numpy() for t in (
                    res.w, res.converged, res.failed, res.iterations))
                var = None if var is None else var.cpu().numpy()
        dispatches += 1
        telemetry.count("continual.refresh_solves")
        rows = pid[block.entity_index[lanes]]  # previous-model rows
        coeffs[rows] = w2[:n2]
        if variances is not None:
            variances[rows] = var[:n2]
        total_iters += int(it2[:n2].astype(np.int64).sum())
        n_conv += int(conv2[:n2].sum())
        n_fail += int(fail2[:n2].sum())
        failed.append(ds.entity_keys[block.entity_index[lanes[fail2[:n2]]]])
    telemetry.count("continual.refresh_iterations", total_iters)

    model = RandomEffectModel(
        entity_name=cm.entity_name, feature_shard=cm.feature_shard,
        task=cm.task, coefficients=torch.from_numpy(coeffs).to(out_dev),
        entity_keys=cm.entity_keys, key_to_index=cm.key_to_index,
        variances=None if variances is None
        else torch.from_numpy(variances).to(out_dev))
    return model, CoordinateRefreshStats(
        n_touched=cplan.n_touched,
        n_deferred_new=int(cplan.new_keys.shape[0]),
        buckets_touched=buckets_touched, buckets_skipped=buckets_skipped,
        solve_dispatches=dispatches, total_iterations=total_iters,
        n_converged=n_conv, n_failed=n_fail), (
            np.concatenate(failed) if failed else ds.entity_keys[:0])
