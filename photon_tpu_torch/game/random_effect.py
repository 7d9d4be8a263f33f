"""Random-effect coordinate: per-entity solves over bucketed blocks, the
entities of a bucket as the lanes of one lock-step solve (port of
`photon_tpu/game/random_effect.py`: `align_entity_priors`, `RETrainStats`
and `RandomEffectCoordinate.train`/`score`).

Reference parity: com.linkedin.photon.ml.algorithm.RandomEffectCoordinate
trains one solver per entity. The reference `vmap`s its scalar solver
over a bucket's entities; the port runs the lane solvers of the
regularization grid (`optim.lane_lbfgs`, `lane_owlqn`, `lane_tron`) with
lanes = entities: the bucket's `data.matrix.EntityBlocks` gives each lane
its own rows, (m, E) labels, weights and offsets, and per-lane priors.
As under `vmap`, a finished lane freezes while the others run on and
keeps its own iteration count, so an entity's result does not depend on
which entities share its solve.

A bucket solves in chunks of entities (`lane_chunk`), each chunk one
lock-step solve; a chunk's (m, E) tensors stay under `LANE_ELEMS`
elements (so its solver state stays a few GB at most on the card). The
block loop is the plain sequential one: bucket after bucket, each solved,
read back and scattered on the host. ``pipeline_depth`` is accepted and
changes nothing (the reference's pipelined loop is bit-identical to this
one at every depth); ``straggler_budget`` (the compacted re-solve of
unconverged lanes) is not ported yet.

A regularization grid over the GAME model (`game.grid`) solves a bucket
with G lanes per entity (`solve_block_grid`): lanes = (entity × grid
point), each entity's rows shared by its G lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.game.dataset import RandomEffectDataset, REBlock
from photon_tpu_torch.game.model import RandomEffectModel
from photon_tpu_torch.models.training import (_lane_result, _lane_solve,
                                              lane_weight_arrays,
                                              make_objective)
from photon_tpu_torch.models.variance import (VarianceComputationType,
                                              compute_variances_lanes)
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig
from photon_tpu_torch.optim.tracker import OptResult

# The largest (m, E) lane tensor of one chunk solve, in elements: 2^24 f32
# is 64 MB, and a lane L-BFGS keeps about a dozen such tensors plus its
# (history, d, E) pairs, so a chunk stays within a few GB of the card's
# 80 GB. Below it a whole bucket is one solve: every lock-step iteration
# costs the same host-side launches whatever E is, so fewer chunks mean
# fewer iterations' host work.
LANE_ELEMS = 1 << 24


def lane_chunk(m: int, e_real: int, lanes_per_entity: int = 1) -> int:
    """Entities per lock-step solve for a bucket of height ``m`` whose
    entities take ``lanes_per_entity`` lanes each (a grid's G: the chunk
    shrinks by G, as the reference's ``cap // G``)."""
    return max(1, min(e_real, LANE_ELEMS // max(m * lanes_per_entity, 1)))


def align_entity_priors(prior: RandomEffectModel, entity_keys, d: int):
    """A previous run's `RandomEffectModel` → per-entity Gaussian-prior
    blocks ``(means (E, d), precisions (E, d))`` (host numpy) aligned by
    entity KEY to ``entity_keys``. Entities unseen in the prior get
    precision 0 (no prior); with variances the precision is
    `PriorDistribution.from_variances`' diagonal (variance ≤ 0: no prior
    there); without, every seen entity gets unit precision."""
    from photon_tpu_torch.optim.prior import PriorDistribution

    entity_keys = np.asarray(entity_keys)
    E = int(entity_keys.shape[0])
    pid = prior.dense_ids(entity_keys)  # (E,) rows in the prior
    seen = (pid < prior.n_entities).astype(np.float32)[:, None]
    prior_means = prior.coeffs_for(pid).cpu().numpy().astype(np.float32)
    if prior.variances is not None:
        pvar = np.concatenate(
            [prior.variances.cpu().numpy().astype(np.float32),
             np.ones((1, d), np.float32)])[pid]
        dist = PriorDistribution.from_variances(prior_means, pvar)
        prior_precs = (seen * dist.precision_diag).astype(np.float32)
    else:
        prior_precs = seen * np.ones((E, d), np.float32)
    return prior_means, prior_precs


@dataclasses.dataclass
class RETrainStats:
    """Per-train diagnostics (reference: per-entity OptimizationTracker)."""

    n_entities: int
    n_converged: int
    n_failed: int
    total_iterations: int
    # (E,) solver iterations per dense entity id
    iterations_per_entity: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)


@dataclasses.dataclass(eq=False)
class RandomEffectCoordinate:
    """Reference: algorithm.RandomEffectCoordinate."""

    dataset: RandomEffectDataset
    task: TaskType
    config: OptimizerConfig
    mesh: Optional[object] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    # shard-level NormalizationContext shared by every entity's solve: the
    # lanes run in normalized space, coefficients convert back per row
    normalization: Optional[object] = None
    pipeline_depth: int = 1
    straggler_budget: Optional[int] = None

    def __post_init__(self):
        ds = self.dataset
        if self.mesh is not None:
            raise NotImplementedError(
                "meshes (entity blocks sharded over devices) are not ported "
                "yet (ROADMAP queue A item 10)")
        if int(self.pipeline_depth) < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if self._effective_budget() is not None:
            raise NotImplementedError(
                "straggler_budget (the compacted re-solve of unconverged "
                "entities) is not ported yet (ROADMAP queue A item 6)")
        if ds.projection is not None:
            if (self.normalization is not None
                    and not self.normalization.is_identity):
                raise ValueError(
                    "feature-space projection and normalization cannot be "
                    "combined on a random-effect coordinate; normalize the "
                    "shard before building the dataset instead")
            if (ds.projector is not None
                    and self.variance is not VarianceComputationType.NONE):
                raise ValueError(
                    "coefficient variances are not defined through a "
                    "RANDOM projection; use INDEX_MAP projection or no "
                    "projection")

    def _effective_budget(self) -> Optional[int]:
        b = self.straggler_budget
        if b is None or b <= 0 or b >= self.config.max_iters:
            return None
        return int(b)

    def _norm(self):
        n = self.normalization
        return n if n is not None and not n.is_identity else None

    def solve_block(self, block: REBlock, offsets_full, w0=None,
                    prior_means=None, prior_precs=None):
        """Every entity of one bucket as the lanes of lock-step solves, in
        chunks of `lane_chunk` entities, in the bucket's solve space
        (projected, normalized). ``offsets_full``: the (n,) per-row
        offsets on the device; ``w0`` / ``prior_means`` / ``prior_precs``:
        (E, p) host arrays (default: zeros, no prior). Returns the
        lane-MAJOR `OptResult` (w (E, p), per-entity scalars (E,),
        histories (E, T + 1)) and the (E, p) variances (None for NONE), on
        the device."""
        ds = self.dataset
        batch = ds.block_batch(block, offsets_full)
        dev = block.y.device
        dim = block.dim if block.dim is not None else ds.dim
        norm = self._norm() if ds.projection is None else None
        obj = make_objective(self.task, self.config, dim,
                             normalization=norm, device=dev)
        l2, l1, cfg = lane_weight_arrays(self.config,
                                         [self.config.reg_weight])
        E = block.n_entities
        if w0 is None:
            w0 = np.zeros((E, dim), np.float32)

        def lanes(a, lo, hi):  # (E, p) host rows → (p, G) device lanes
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32)[lo:hi].T)).to(dev)

        step = lane_chunk(block.m, E)
        results, variances = [], []
        for lo in range(0, E, step):
            hi = min(E, lo + step)
            sub = batch._replace(
                X=batch.X.lanes(lo, hi),
                y=batch.y[:, lo:hi].contiguous(),
                weights=batch.weights[:, lo:hi].contiguous(),
                offsets=batch.offsets[:, lo:hi].contiguous())
            o = obj
            if prior_means is not None:
                o = dataclasses.replace(
                    obj, prior_mean=lanes(prior_means, lo, hi),
                    prior_precision=lanes(prior_precs, lo, hi))
            G = hi - lo
            l2s = l2.to(dev).expand(G).contiguous()
            l1s = None if l1 is None else l1.to(dev).expand(G).contiguous()
            res = _lane_solve(o, sub, lanes(w0, lo, hi), l2s, l1s, cfg)
            var = compute_variances_lanes(o, l2s, res.w, sub, self.variance)
            results.append(_lane_result(res))
            variances.append(None if var is None else var.t())
        res = results[0]
        if len(results) > 1:
            res = OptResult(*(
                [torch.cat([getattr(r, f) for r in results])
                 for f in ("w", "value", "grad_norm", "iterations",
                           "converged", "failed", "loss_history",
                           "grad_norm_history")]
                + [sum(getattr(r, f) for r in results)
                   for f in ("evaluations", "hvps", "trials")]))
        var = (None if variances[0] is None
               else torch.cat(variances) if len(variances) > 1
               else variances[0])
        return res, var

    def solve_block_grid(self, block: REBlock, offsets_lanes, W0, l2s,
                         l1s, config: OptimizerConfig):
        """A regularization grid's solve of one bucket (`game.grid`):
        every (entity × grid point) a lane, entity-major (lane e·G + g),
        in chunks of `lane_chunk` (m, E, G) entities, each chunk one
        lock-step solve whose lanes share their entity's rows
        (`EntityBlocks.grid`). ``offsets_lanes``: the (n, G) per-lane
        offsets; ``W0``: (d, E·G) lane-minor starts; ``l2s`` / ``l1s``:
        the (G,) lane weights (``l1s`` None off OWL-QN); ``config`` the
        weight-normalized one of `lane_weight_arrays`. Returns lane-minor
        (w (d, E·G), variances (d, E·G) or None, converged, failed,
        iterations (E·G,)) on the device."""
        ds = self.dataset
        dev = block.y.device
        obj = make_objective(self.task, self.config, ds.dim, device=dev)
        G = int(l2s.shape[0])
        E, m = block.n_entities, block.m
        X = block.lanes.grid(G)
        rows = block.row_index.t()  # (m, E)
        y, wts = block.y.t(), block.weights.t()
        step = lane_chunk(m, E, G)
        parts = []
        for lo in range(0, E, step):
            hi = min(E, lo + step)

            def per_lane(t):  # (m, e) entity columns -> (m, e·G) lanes
                return t[:, lo:hi, None].expand(m, hi - lo, G).reshape(m, -1)

            sub = GLMBatch(X.lanes(lo, hi), per_lane(y), per_lane(wts),
                           offsets_lanes[rows[:, lo:hi]].reshape(m, -1))
            l2 = l2s.repeat(hi - lo)
            l1 = None if l1s is None else l1s.repeat(hi - lo)
            res = _lane_solve(obj, sub, W0[:, lo * G:hi * G].contiguous(),
                              l2, l1, config)
            var = compute_variances_lanes(obj, l2, res.w, sub, self.variance)
            parts.append((res.w, var, res.converged, res.failed,
                          res.iterations))
        if len(parts) == 1:
            return parts[0]
        w, var, conv, fail, its = zip(*parts)
        return (torch.cat(w, dim=1),
                None if var[0] is None else torch.cat(var, dim=1),
                torch.cat(conv), torch.cat(fail), torch.cat(its))

    def train(self, offsets_full,
              warm_start: Optional[RandomEffectModel] = None,
              prior: Optional[RandomEffectModel] = None
              ) -> tuple[RandomEffectModel, RETrainStats]:
        """Solve every entity with the other coordinates' scores as
        offsets. ``warm_start``: a model whose coefficients start the
        solves. ``prior``: a previous run's model — each entity seen in it
        gets a Gaussian prior from its coefficients and variances, aligned
        by entity KEY (entities new to this dataset get none)."""
        ds = self.dataset
        E, d = ds.n_entities, ds.dim
        norm = self._norm()
        coeffs = np.zeros((E, d), np.float32)
        if (warm_start is not None
                and tuple(warm_start.coefficients.shape) == (E, d)):
            coeffs = warm_start.coefficients.cpu().numpy().astype(
                np.float32).copy()
        if norm is not None:  # the solve runs in normalized space
            coeffs = norm.rows_to_normalized_space(coeffs)
        if prior is not None and ds.projector is not None:
            raise ValueError(
                "per-entity priors cannot be projected through a RANDOM "
                "projection; use INDEX_MAP projection or no projection")
        prior_means = prior_precs = None
        if prior is not None and prior.dim == d:
            prior_means, prior_precs = align_entity_priors(
                prior, ds.entity_keys, d)
            if norm is not None:
                prior_means = norm.rows_to_normalized_space(prior_means)
                if norm.factors is not None:
                    f = np.asarray(norm.factors)
                    prior_precs = prior_precs * (f * f)[None, :]
        variances = (np.zeros((E, d), np.float32)
                     if self.variance is not VarianceComputationType.NONE
                     else None)
        n_conv = n_fail = 0
        iters_per_entity = np.zeros((E,), np.int64)
        if not isinstance(offsets_full, torch.Tensor):
            offsets_full = torch.from_numpy(
                np.asarray(offsets_full, np.float32))
        offsets_dev = offsets_full.to(ds.device, torch.float32)
        for block in ds.blocks:
            ents = block.entity_index
            w0_full = coeffs[ents]
            pm = pp = None
            if block.proj is not None:  # INDEX_MAP
                from photon_tpu_torch.game.projector import gather_rows

                w0 = gather_rows(w0_full, block.proj)
                if prior_means is not None:
                    pm = gather_rows(prior_means[ents], block.proj)
                    pp = gather_rows(prior_precs[ents], block.proj)
            elif ds.projector is not None:  # RANDOM
                w0 = ds.projector.project_coeffs(w0_full)
            else:
                w0 = w0_full
                if prior_means is not None:
                    pm, pp = prior_means[ents], prior_precs[ents]
            res, var = self.solve_block(block, offsets_dev, w0, pm, pp)
            w_out, conv, fail, iters = (t.cpu().numpy() for t in (
                res.w, res.converged, res.failed, res.iterations))
            iters = iters.astype(np.int64)
            var_h = None if var is None else var.cpu().numpy()
            if block.proj is not None:
                from photon_tpu_torch.game.projector import scatter_rows_into

                scatter_rows_into(coeffs, w_out, ents, block.proj)
                if variances is not None:
                    scatter_rows_into(variances, var_h, ents, block.proj)
            elif ds.projector is not None:
                coeffs[ents] = ds.projector.back_project(w_out)
            else:
                coeffs[ents] = w_out
                if variances is not None:
                    variances[ents] = var_h
            n_conv += int(conv.sum())
            n_fail += int(fail.sum())
            iters_per_entity[ents] = iters
        if norm is not None:
            coeffs = norm.rows_to_original_space(coeffs)
            if variances is not None:
                variances = norm.variances_to_original_space(variances)
        model = RandomEffectModel(
            entity_name=ds.entity_name, feature_shard=ds.shard_name,
            task=self.task, coefficients=torch.from_numpy(
                np.ascontiguousarray(coeffs)).to(ds.device),
            entity_keys=ds.entity_keys, key_to_index=ds.key_to_index,
            variances=None if variances is None else torch.from_numpy(
                np.ascontiguousarray(variances)).to(ds.device))
        return model, RETrainStats(E, n_conv, n_fail,
                                   int(iters_per_entity.sum()),
                                   iters_per_entity)

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        """Per-row margin for ALL rows, active and passive: one gather +
        rowwise dot."""
        return model.score(self.dataset.X, self.dataset.entity_dense)
