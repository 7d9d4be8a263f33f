"""GLM training on one device or a mesh (port of `make_objective`,
`solve`, `_permuted_prep`, `_init_w0`, `_mesh_prep`, `train_glm`,
`train_glm_streamed` and the reg-weight grid `lane_weight_arrays` /
`train_glm_grid` / `evaluate_glm_grid` of `photon_tpu/models/training.py`).

Reference parity: com.linkedin.photon.ml.optimization.game.
SingleNodeOptimizationProblem. The solve is the margin-cached L-BFGS
(`optim.lbfgs.minimize_lbfgs_margin`), OWL-QN (`optim.owlqn`, whenever the
config has an L1 term) or the margin-cached TRON
(`optim.tron.minimize_tron_margin`), over dense X, `SparseRows` or a
layout (`BlockedEllRows`, `HybridRows`, `PermutedHybridRows`). The
blocked-ELL X passes, and the permuted hybrid's Xᵀr, go through the
port's CUDA kernels on the card; a
dense OWL-QN solve evaluates f and its gradient through the fused
value+grad kernel (`kernels.fused`), one pass over X per evaluation.

A reg-weight grid runs its G lanes lock-step in lane-minor layout
(`optim.lane_lbfgs`, `lane_owlqn`, `lane_tron`): every X pass is one
shared (·, G) pass through the same kernels.

Informative priors (`optim.prior.PriorDistribution`, diagonal or full
covariance), feature normalization (`data.normalization`, folded into the
objective: the solve runs in normalized space, the model comes back in
original space) and SIMPLE or FULL variances follow the reference's rules.

A host-chunked `data.dataset.ChunkedBatch` (a dataset larger than device
memory) dispatches to `train_glm_streamed`: L-BFGS or OWL-QN over chunks
streamed through the device (`optim.streamed`).

With ``mesh=`` (a `parallel.mesh.Mesh`) the rows shard over the mesh's
slots (`data.dataset.mesh_batch`: dense X, `SparseRows`, or the mesh
form of `shard_blocked_ell_batch`, `shard_hybrid_batch` or
`shard_permuted_batch`), every slot runs the X
passes (the blocked-ELL kernels on its own shard) and each evaluation
closes with one reduction (`parallel.mesh.psum`) — resident, streamed
and grid solves alike. The fused value+grad stays off the mesh path, as
in the reference. The solver state lives on the mesh's home device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch import profiling, telemetry
from photon_tpu_torch.data.dataset import ChunkedBatch, GLMBatch
from photon_tpu_torch.data.matrix import (PERMUTED_LAYOUTS,
                                          SHARDED_LAYOUTS,
                                          SINGLE_DEVICE_LAYOUTS,
                                          EntityBlocks, SparseRows)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.models.variance import (VarianceComputationType,
                                              compute_variances)
from photon_tpu_torch.ops.lane_objective import supports_lanes
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.ops.objective import Objective
from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType
from photon_tpu_torch.optim.lane_lbfgs import minimize_lbfgs_margin_lanes
from photon_tpu_torch.optim.lane_owlqn import minimize_owlqn_lanes
from photon_tpu_torch.optim.lane_tron import minimize_tron_margin_lanes
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin
from photon_tpu_torch.optim.owlqn import minimize_owlqn
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.optim.tron import minimize_tron_margin
from photon_tpu_torch.parallel.mesh import Mesh, SlotRows, check_mesh


def _vec_on(v, device):
    """An optional (d,) side input as an f32 tensor on ``device``."""
    if v is None:
        return None
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def _host_vec(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def make_objective(task: TaskType, config: OptimizerConfig, n_features: int,
                   prior_mean=None, prior_precision=None,
                   intercept_index: Optional[int] = -1, fused: bool = False,
                   normalization=None, prior_full_precision=None,
                   device=None) -> Objective:
    """The smooth objective of one solve, on ``device`` (default ``cuda``).

    intercept_index: the column left out of regularization when
    ``config.regularize_intercept`` is False (default -1: the builders
    append the intercept as the LAST column; None for no intercept).
    fused: evaluate f and g through the fused value+grad kernel where X
    qualifies. normalization: a `NormalizationContext` whose factors and
    shifts the objective folds into its margin (the solve then runs in
    normalized space). Priors of shape (d, G) are per-lane (a random
    effect's entities)."""
    dev = resolve_device(device)
    reg_mask = None
    if not config.regularize_intercept and intercept_index is not None:
        reg_mask = torch.ones(n_features, dtype=torch.float32, device=dev)
        reg_mask[intercept_index] = 0.0
    norm_factors = norm_shifts = None
    if normalization is not None and not normalization.is_identity:
        norm_factors = _vec_on(normalization.factors, dev)
        norm_shifts = _vec_on(normalization.shifts, dev)
    return Objective(
        task=task,
        # the f32 value of the weight, as the reference's np.float32 canon
        l2=float(np.float32(config.reg.l2_weight(config.reg_weight))),
        fused=fused, reg_mask=reg_mask, prior_mean=_vec_on(prior_mean, dev),
        prior_precision=_vec_on(prior_precision, dev),
        prior_full_precision=_vec_on(prior_full_precision, dev),
        norm_factors=norm_factors, norm_shifts=norm_shifts)


def _l1_lam(config: OptimizerConfig):
    """The L1 weight of an OWL-QN solve (None on the smooth routes)."""
    if config.effective_optimizer() is OptimizerType.OWLQN:
        return config.reg.l1_weight(config.reg_weight)
    return None


def solve(obj: Objective, batch: GLMBatch, w0: torch.Tensor,
          config: OptimizerConfig,
          l1_weight: Optional[float] = None) -> OptResult:
    """Run the configured solver on one batch: OWL-QN when the config has
    an L1 term (one f/g evaluation per line-search trial), the
    margin-cached TRON, or the margin-cached L-BFGS (two X passes per
    iteration). ``l1_weight`` overrides the config's L1 weight (a grid
    lane's)."""
    opt = config.effective_optimizer()
    if opt is OptimizerType.OWLQN:
        lam = _l1_lam(config) if l1_weight is None else l1_weight
        return minimize_owlqn(
            lambda w: obj.value_and_grad(w, batch), w0, lam,
            max_iters=config.max_iters, tolerance=config.tolerance,
            history=config.history, reg_mask=obj.reg_mask)
    if opt is OptimizerType.TRON:
        return minimize_tron_margin(
            obj, batch, w0, max_iters=config.max_iters,
            tolerance=config.tolerance, cg_max_iters=config.cg_max_iters)
    return minimize_lbfgs_margin(
        obj, batch, w0, max_iters=config.max_iters,
        tolerance=config.tolerance, history=config.history)


def _permuted_prep(X, w0, prior_mean, prior_precision):
    """Translate original-space side inputs into the permuted feature space
    a `BlockedEllRows` or `PermutedHybridRows` solve runs in ((d,) vectors
    gather through ``perm_cols``)."""
    w0 = X.from_model_space(w0)
    if prior_mean is not None:
        prior_mean = X.from_model_space(prior_mean)
    if prior_precision is not None:
        prior_precision = X.from_model_space(prior_precision)
    return w0, prior_mean, prior_precision


def _permuted_norm(X, norm):
    """The normalization context the objective of a permuted solve uses:
    factors and shifts gathered into the permuted space on the host
    (elementwise transforms commute with the permutation, so the
    original-space context converts the result after `to_model_space`)."""
    if norm is None:
        return None
    perm = _host_vec(X.perm_cols)
    return dataclasses.replace(
        norm,
        factors=None if norm.factors is None else norm.factors[perm],
        shifts=None if norm.shifts is None else norm.shifts[perm])


def _active_norm(normalization):
    """The NormalizationContext if it does anything, else None."""
    if normalization is not None and not normalization.is_identity:
        return normalization
    return None


def _init_w0(d: int, w0, device, norm=None) -> torch.Tensor:
    if w0 is None:
        return torch.zeros(d, dtype=torch.float32, device=device)
    if np.ndim(w0) == 2:
        raise ValueError("per-lane (G, d) w0 is a grid-path feature; single "
                         "solves take a (d,) start")
    if norm is not None:
        w0 = norm.to_normalized_space(_host_vec(w0))
    return _vec_on(w0, device)


def _prior_into(norm, prior_mean, prior_precision):
    """Original-space diagonal prior → the normalized solve's space: μ to
    normalized coordinates, τ_j·f_j² (the intercept/shift coupling
    dropped, the same diagonal approximation as the variances)."""
    if norm is None:
        return prior_mean, prior_precision
    if prior_mean is not None:
        prior_mean = norm.to_normalized_space(_host_vec(prior_mean))
    if prior_precision is not None:
        f = norm.factors if norm.factors is not None else 1.0
        prior_precision = np.asarray(_host_vec(prior_precision),
                                     np.float32) * f * f
    return prior_mean, prior_precision


def _prep(batch: GLMBatch, mesh, device) -> tuple:
    """(batch on its device or row-sharded over the mesh, the solve's
    device): the mesh's home device holds the replicated solver state."""
    check_mesh(mesh)
    if mesh is None:
        if isinstance(batch.X, SlotRows):
            raise ValueError("a row-sharded batch solves on its mesh: pass "
                             "mesh=")
        if isinstance(batch.X, SHARDED_LAYOUTS):
            raise ValueError(
                f"{type(batch.X).__name__} is laid for a mesh's slots: "
                "pass mesh= (or build the one-device layout)")
        dev = resolve_device(device)
        return batch.to(dev), dev
    from photon_tpu_torch.data.dataset import mesh_batch

    return mesh_batch(batch, mesh), mesh.home


def _is_permuted(X) -> bool:
    """A blocked-ELL or permuted hybrid layout (one device's, or every
    slot's of a mesh): the solve runs in its permuted column space."""
    if isinstance(X, SlotRows):
        X = X.parts[0]
    return isinstance(X, PERMUTED_LAYOUTS)


def _matrix_dim(X) -> int:
    if isinstance(X, (SparseRows, EntityBlocks, SlotRows)
                  + SINGLE_DEVICE_LAYOUTS):
        return X.n_features
    return int(X.shape[1])


def train_glm_streamed(
    data: ChunkedBatch,
    task: TaskType,
    config: OptimizerConfig,
    w0=None,
    prior_mean=None,
    prior_precision=None,
    normalization=None,
    mesh=None,
    device=None,
) -> tuple[GeneralizedLinearModel, OptResult]:
    """The out-of-device-memory solve (reference: `train_glm_streamed`):
    ``data`` is a host `ChunkedBatch` and every evaluation sums over
    chunks streamed onto ``device`` (default ``cuda``) — the objective,
    stop rules and returned shapes of `train_glm`, which dispatches here
    for a ChunkedBatch. L-BFGS, or OWL-QN when the config has an L1 term;
    TRON is refused (each CG step would stream the whole dataset). A
    blocked-ELL chunk ladder (`chunk_blocked_ell`) solves in its global
    permuted space: ``w0``, the diagonal prior and the normalization
    translate in, the coefficients back out. ``w0`` and the priors are
    original-space; with a `NormalizationContext` the solve runs in
    normalized space and the model comes back in original space. With
    ``mesh`` every chunk streams row-sharded over the slots (a
    blocked-ELL ladder laid for the mesh: `chunk_blocked_ell(n_shards=
    S)`) and each evaluation closes with one reduction; the solve state
    lives on the mesh's home device."""
    from photon_tpu_torch.optim.streamed import (minimize_lbfgs_streamed,
                                                 minimize_owlqn_streamed)

    if config.effective_optimizer() is OptimizerType.TRON:
        raise ValueError(
            "TRON is not available in streamed mode (each CG step would "
            "stream the full dataset once — cg_max_iters streams per "
            "iteration vs L-BFGS's two); use LBFGS or OWLQN for "
            "out-of-HBM solves")
    check_mesh(mesh)
    dev = resolve_device(device) if mesh is None else mesh.home
    d = data.X.n_features
    norm = _active_norm(normalization)
    w0 = _init_w0(d, w0, dev, norm)
    prior_mean, prior_precision = _prior_into(norm, prior_mean,
                                              prior_precision)
    prior_mean = _vec_on(prior_mean, dev)
    prior_precision = _vec_on(prior_precision, dev)
    # a chunk ladder carries ONE global column permutation for the whole
    # stream: translate the original-space side inputs in, the solution
    # back out, as for a resident BlockedEllRows
    permuted = data.X.permuted
    norm_obj, intercept_index = norm, -1
    if permuted:
        perm = data.X.perm_cols.to(dev).long()
        w0 = w0[perm]
        if prior_mean is not None:
            prior_mean = prior_mean[perm]
        if prior_precision is not None:
            prior_precision = prior_precision[perm]
        if norm is not None:
            perm_h = data.X.perm_cols.numpy()
            norm_obj = dataclasses.replace(
                norm,
                factors=None if norm.factors is None else norm.factors[perm_h],
                shifts=None if norm.shifts is None else norm.shifts[perm_h])
        intercept_index = data.X.last_col_pos
    obj = make_objective(task, config, d, prior_mean=prior_mean,
                         prior_precision=prior_precision,
                         normalization=norm_obj,
                         intercept_index=intercept_index, device=dev)
    if config.effective_optimizer() is OptimizerType.OWLQN:
        res = minimize_owlqn_streamed(
            obj, data, w0, config.reg.l1_weight(config.reg_weight),
            max_iters=config.max_iters, tolerance=config.tolerance,
            history=config.history, reg_mask=obj.reg_mask, mesh=mesh,
            kernels=config.kernels)
    else:
        res = minimize_lbfgs_streamed(
            obj, data, w0, max_iters=config.max_iters,
            tolerance=config.tolerance, history=config.history, mesh=mesh,
            kernels=config.kernels)
    if permuted:  # back to original column order before the unfold
        res = res._replace(w=res.w[data.X.inv_perm.to(dev).long()])
    w_out = res.w
    if norm is not None:
        w_out = _vec_on(norm.to_original_space(_host_vec(res.w)), dev)
    return GeneralizedLinearModel(Coefficients(w_out, None), task), res


def train_glm(
    batch: GLMBatch,
    task: TaskType,
    config: OptimizerConfig,
    w0=None,
    variance: VarianceComputationType = VarianceComputationType.NONE,
    prior_mean=None,
    prior_precision=None,
    prior=None,
    normalization=None,
    mesh=None,
    device=None,
) -> tuple[GeneralizedLinearModel, OptResult]:
    """Full-batch GLM training (reference: train_glm). The batch moves to
    ``device`` (default ``cuda``) first — or, with ``mesh``, row-shards
    over its slots (`data.dataset.mesh_batch`; a layout in the mesh form
    of `shard_blocked_ell_batch`, `shard_hybrid_batch` or
    `shard_permuted_batch`; a one-device layout raises), each evaluation
    closing with one reduction over the mesh, the model coming back on the
    mesh's home device.

    A `BlockedEllRows` or `PermutedHybridRows` batch solves in its
    permuted space; ``w0`` and the
    priors are taken, and the model's coefficients and variances returned,
    in ORIGINAL column order. With a `NormalizationContext` the solve runs
    in normalized space (the objective folds the factors and shifts in; X
    is untouched) and the model comes back in original space; ``w0`` and
    the priors are original-space too. ``prior``: an
    `optim.prior.PriorDistribution`, the only way to pass a
    full-covariance precision (refused with normalization or a permuted
    layout, as the reference). ``config.kernels`` scopes
    the kernel mode of the whole solve.

    A `ChunkedBatch` (host-resident chunks) dispatches to the streamed
    solve, `train_glm_streamed`: no variances and no full-covariance
    prior there, as the reference."""
    if isinstance(batch, ChunkedBatch):
        if variance is not VarianceComputationType.NONE:
            raise ValueError(
                "coefficient variances are not available in streamed mode "
                "(the Hessian-diagonal pass is not chunk-accumulated yet); "
                "use variance_type=none")
        if prior is not None:
            if prior_mean is not None or prior_precision is not None:
                raise ValueError("pass prior OR prior_mean/prior_precision")
            if prior.precision_full is not None:
                raise ValueError(
                    "full-covariance priors are not supported in streamed "
                    "mode; use a diagonal prior")
            prior_mean, prior_precision = prior.mean, prior.precision_diag
        return train_glm_streamed(
            batch, task, config, w0=w0, prior_mean=prior_mean,
            prior_precision=prior_precision, normalization=normalization,
            mesh=mesh, device=device)
    if config.kernels is not None:
        with K.scope(config.kernels):
            return train_glm(
                batch, task, dataclasses.replace(config, kernels=None),
                w0=w0, variance=variance, prior_mean=prior_mean,
                prior_precision=prior_precision, prior=prior,
                normalization=normalization, mesh=mesh, device=device)
    batch, dev = _prep(batch, mesh, device)
    X = batch.X
    d = _matrix_dim(X)
    norm = _active_norm(normalization)
    permuted = _is_permuted(X)
    prior_full = None
    if prior is not None:
        if prior_mean is not None or prior_precision is not None:
            raise ValueError("pass prior OR prior_mean/prior_precision")
        prior_mean = prior.mean
        prior_precision = prior.precision_diag
        prior_full = prior.precision_full
        if prior_full is not None and norm is not None:
            raise ValueError(
                "full-covariance priors are not supported together with "
                "normalization (no exact diagonal-space transform exists); "
                "pre-transform the precision or use a diagonal prior")
    w0 = _init_w0(d, w0, dev, norm)
    prior_mean, prior_precision = _prior_into(norm, prior_mean,
                                              prior_precision)
    prior_mean = _vec_on(prior_mean, dev)
    prior_precision = _vec_on(prior_precision, dev)
    intercept_index = -1
    norm_obj = norm
    # Dense OWL-QN evaluates f and g through the fused kernel (one X pass
    # per evaluation); L-BFGS and TRON are margin-cached and never call
    # value_and_grad, and a layout keeps the unfused route (`can_fuse`
    # takes dense X alone; a layout's X passes are its own), as the
    # reference; so does a mesh solve (its evaluation closes with the mesh
    # reduction).
    use_fused = (config.effective_optimizer() is OptimizerType.OWLQN
                 and not permuted and mesh is None)
    if permuted:
        if prior_full is not None:
            layout = X.parts[0] if isinstance(X, SlotRows) else X
            raise ValueError(
                "full-covariance priors are not supported with "
                f"{type(layout).__name__} (a (d, d) precision at that scale "
                "is impractical; use a diagonal prior)")
        w0, prior_mean, prior_precision = _permuted_prep(
            X, w0, prior_mean, prior_precision)
        norm_obj = _permuted_norm(X, norm)
        intercept_index = X.last_col_pos
    obj = make_objective(task, config, d, prior_mean=prior_mean,
                         prior_precision=prior_precision,
                         intercept_index=intercept_index, fused=use_fused,
                         normalization=norm_obj,
                         prior_full_precision=prior_full, device=dev)
    program = ("training._train_run_sharded" if mesh is not None
               else "training._train_run")
    run_args = (batch, w0, obj, _l1_lam(config))
    telemetry.record_signature(program, run_args)
    # an armed ledger's dispatch: the solve's host wall (it reads back once
    # an iteration, not at its end)
    with profiling.dispatch(program, run_args):
        res = solve(obj, batch, w0, config)
    var = compute_variances(obj, res.w, batch, variance)
    if permuted:
        res = res._replace(w=X.to_model_space(res.w))
        if var is not None:
            var = X.to_model_space(var)
    w_out = res.w
    if norm is not None:
        w_out = _vec_on(norm.to_original_space(_host_vec(res.w)), dev)
        if var is not None:
            var = _vec_on(norm.variances_to_original_space(_host_vec(var)),
                          dev)
    return GeneralizedLinearModel(Coefficients(w_out, var), task), res


# ------------------------------------------------------------ the lane grid
_log = logging.getLogger("photon_tpu_torch.models")


def _history_storage(name):
    """The torch dtype a ``lane_history_dtype`` names (None: the solver's
    f32)."""
    if name is None:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError("lane_history_dtype must name a torch floating "
                         f"dtype such as 'bfloat16', got {name!r}")
    return dt


def _lane_result(res: OptResult) -> OptResult:
    """A lane-minor result (w (d, G), histories (T + 1, G)) in the public
    lane-MAJOR convention: w (G, d), histories (G, T + 1)."""
    return res._replace(w=res.w.t(), loss_history=res.loss_history.t(),
                        grad_norm_history=res.grad_norm_history.t())


def _lane_solve(obj, batch, W0, l2s, l1s, config) -> OptResult:
    """The one place a lane-minor solve is dispatched: L1/elastic-net
    sweeps (``l1s`` given) on the OWL-QN lanes, whose trials each pay one
    shared margin pass; smooth sweeps on the margin-cached TRON or L-BFGS
    lanes. ``W0``: (d, G) lane-minor starts, G contiguous."""
    hdt = _history_storage(config.lane_history_dtype)
    if l1s is not None:
        return minimize_owlqn_lanes(
            obj, l2s, l1s, batch, W0, max_iters=config.max_iters,
            tolerance=config.tolerance, history=config.history,
            reg_mask=obj.reg_mask, history_dtype=hdt)
    if config.optimizer is OptimizerType.TRON:
        return minimize_tron_margin_lanes(
            obj, l2s, batch, W0, max_iters=config.max_iters,
            tolerance=config.tolerance, cg_max_iters=config.cg_max_iters)
    return minimize_lbfgs_margin_lanes(
        obj, l2s, batch, W0, max_iters=config.max_iters,
        tolerance=config.tolerance, history=config.history,
        history_dtype=hdt)


def _train_run_grid(batch, W0, obj, l2s, l1s, config, variance):
    """The general grid runner (variances, priors): the single-lane solve
    and its variances once per lane, in turn, at that lane's weights
    (the reference vmaps the same solver over the lanes). Returns a
    lane-minor OptResult and (d, G) variances (None for NONE)."""
    res, var = [], []
    for i in range(W0.shape[1]):
        o = dataclasses.replace(obj, l2=float(l2s[i]))
        r = solve(o, batch, W0[:, i].contiguous(), config,
                  l1_weight=None if l1s is None else float(l1s[i]))
        res.append(r)
        var.append(compute_variances(o, r.w, batch, variance))
    dev = W0.device
    out = OptResult(
        w=torch.stack([r.w for r in res], dim=1),
        value=torch.stack([r.value for r in res]),
        grad_norm=torch.stack([r.grad_norm for r in res]),
        iterations=torch.tensor([r.iterations for r in res],
                                dtype=torch.int32, device=dev),
        converged=torch.stack([r.converged for r in res]),
        failed=torch.stack([r.failed for r in res]),
        loss_history=torch.stack([r.loss_history for r in res], dim=1),
        grad_norm_history=torch.stack([r.grad_norm_history for r in res],
                                      dim=1),
        evaluations=sum(r.evaluations for r in res),
        hvps=sum(r.hvps for r in res))
    return out, (None if var[0] is None else torch.stack(var, dim=1))


def lane_weight_arrays(config: OptimizerConfig, reg_weights):
    """(l2s, l1s, static_config) for a grid's per-lane weights, the one
    place the lane routing lives: any L1 weight in the sweep runs every
    lane on OWL-QN (the reference's forced-OWLQN-on-L1 rule, per sweep),
    and the static config is weight-normalized (``reg_weight`` 0, the
    optimizer pinned). ``l2s``/``l1s`` are (G,) f32 CPU tensors; ``l1s``
    is None on the smooth routes."""
    weights = [float(wt) for wt in reg_weights]
    l2s = torch.tensor([config.reg.l2_weight(wt) for wt in weights],
                       dtype=torch.float32)
    use_owlqn = (config.effective_optimizer() is OptimizerType.OWLQN
                 or any(config.reg.l1_weight(wt) > 0.0 for wt in weights))
    l1s = None
    if use_owlqn:
        l1s = torch.tensor([config.reg.l1_weight(wt) for wt in weights],
                           dtype=torch.float32)
    static_cfg = dataclasses.replace(
        config, reg_weight=0.0,
        optimizer=(OptimizerType.OWLQN if use_owlqn
                   else config.effective_optimizer()))
    return l2s, l1s, static_cfg


def _grid_w0(d: int, G: int, w0, device) -> torch.Tensor:
    """The (d, G) lane-minor f32 start, G contiguous: zeros, a shared (d,)
    start in every lane, or a lane-major (G, d) per-lane start."""
    if w0 is None:
        return torch.zeros((d, G), dtype=torch.float32, device=device)
    if np.ndim(w0) == 2:
        if tuple(np.shape(w0)) != (G, d):
            raise ValueError(f"per-lane w0 must be (G={G}, d={d}), got "
                             f"{tuple(np.shape(w0))}")
        return _vec_on(w0, device).t().contiguous()
    return _vec_on(w0, device)[:, None].expand(d, G).contiguous()


def _to_host(tensors: list) -> list:
    """The tensors on the CPU, from ONE device-to-host copy (packed as f32:
    bools and counts below 2^24 round-trip exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def train_glm_grid(
    batch: GLMBatch,
    task: TaskType,
    config: OptimizerConfig,
    reg_weights,
    mesh=None,
    w0=None,
    variance: VarianceComputationType = VarianceComputationType.NONE,
    normalization=None,
    device_results: bool = False,
    prior_mean=None,
    prior_precision=None,
    prior=None,
    device=None,
):
    """Train one GLM per regularization weight, the G lanes lock-step on
    one device (default ``cuda``) or, with ``mesh``, row-sharded over its
    slots with one reduction per evaluation for all lanes (reference:
    train_glm_grid; the reference's grid mode runs one Spark job per
    weight).

    Every lane starts from ``w0``: None (zeros), a shared (d,) start, or
    a lane-major (G, d) per-lane start, in ORIGINAL column order. A
    permuted layout solves in its permuted space (the (d, G) start
    gathers in through ``from_model_space``, the result out through
    ``to_model_space``). Sweeps without variances or priors run the
    lane-minor solvers (L-BFGS, TRON, or OWL-QN for any L1 weight, as
    `lane_weight_arrays` routes them), every X pass shared by the lanes;
    variances and a (shared, diagonal) prior run the general runner, one
    single-lane solve per lane, and say so at INFO. A
    `NormalizationContext` folds into every lane's objective; ``w0`` and
    the prior are original-space, and the returned models too (the
    ``device_results`` form stays in the solve's normalized space, as the
    reference's).

    Returns ``[(GeneralizedLinearModel, OptResult)]`` in ``reg_weights``
    order, on the CPU from one host transfer for the whole sweep; with
    ``device_results=True``, the lane-major ``(OptResult, variances)``
    still on the device (w (G, d), per-lane scalars (G,), histories (G,
    T + 1), variances (G, d) or None). ``config.kernels`` scopes the kernel
    mode of the whole sweep."""
    if isinstance(batch, ChunkedBatch):
        raise ValueError(
            "streamed mode has no lane-minor grid (every lane would "
            "multiply the per-pass host→device stream); run the sweep "
            "sequentially — each point is a train_glm(ChunkedBatch) solve")
    if config.kernels is not None:
        with K.scope(config.kernels):
            return train_glm_grid(
                batch, task, dataclasses.replace(config, kernels=None),
                reg_weights, mesh=mesh, w0=w0, variance=variance,
                normalization=normalization, device_results=device_results,
                prior_mean=prior_mean, prior_precision=prior_precision,
                prior=prior, device=device)
    batch, dev = _prep(batch, mesh, device)
    X = batch.X
    d = _matrix_dim(X)
    norm = _active_norm(normalization)
    weights = [float(wt) for wt in reg_weights]
    if np.ndim(w0) == 2 and norm is not None:
        raise ValueError(
            "per-lane w0 with normalization is not supported; pass "
            "normalized-space starts and normalization=None")
    if prior is not None:
        if prior_mean is not None or prior_precision is not None:
            raise ValueError("pass prior OR prior_mean/prior_precision")
        if prior.precision_full is not None:
            raise ValueError(
                "full-covariance priors are not supported on the grid "
                "path; use a diagonal prior (from_variances) or run the "
                "sweep sequentially via train_glm")
        prior_mean, prior_precision = prior.mean, prior.precision_diag
    if norm is not None and w0 is not None:
        w0 = norm.to_normalized_space(_host_vec(w0))
    W0 = _grid_w0(d, len(weights), w0, dev)
    prior_mean, prior_precision = _prior_into(norm, prior_mean,
                                              prior_precision)
    prior_mean = _vec_on(prior_mean, dev)
    prior_precision = _vec_on(prior_precision, dev)
    permuted = _is_permuted(X)
    intercept_index = -1
    norm_obj = norm
    if permuted:
        W0, prior_mean, prior_precision = _permuted_prep(
            X, W0, prior_mean, prior_precision)
        norm_obj = _permuted_norm(X, norm)
        intercept_index = X.last_col_pos
    obj = make_objective(task, config, d, prior_mean=prior_mean,
                         prior_precision=prior_precision,
                         intercept_index=intercept_index,
                         normalization=norm_obj, device=dev)
    l2s, l1s, static_cfg = lane_weight_arrays(config, weights)
    l2s = l2s.to(dev)
    l1s = None if l1s is None else l1s.to(dev)
    grid_args = (batch, W0, obj, l2s, l1s)
    telemetry.record_signature("training._train_run_grid", grid_args)
    with profiling.dispatch("training._train_run_grid", grid_args):
        if (variance is VarianceComputationType.NONE
                and supports_lanes(obj)):
            res, var = _lane_solve(obj, batch, W0, l2s, l1s,
                                   static_cfg), None
        else:
            _log.info(
                "train_glm_grid: %s requested — the lane-minor lock-step "
                "grid does not take it; routing the %d-lane sweep to the "
                "general runner (one single-lane solve per lane, in turn).",
                "an informative prior" if not supports_lanes(obj)
                else f"{variance.value.upper()} variances", len(weights))
            res, var = _train_run_grid(batch, W0, obj, l2s, l1s,
                                       static_cfg, variance)
    if permuted:  # back to original column order: one (d, G) gather
        res = res._replace(w=X.to_model_space(res.w))
        if var is not None:
            var = X.to_model_space(var)
    res = _lane_result(res)
    var = None if var is None else var.t()
    if device_results:
        return res, var
    fields = [res.w, res.value, res.grad_norm, res.iterations,
              res.converged, res.failed, res.loss_history,
              res.grad_norm_history] + ([] if var is None else [var])
    host = _to_host(fields)
    W, value, gnorm, its, conv, failed, hist, ghist = host[:8]
    V = host[8] if var is not None else None
    if norm is not None:  # back to original space, as train_glm
        W = torch.from_numpy(norm.rows_to_original_space(W.numpy()))
        if V is not None:
            V = torch.from_numpy(norm.variances_to_original_space(V.numpy()))
    out = []
    for i in range(len(weights)):
        lane = OptResult(
            w=W[i], value=value[i], grad_norm=gnorm[i],
            iterations=int(its[i]), converged=conv[i], failed=failed[i],
            loss_history=hist[i], grad_norm_history=ghist[i],
            evaluations=res.evaluations, hvps=res.hvps, trials=res.trials)
        model = GeneralizedLinearModel(
            Coefficients(W[i], None if V is None else V[i]), task)
        out.append((model, lane))
    return out


def evaluate_glm_grid(grid, batch: GLMBatch, evaluator=None):
    """Validation model selection over a `train_glm_grid` result
    (reference: `evaluate_glm_grid`, GameEstimator's pick by
    ``Evaluator.better_than``). Scoring, the one pass over X, is one lane
    pass for every lane (`models.glm.score_models`) on the batch's
    device; each lane's metric then runs there. Returns ``(best_index,
    [score per lane])``."""
    from photon_tpu_torch.evaluation.evaluator import default_evaluator
    from photon_tpu_torch.models.glm import score_models

    task = grid[0][0].task
    evaluator = evaluator if evaluator is not None else default_evaluator(task)
    margins = score_models([m for m, _ in grid], batch.X, batch.offsets)
    scores = [evaluator.evaluate(margins[i], batch.y, batch.weights)
              for i in range(len(grid))]
    best = 0
    for i in range(1, len(scores)):
        if evaluator.better_than(scores[i], scores[best]):
            best = i
    return best, scores


# ----------------------------------------------------------------- contracts
# The resident and lane solvers make no collective and no combining
# scatter; the Python-loop solvers' host syncs are pinned as budgets that
# can only fall (ROADMAP speed item 1: a device-resident solve loop). On
# a mesh every evaluation closes with ONE psum: the sharded layouts'
# tails never cross slots.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import (  # noqa: E402
    SCATTER_ADD_PRIMITIVES, SCATTER_PRIMITIVES)


def _contract_cfg(**kw) -> OptimizerConfig:
    from photon_tpu_torch.optim.regularization import l2

    kw.setdefault("max_iters", 6)
    kw.setdefault("tolerance", 1e-7)
    kw.setdefault("reg", l2())
    kw.setdefault("history", 4)
    return OptimizerConfig(**kw)


def _contract_dense_batch(device, n=64, d=8) -> GLMBatch:
    from photon_tpu_torch.data.dataset import make_batch

    rng = np.random.default_rng(0)
    return make_batch(rng.normal(size=(n, d)).astype(np.float32),
                      (rng.uniform(size=n) < 0.5).astype(np.float32),
                      device=device)


def _contract_resident_problem(device, n=48, d=7, seed=2):
    """(cfg, obj, batch, w0) of the resident solver contracts: a 5-
    iteration L2 logistic solve on seeded dense rows."""
    from photon_tpu_torch.data.dataset import make_batch

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    cfg = _contract_cfg(max_iters=5, reg_weight=0.3)
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, d,
                         device=device)
    return (cfg, obj, make_batch(X, y, device=device),
            torch.zeros(d, device=device))


def _contract_sparse_batch(n, d, k=4) -> GLMBatch:
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.data.matrix import SparseRows

    rng = np.random.default_rng(0)
    ind = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return make_batch(SparseRows(ind, val, d), y, device="cpu")


@register_contract(
    name="resident_lbfgs_solve",
    description="the margin-cached L-BFGS solve (6 iterations): single "
                "device, zero communication, its host syncs held to the "
                "pinned per-iteration read-backs",
    collectives={}, max_syncs={"cuda": 24, "cpu": 7}, tags=("resident",))
def _contract_resident_lbfgs_solve(device):
    # 6 iterations: on the card 1 sync at the start (optim/lbfgs.py:203),
    # 1 read-back an iteration (:250) and 17 scalar uploads of the Wolfe
    # search (optim/linesearch.py:57); the CPU counts the 7 read-backs
    # (ROADMAP speed item 1)
    batch = _contract_dense_batch(device)
    cfg = _contract_cfg(reg_weight=0.5)
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, 8,
                         device=device)
    return ((lambda b, w, o: solve(o, b, w, cfg)),
            (batch, torch.zeros(8, device=device), obj))


@register_contract(
    name="resident_grid_lanes",
    description="the lane-minor reg-weight grid (L-BFGS lanes, G=2): G "
                "lock-step lanes, zero communication, the lane search's "
                "host syncs held to the pinned budget",
    collectives={}, max_syncs={"cuda": 12, "cpu": 12},
    tags=("resident", "lane"))
def _contract_resident_grid_lanes(device):
    # 6 iterations x 2 one-flag read-backs: the loop's done flag
    # (optim/lane_lbfgs.py:253) and the lane search's per-trial flag
    # (:117) (ROADMAP speed item 1)
    batch = _contract_dense_batch(device)
    cfg = _contract_cfg(reg_weight=0.0)
    l2s, l1s, static_cfg = lane_weight_arrays(cfg, [0.1, 1.0])
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, 8,
                         device=device)
    return ((lambda b, W, o, l2v: _lane_solve(o, b, W, l2v, None,
                                              static_cfg)),
            (batch, torch.zeros(8, 2, device=device), obj,
             l2s.to(device)))


def _contract_sharded(kind: str, device, d: int = 96, bf16: bool = False):
    """(mesh, batch, obj) for a sharded layout on an 8-slot mesh."""
    from photon_tpu_torch.data.dataset import (cast_features, mesh_batch,
                                               shard_blocked_ell_batch,
                                               shard_hybrid_batch,
                                               shard_permuted_batch)
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=8, device=device)
    shard = {"hybrid": shard_hybrid_batch,
             "permuted": shard_permuted_batch,
             "blocked_ell": shard_blocked_ell_batch}[kind]
    host = shard(_contract_sparse_batch(16 * mesh.n_slots, d),
                 mesh.n_slots, d_dense=16)
    if bf16:
        host = cast_features(host)
    batch = mesh_batch(host, mesh)
    cfg = _contract_cfg(reg_weight=0.5)
    pos = getattr(batch.X, "last_col_pos", None) if kind != "hybrid" \
        else -1
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, d,
                         intercept_index=pos, device=mesh.home)
    return mesh, batch, obj


def _contract_sharded_vg(kind: str, device, bf16: bool = False):
    mesh, batch, obj = _contract_sharded(kind, device, bf16=bf16)
    d = obj.reg_mask.shape[0] if obj.reg_mask is not None else 96
    w = torch.from_numpy(0.1 * np.random.default_rng(2).normal(
        size=d).astype(np.float32)).to(mesh.home)
    return (lambda o, b, wv: o.value_and_grad(wv, b)), (obj, batch, w)


@register_contract(
    name="sharded_hybrid_value_and_grad",
    description="ShardedHybridRows evaluation on an 8-slot mesh: ONE "
                "psum, and the per-shard tail never crosses slots",
    collectives={"psum": 1}, tags=("resident", "mesh"))
def _contract_sharded_hybrid_value_and_grad(device):
    return _contract_sharded_vg("hybrid", device)


@register_contract(
    name="sharded_permuted_value_and_grad",
    description="ShardedPermutedHybridRows evaluation on an 8-slot mesh: "
                "ONE psum and no combining scatter — the scatter-free "
                "layout holds on the mesh path",
    collectives={"psum": 1}, forbid=SCATTER_PRIMITIVES,
    tags=("resident", "mesh"))
def _contract_sharded_permuted_value_and_grad(device):
    return _contract_sharded_vg("permuted", device)


@register_contract(
    name="sharded_permuted_grid_lanes",
    description="one iteration of the sharded lane-grid L-BFGS "
                "(ShardedPermutedHybridRows, G=2): no combining scatter "
                "and exactly 3 psums — the start's value+grad, the "
                "accepted first trial's phi, the accepted step's grad",
    collectives={"psum": 3}, forbid=SCATTER_ADD_PRIMITIVES,
    max_syncs={"cuda": 2, "cpu": 2}, tags=("resident", "mesh", "lane"))
def _contract_sharded_permuted_grid_lanes(device):
    # 1 iteration: the loop's and the search's one-flag read-backs
    # (optim/lane_lbfgs.py:253, :117; ROADMAP speed item 1)
    mesh, batch, obj = _contract_sharded("permuted", device)
    cfg = _contract_cfg(reg_weight=0.0, max_iters=1)
    l2s, _, static_cfg = lane_weight_arrays(cfg, [0.1, 1.0])
    obj = dataclasses.replace(obj, l2=0.0)
    return ((lambda b, W, o, l2v: _lane_solve(o, b, W, l2v, None,
                                              static_cfg)),
            (batch, torch.zeros(96, 2, device=mesh.home), obj,
             l2s.to(mesh.home)))


@register_contract(
    name="sharded_blocked_ell_value_and_grad",
    description="ShardedBlockedEllRows evaluation (bf16 storage) on an "
                "8-slot mesh: ONE psum, no combining scatter, every bf16 "
                "product accumulating f32",
    collectives={"psum": 1}, forbid=SCATTER_PRIMITIVES,
    require_f32_accum=True, tags=("resident", "mesh", "sparse"))
def _contract_sharded_blocked_ell_value_and_grad(device):
    return _contract_sharded_vg("blocked_ell", device, bf16=True)
