"""Single-device GLM training (port of `make_objective`, `solve`,
`_permuted_prep`, `_init_w0` and the one-device `train_glm` of
`photon_tpu/models/training.py`).

Reference parity: com.linkedin.photon.ml.optimization.game.
SingleNodeOptimizationProblem. The solve is the margin-cached L-BFGS
(`optim.lbfgs.minimize_lbfgs_margin`), OWL-QN (`optim.owlqn`, whenever the
config has an L1 term) or the margin-cached TRON
(`optim.tron.minimize_tron_margin`), over dense X or `BlockedEllRows`. The
blocked-ELL X passes go through the port's CUDA kernels on the card; a
dense OWL-QN solve evaluates f and its gradient through the fused
value+grad kernel (`kernels.fused`), one pass over X per evaluation.

Still to come, and raising when asked for: feature normalization and
full-covariance priors (ROADMAP queue A item 3), FULL variances (item 5),
meshes (item 13), reg-weight grids (item 7) and streamed datasets
(item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.data.matrix import BlockedEllRows, SparseRows
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.models.variance import (VarianceComputationType,
                                              compute_variances)
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.ops.objective import Objective
from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin
from photon_tpu_torch.optim.owlqn import minimize_owlqn
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.optim.tron import minimize_tron_margin


def _vec_on(v, device):
    """An optional (d,) side input as an f32 tensor on ``device``."""
    if v is None:
        return None
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def make_objective(task: TaskType, config: OptimizerConfig, n_features: int,
                   prior_mean=None, prior_precision=None,
                   intercept_index: Optional[int] = -1, fused: bool = False,
                   device=None) -> Objective:
    """The smooth objective of one solve, on ``device`` (default ``cuda``).

    intercept_index: the column left out of regularization when
    ``config.regularize_intercept`` is False (default -1: the builders
    append the intercept as the LAST column; None for no intercept).
    fused: evaluate f and g through the fused value+grad kernel where X
    qualifies."""
    dev = resolve_device(device)
    reg_mask = None
    if not config.regularize_intercept and intercept_index is not None:
        reg_mask = torch.ones(n_features, dtype=torch.float32, device=dev)
        reg_mask[intercept_index] = 0.0

    return Objective(
        task=task,
        # the f32 value of the weight, as the reference's np.float32 canon
        l2=float(np.float32(config.reg.l2_weight(config.reg_weight))),
        fused=fused, reg_mask=reg_mask, prior_mean=_vec_on(prior_mean, dev),
        prior_precision=_vec_on(prior_precision, dev))


def _l1_lam(config: OptimizerConfig):
    """The L1 weight of an OWL-QN solve (None on the smooth routes)."""
    if config.effective_optimizer() is OptimizerType.OWLQN:
        return config.reg.l1_weight(config.reg_weight)
    return None


def solve(obj: Objective, batch: GLMBatch, w0: torch.Tensor,
          config: OptimizerConfig) -> OptResult:
    """Run the configured solver on one batch: OWL-QN when the config has
    an L1 term (one f/g evaluation per line-search trial), the
    margin-cached TRON, or the margin-cached L-BFGS (two X passes per
    iteration)."""
    opt = config.effective_optimizer()
    if opt is OptimizerType.OWLQN:
        return minimize_owlqn(
            lambda w: obj.value_and_grad(w, batch), w0, _l1_lam(config),
            max_iters=config.max_iters, tolerance=config.tolerance,
            history=config.history, reg_mask=obj.reg_mask)
    if opt is OptimizerType.TRON:
        return minimize_tron_margin(
            obj, batch, w0, max_iters=config.max_iters,
            tolerance=config.tolerance, cg_max_iters=config.cg_max_iters)
    return minimize_lbfgs_margin(
        obj, batch, w0, max_iters=config.max_iters,
        tolerance=config.tolerance, history=config.history)


def _permuted_prep(X: BlockedEllRows, w0, prior_mean, prior_precision):
    """Translate original-space side inputs into the permuted feature space
    a BlockedEllRows solve runs in ((d,) vectors gather through
    ``perm_cols``)."""
    w0 = X.from_model_space(w0)
    if prior_mean is not None:
        prior_mean = X.from_model_space(prior_mean)
    if prior_precision is not None:
        prior_precision = X.from_model_space(prior_precision)
    return w0, prior_mean, prior_precision


def _init_w0(d: int, w0, device) -> torch.Tensor:
    if w0 is None:
        return torch.zeros(d, dtype=torch.float32, device=device)
    if np.ndim(w0) == 2:
        raise ValueError("per-lane (G, d) w0 is a grid-path feature; single "
                         "solves take a (d,) start")
    return _vec_on(w0, device)


def _matrix_dim(X) -> int:
    if isinstance(X, (SparseRows, BlockedEllRows)):
        return X.n_features
    return int(X.shape[1])


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
    device=None,
) -> tuple[GeneralizedLinearModel, OptResult]:
    """Full-batch GLM training on one device (reference: train_glm without
    a mesh). The batch moves to ``device`` (default ``cuda``) first.

    A `BlockedEllRows` batch solves in its permuted space; ``w0`` and the
    priors are taken, and the model's coefficients and variances returned,
    in ORIGINAL column order. ``config.kernels`` scopes the kernel mode of
    the whole solve."""
    if config.kernels is not None:
        with K.scope(config.kernels):
            return train_glm(
                batch, task, dataclasses.replace(config, kernels=None),
                w0=w0, variance=variance, prior_mean=prior_mean,
                prior_precision=prior_precision, prior=prior,
                normalization=normalization, device=device)
    if prior is not None:
        raise NotImplementedError(
            "PriorDistribution (incl. full-covariance priors) is not ported "
            "yet (ROADMAP queue A items 1 and 3); pass the diagonal "
            "prior_mean/prior_precision")
    if normalization is not None:
        raise NotImplementedError(
            "feature normalization is not ported yet (ROADMAP queue A "
            "item 3)")
    dev = resolve_device(device)
    batch = batch.to(dev)
    X = batch.X
    d = _matrix_dim(X)
    w0 = _init_w0(d, w0, dev)
    prior_mean = _vec_on(prior_mean, dev)
    prior_precision = _vec_on(prior_precision, dev)
    permuted = isinstance(X, BlockedEllRows)
    intercept_index = -1
    # Dense OWL-QN evaluates f and g through the fused kernel (one X pass
    # per evaluation); L-BFGS and TRON are margin-cached and never call
    # value_and_grad, and a BlockedEllRows batch keeps the unfused route
    # (its X passes are the blocked-ELL kernels), as the reference.
    use_fused = (config.effective_optimizer() is OptimizerType.OWLQN
                 and not permuted)
    if permuted:
        w0, prior_mean, prior_precision = _permuted_prep(
            X, w0, prior_mean, prior_precision)
        intercept_index = X.last_col_pos
    obj = make_objective(task, config, d, prior_mean=prior_mean,
                         prior_precision=prior_precision,
                         intercept_index=intercept_index, fused=use_fused,
                         device=dev)
    res = solve(obj, batch, w0, config)
    var = compute_variances(obj, res.w, batch, variance)
    if permuted:
        res = res._replace(w=X.to_model_space(res.w))
        if var is not None:
            var = X.to_model_space(var)
    return GeneralizedLinearModel(Coefficients(res.w, var), task), res
