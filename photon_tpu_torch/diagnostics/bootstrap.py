"""Bootstrap training diagnostic (port of
`photon_tpu/diagnostics/bootstrap.py`).

Reference parity: com.linkedin.photon.ml.diagnostics.bootstrap.
BootstrapTrainingDiagnostic — train the model on B bootstrap resamples and
report per-coefficient confidence intervals and metric distributions.

The **Poisson bootstrap**, as the reference: each replicate reweights
every row by an i.i.d. Poisson(1) count, which matches multinomial
resampling in distribution for large n (Chamandy et al., "Estimating
Uncertainty for Massive Data Streams", 2012), so every replicate shares
the same batch and differs only in its weight vector. `bootstrap_glm`
draws the (B, n) counts from a seeded `torch.Generator` on the batch's
device and hands them to `bootstrap_from_weights`, which solves each
replicate with `models.training.solve` in turn (the fused value+grad
kernel for a dense OWL-QN solve, as `train_glm` takes it). Solving the
replicates as lanes of one lock-step solve is ROADMAP speed work.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.data.dataset import GLMBatch, _f32
from photon_tpu_torch.models.training import _matrix_dim, make_objective, solve
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType


class BootstrapReport(NamedTuple):
    coefficients: np.ndarray  # (B, d) per-replicate fitted coefficients
    mean: np.ndarray  # (d,)
    std: np.ndarray  # (d,)
    ci_lower: np.ndarray  # (d,) percentile CI lower bound
    ci_upper: np.ndarray  # (d,)
    converged: np.ndarray  # (B,) bool per replicate
    metrics: Optional[np.ndarray]  # (B,) metric per replicate, if requested

    def contains(self, w) -> np.ndarray:
        """Per coordinate: does the CI contain w?"""
        w = np.asarray(w)
        return (self.ci_lower <= w) & (w <= self.ci_upper)


def poisson_counts(n_replicates: int, n: int, seed: int = 0,
                   device=None) -> torch.Tensor:
    """(B, n) f32 Poisson(1) counts from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default ``cuda``)."""
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return torch.poisson(torch.ones((n_replicates, n), dtype=torch.float32,
                                    device=dev), generator=gen)


def bootstrap_from_weights(
    batch: GLMBatch,
    task: TaskType,
    config: OptimizerConfig,
    rep_weights,
    confidence: float = 0.95,
    metric_fn: Optional[Callable] = None,
    intercept_index: Optional[int] = -1,
) -> BootstrapReport:
    """Solve one replicate per row of ``rep_weights`` ((B, n): each
    replicate's row weights) on the batch's device and summarize them.

    metric_fn(w, replicate_batch) -> scalar is evaluated per replicate
    under its weights. Confidence intervals and moments use the replicates
    that converged (all of them, with a warning, when none did)."""
    dev = batch.y.device
    rep = _f32(rep_weights, dev)
    d = _matrix_dim(batch.X)
    fused = (config.effective_optimizer() is OptimizerType.OWLQN
             and isinstance(batch.X, torch.Tensor))
    obj = make_objective(task, config, d, intercept_index=intercept_index,
                         fused=fused, device=dev)
    w0 = torch.zeros((d,), dtype=torch.float32, device=dev)
    ws, ok, ms = [], [], []
    for b in range(int(rep.shape[0])):
        rb = batch._replace(weights=rep[b])
        res = solve(obj, rb, w0, config)
        ws.append(res.w)
        ok.append(res.converged & ~res.failed)
        if metric_fn is not None:
            ms.append(torch.as_tensor(metric_fn(res.w, rb),
                                      dtype=torch.float32))
    B = len(ws)
    ws = torch.stack(ws).cpu().numpy()
    ok = torch.stack(ok).cpu().numpy().astype(bool)
    # replicates that failed their solve would corrupt the quantiles: the
    # moments and CIs use the converged ones (the full matrix is kept)
    if ok.any():
        good = ws[ok]
        if not ok.all():
            warnings.warn(
                f"bootstrap_glm: {int((~ok).sum())}/{B} replicates did not "
                "converge; CIs use the converged subset only", stacklevel=2)
    else:
        good = ws
        warnings.warn(
            "bootstrap_glm: NO replicate converged; the returned CIs are "
            "computed from unconverged solves and are not trustworthy — "
            "raise max_iters or loosen tolerance", stacklevel=2)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(good, [alpha, 1.0 - alpha], axis=0)
    return BootstrapReport(
        coefficients=ws, mean=good.mean(axis=0), std=good.std(axis=0),
        ci_lower=lo, ci_upper=hi, converged=ok,
        metrics=(None if metric_fn is None
                 else torch.stack(ms).cpu().numpy()))


def bootstrap_glm(
    batch: GLMBatch,
    task: TaskType,
    config: OptimizerConfig,
    n_replicates: int = 32,
    confidence: float = 0.95,
    seed: int = 0,
    metric_fn: Optional[Callable] = None,
    intercept_index: Optional[int] = -1,
) -> BootstrapReport:
    """Train ``n_replicates`` Poisson-bootstrap replicates on the batch's
    device. Rows of weight 0 (padding) stay at weight 0 in every
    replicate."""
    counts = poisson_counts(n_replicates, batch.n, seed=seed,
                            device=batch.y.device)
    return bootstrap_from_weights(
        batch, task, config, batch.weights[None, :] * counts,
        confidence=confidence, metric_fn=metric_fn,
        intercept_index=intercept_index)
