"""GLM containers (port of the `Coefficients`/`GeneralizedLinearModel`
part of `photon_tpu/models/glm.py`, with `chunked_margins` and the
batched `score_models`).

User-facing coefficients are in ORIGINAL column order; a `BlockedEllRows`
or `PermutedHybridRows` design matrix (or its sharded form, or a chunk
ladder) works in its permuted space, so scoring
translates w at the boundary (one gather). A sharded layout scores all
its rows on its device (the global view); a host `ChunkedMatrix` chunk
by chunk (`chunked_margins`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.matrix import (PERMUTED_LAYOUTS,
                                          SHARDED_LAYOUTS, SHARDED_PERMUTED,
                                          SINGLE_DEVICE_LAYOUTS, SparseRows,
                                          matvec, matvec_lanes)
from photon_tpu_torch.ops.losses import TaskType, mean_fn


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Reference: com.linkedin.photon.ml.model.Coefficients."""

    means: torch.Tensor  # (d,)
    variances: Optional[torch.Tensor] = None  # (d,) or None

    @property
    def dim(self) -> int:
        return int(self.means.shape[0])


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    coefficients: Coefficients
    task: TaskType

    @property
    def weights(self) -> torch.Tensor:
        return self.coefficients.means

    def score(self, X, offsets=0.0) -> torch.Tensor:
        """Raw margin x·w + offset (reference: computeScore)."""
        w = self.coefficients.means
        if hasattr(X, "n_chunks"):
            return chunked_margins(X, w, offsets)
        if isinstance(X, PERMUTED_LAYOUTS + SHARDED_PERMUTED):
            w = X.from_model_space(w)
        return matvec(X, w) + offsets

    def predict_mean(self, X, offsets=0.0) -> torch.Tensor:
        """Mean response via the inverse link (reference: computeMean)."""
        return mean_fn(self.task)(self.score(X, offsets))


def chunked_margins(X, w: torch.Tensor, offsets=0.0) -> torch.Tensor:
    """Margins over a host `ChunkedMatrix` on ``w``'s device: each chunk
    streams through the upload ring into one matvec, the results
    concatenated there and trimmed to (n_real,) (reference:
    `chunked_margins`)."""
    from photon_tpu_torch.data.dataset import make_chunked_batch

    w = w.to(torch.float32)
    if X.permuted:
        w = w[X.perm_cols.to(w.device).long()]
    data = make_chunked_batch(X, torch.zeros(X.n_real))
    parts = [matvec(b.X, w) for _, b in data.iter_device(device=w.device)]
    return torch.cat(parts)[:X.n_real] + offsets


def _score_many(W: torch.Tensor, X, offsets=0.0) -> torch.Tensor:
    """(G, n) margins of G lane-major coefficient rows W (G, d), original
    column order: one lane pass over X — a permuted layout takes
    ``W[:, perm_cols]`` lane-minor (its hot product one (n, d_sel) ×
    (d_sel, G) product, its tail one G-lane kernel launch), dense X one
    (n, d) × (d, G) product."""
    W = W.to(torch.float32)
    Wt = (X.from_model_space(W.t())
          if isinstance(X, PERMUTED_LAYOUTS + SHARDED_PERMUTED)
          else W.t().contiguous())
    return matvec_lanes(X, Wt).t() + offsets


def score_models(models, X, offsets=0.0) -> torch.Tensor:
    """(G, n) raw margins of G same-shape models over one design matrix in
    one lane pass (reference: `score_models`, the scoring side of a
    `train_glm_grid` sweep), on X's device."""
    dev = (X.dense if isinstance(X, SINGLE_DEVICE_LAYOUTS + SHARDED_LAYOUTS)
           else X.values if isinstance(X, SparseRows) else X).device
    W = torch.stack([m.coefficients.means.to(dev) for m in models])
    if not isinstance(offsets, (int, float)):
        offsets = torch.as_tensor(offsets).to(dev, torch.float32)
    return _score_many(W, X, offsets)


def _glm(task: TaskType, coeffs, variances=None) -> GeneralizedLinearModel:
    means = torch.as_tensor(coeffs)
    if variances is not None:
        variances = torch.as_tensor(variances)
    return GeneralizedLinearModel(Coefficients(means, variances), task)


def logistic_regression(coeffs, variances=None) -> GeneralizedLinearModel:
    """A logistic-regression GLM of these coefficients (tensors, or
    arrays taken as tensors on the CPU)."""
    return _glm(TaskType.LOGISTIC_REGRESSION, coeffs, variances)


def linear_regression(coeffs, variances=None) -> GeneralizedLinearModel:
    """A linear-regression GLM of these coefficients."""
    return _glm(TaskType.LINEAR_REGRESSION, coeffs, variances)


def poisson_regression(coeffs, variances=None) -> GeneralizedLinearModel:
    """A Poisson-regression GLM of these coefficients."""
    return _glm(TaskType.POISSON_REGRESSION, coeffs, variances)
