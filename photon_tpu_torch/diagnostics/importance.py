"""Feature-importance diagnostics (port of
`photon_tpu/diagnostics/importance.py`).

Reference parity: com.linkedin.photon.ml.diagnostics.featureimportance.
{ExpectedMagnitudeFeatureImportanceDiagnostic,
 VarianceFeatureImportanceDiagnostic} — the importance of feature j is
|w_j| · E[|x_j|] (expected contribution to the margin) or |w_j| · σ(x_j)
(its variability). Both are one weighted column-moment pass over X and an
elementwise product, on X's device: a dense X by one vector-matrix
product, a `SparseRows` X by its column sums in sorted segments
(`data.matrix.segment_plan` / `segment_sums`: a fixed tree of adds per
column, the same bits every run, no atomic add).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.dataset import _f32
from photon_tpu_torch.data.matrix import (BlockedEllRows, HybridRows,
                                          SparseRows, segment_plan,
                                          segment_sums)
from photon_tpu_torch.device import resolve_device


class FeatureImportanceReport(NamedTuple):
    importance: np.ndarray  # (d,)
    order: np.ndarray  # (d,) feature ids, most important first
    names: Optional[Sequence[str]]

    def top(self, k: int = 20) -> list[tuple[object, float]]:
        ids = self.order[:k]
        label = ((lambda j: self.names[j]) if self.names is not None
                 else (lambda j: int(j)))
        return [(label(j), float(self.importance[j])) for j in ids]


def _on_device(X, device):
    """X as the moments take it: a layout or tensor where it lies, a numpy
    array as an f32 tensor on ``device`` (default ``cuda``)."""
    if isinstance(X, (SparseRows, BlockedEllRows, HybridRows,
                      torch.Tensor)):
        return X
    return _f32(X, resolve_device(device))


def _device_of(X) -> torch.device:
    if isinstance(X, SparseRows):
        return X.values.device
    if isinstance(X, (BlockedEllRows, HybridRows)):
        return X.dense.device
    return X.device


def _column_moments(X, weights: torch.Tensor, which: str) -> torch.Tensor:
    """One weighted column moment: E[|x|] (which='abs') or Var[x]
    ('var')."""
    if isinstance(X, BlockedEllRows):
        raise TypeError(
            "feature importance does not take BlockedEllRows: compute it on "
            "the original SparseRows/dense matrix (to_blocked_ell only "
            "reorders storage)")
    if isinstance(X, HybridRows):
        raise TypeError(
            "feature importance does not take HybridRows: compute it on the "
            "original SparseRows/dense matrix (to_hybrid only reorders "
            "storage)")
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    if isinstance(X, SparseRows):
        plan = segment_plan(X)
        vals = X.values.reshape(-1).to(torch.float32)[plan.src.long()]
        wv = w[plan.rows.long()] * vals
        if which == "abs":
            return segment_sums(plan, torch.abs(wv))
        e1 = segment_sums(plan, wv)
        e2 = segment_sums(plan, wv * vals)
        return torch.clamp(e2 - e1 * e1, min=0.0)
    X = X.to(torch.float32)
    if which == "abs":
        return w @ torch.abs(X)
    e1 = w @ X
    e2 = w @ (X * X)
    return torch.clamp(e2 - e1 * e1, min=0.0)


def _prep(w, X, weights, device) -> tuple:
    X = _on_device(X, device)
    dev = _device_of(X)
    n = int(X.shape[0])
    wts = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
           else _f32(weights, dev))
    return _f32(w, dev), X, wts


def _report(importance: torch.Tensor, names) -> FeatureImportanceReport:
    imp = importance.cpu().numpy()
    return FeatureImportanceReport(imp, np.argsort(-imp), names)


def expected_magnitude_importance(
        w, X, weights=None, names: Optional[Sequence[str]] = None,
        device=None) -> FeatureImportanceReport:
    """|w_j| · E[|x_j|] (ExpectedMagnitudeFeatureImportanceDiagnostic), on
    X's device (``device``, default ``cuda``, for a numpy X)."""
    w, X, wts = _prep(w, X, weights, device)
    return _report(torch.abs(w) * _column_moments(X, wts, "abs"), names)


def variance_importance(
        w, X, weights=None, names: Optional[Sequence[str]] = None,
        device=None) -> FeatureImportanceReport:
    """|w_j| · σ(x_j) (VarianceFeatureImportanceDiagnostic), on X's device
    (``device``, default ``cuda``, for a numpy X)."""
    w, X, wts = _prep(w, X, weights, device)
    return _report(torch.abs(w) * torch.sqrt(_column_moments(X, wts, "var")),
                   names)
