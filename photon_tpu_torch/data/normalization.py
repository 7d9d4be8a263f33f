"""Feature normalization (port of `photon_tpu/data/normalization.py`;
numpy, as the reference).

Reference parity: com.linkedin.photon.ml.normalization.{NormalizationType,
NormalizationContext} — NONE, SCALE_WITH_MAX_MAGNITUDE,
SCALE_WITH_STANDARD_DEVIATION, STANDARDIZATION. Normalized data is never
materialized: the objective folds ``factors`` and ``shifts`` into every
margin and backprop (`ops.objective`), so sparse X stays sparse. The solve
runs in NORMALIZED coefficient space (the space the L2 penalty sees, as
the reference's regularization under normalization), and
`to_original_space` converts trained coefficients back, folding the shift
correction into the intercept. Shifts (STANDARDIZATION) need an
intercept column.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.data.matrix import (BlockedEllRows, HybridRows,
                                          SparseRows)


class NormalizationType(enum.Enum):
    NONE = "none"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    STANDARDIZATION = "standardization"


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu().numpy()
    return np.asarray(a)


def _column_stats(X) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, std, max|x|) per column in f64; sparse statistics count the
    implicit zeros, as the reference's summary over full vectors."""
    if isinstance(X, BlockedEllRows):
        raise TypeError(
            "NormalizationContext.build does not take BlockedEllRows: build "
            "the context from the SparseRows/dense matrix BEFORE "
            "to_blocked_ell (the factors/shifts then apply unchanged, the "
            "solve permutes them itself)")
    if isinstance(X, HybridRows):
        raise TypeError(
            "NormalizationContext.build does not take HybridRows: build the "
            "context from the original SparseRows/dense matrix BEFORE "
            "to_hybrid (the fitted factors/shifts then apply unchanged, "
            "since to_hybrid only reorders storage)")
    if isinstance(X, SparseRows):
        n, d = X.shape
        idx = _np(X.indices).reshape(-1)
        val = _np(X.values).reshape(-1)
        s1 = np.zeros(d, np.float64)
        s2 = np.zeros(d, np.float64)
        mx = np.zeros(d, np.float64)
        np.add.at(s1, idx, val)
        np.add.at(s2, idx, val * val)
        np.maximum.at(mx, idx, np.abs(val))
        mean = s1 / n
        var = np.maximum(s2 / n - mean * mean, 0.0)
        return mean, np.sqrt(var), mx
    Xn = np.asarray(_np(X), np.float64)
    return Xn.mean(0), Xn.std(0), np.abs(Xn).max(0)


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Per-feature factors/shifts; the margin math lives in
    `ops.objective`."""

    norm_type: NormalizationType
    factors: Optional[np.ndarray] = None  # (d,) multiply
    shifts: Optional[np.ndarray] = None  # (d,) subtract (pre-factor)
    intercept_index: Optional[int] = None

    def __post_init__(self):
        if self.shifts is not None and self.intercept_index is None:
            raise ValueError(
                "shifts require an intercept_index — the shift correction "
                "folds into the intercept coefficient (reference: "
                "NormalizationContext shift modes require the intercept)")

    @staticmethod
    def no_op() -> "NormalizationContext":
        return NormalizationContext(NormalizationType.NONE)

    @staticmethod
    def build(X, norm_type: NormalizationType,
              intercept_index: Optional[int] = -1) -> "NormalizationContext":
        """Factors/shifts from a design matrix (dense numpy or tensor, or
        `SparseRows`)."""
        if norm_type is NormalizationType.NONE:
            return NormalizationContext.no_op()
        mean, std, mx = _column_stats(X)
        return NormalizationContext._from_stats(mean, std, mx, norm_type,
                                                intercept_index)

    @staticmethod
    def from_summary(summary, norm_type: NormalizationType,
                     intercept_index: Optional[int] = -1
                     ) -> "NormalizationContext":
        """From precomputed per-column statistics (an object with ``mean``,
        ``std`` and ``abs_max``)."""
        if norm_type is NormalizationType.NONE:
            return NormalizationContext.no_op()
        return NormalizationContext._from_stats(
            summary.mean, summary.std, summary.abs_max, norm_type,
            intercept_index)

    @staticmethod
    def _from_stats(mean, std, mx, norm_type, intercept_index):
        mean = np.asarray(mean, np.float64)
        std = np.asarray(std, np.float64)
        mx = np.asarray(mx, np.float64)
        d = mean.shape[0]
        if intercept_index is not None and intercept_index < 0:
            intercept_index += d
        if norm_type is NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
            denom, shifts = mx, None
        elif norm_type is NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
            denom, shifts = std, None
        elif norm_type is NormalizationType.STANDARDIZATION:
            if intercept_index is None:
                raise ValueError(
                    "STANDARDIZATION requires an intercept column "
                    "(reference: NormalizationContext shift modes)")
            denom, shifts = std, mean.astype(np.float32)
        else:
            raise ValueError(norm_type)
        # zero-variance / all-zero columns keep factor 1
        factors = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 1.0)
        factors = factors.astype(np.float32)
        if intercept_index is not None and 0 <= intercept_index < d:
            factors[intercept_index] = 1.0
            if shifts is not None:
                shifts[intercept_index] = 0.0
        return NormalizationContext(norm_type, factors, shifts,
                                    intercept_index)

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    # ------------------------------------------------- coefficient transforms
    def to_original_space(self, w) -> np.ndarray:
        """Normalized-space coefficients → original space: scale by the
        factors; the shift correction −(shifts·(factors∘w)) folds into the
        intercept."""
        return self.rows_to_original_space(np.asarray(_np(w))[None, :])[0]

    def to_normalized_space(self, w_orig) -> np.ndarray:
        """Inverse of `to_original_space` (a warm start or a prior mean
        into the solve's space)."""
        return self.rows_to_normalized_space(
            np.asarray(_np(w_orig))[None, :])[0]

    def rows_to_original_space(self, W) -> np.ndarray:
        """`to_original_space` over (E, d) coefficient rows."""
        W = np.asarray(_np(W), np.float32)
        if self.is_identity:
            return W
        out = (W * self.factors[None, :] if self.factors is not None
               else W.copy())
        if self.shifts is not None:
            out[:, self.intercept_index] -= out @ self.shifts
        return out

    def rows_to_normalized_space(self, W_orig) -> np.ndarray:
        """Inverse of `rows_to_original_space` over (E, d) rows."""
        W_orig = np.asarray(_np(W_orig), np.float32)
        if self.is_identity:
            return W_orig
        W = W_orig.copy()
        if self.shifts is not None:
            W[:, self.intercept_index] += W @ self.shifts
        if self.factors is not None:
            W = np.where(self.factors[None, :] != 0,
                         W / self.factors[None, :], W)
        return W.astype(np.float32)

    def variances_to_original_space(self, var) -> np.ndarray:
        """Diagonal variances scale by factors² (the intercept's covariance
        with the shift correction is dropped: a diagonal approximation)."""
        var = np.asarray(_np(var), np.float32)
        if self.factors is None:
            return var
        return var * (self.factors * self.factors)
