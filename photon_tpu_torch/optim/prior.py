"""Informative Gaussian priors for incremental training (port of
`photon_tpu/optim/prior.py`; numpy, as the reference).

Reference parity: com.linkedin.photon.ml.function.PriorDistribution and
the incremental-training flow: a previous run's posterior (coefficient
means + variances) becomes a Gaussian prior for the next solve, so the
objective's L2 term turns into 0.5·(w − μ)ᵀ Λ (w − μ) with Λ the prior
precision — diagonal (1/variances) in the common path, or a full (d, d)
precision for small feature spaces (from FULL Hessians).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PriorDistribution:
    """Gaussian prior N(mean, Λ⁻¹); at most one of ``precision_diag`` /
    ``precision_full`` is set (both None: the mean alone, no precision)."""

    mean: np.ndarray  # (d,)
    precision_diag: Optional[np.ndarray] = None  # (d,)
    precision_full: Optional[np.ndarray] = None  # (d, d)

    def __post_init__(self):
        if self.precision_diag is not None and self.precision_full is not None:
            raise ValueError("set precision_diag OR precision_full, not both")

    @property
    def dim(self) -> int:
        return int(np.asarray(self.mean).shape[0])

    @staticmethod
    def from_coefficients(means, variances=None,
                          default_precision: float = 1.0, scale: float = 1.0,
                          min_variance: float = 1e-12
                          ) -> "PriorDistribution":
        """A previous model's posterior → prior. Missing variances fall
        back to ``default_precision``; ``scale`` down-weights the prior
        (the reference's incremental-weight multiplier)."""
        means = np.asarray(means, np.float32)
        if variances is None:
            prec = np.full(means.shape, default_precision, np.float32)
        else:
            prec = 1.0 / np.maximum(np.asarray(variances, np.float32),
                                    min_variance)
        return PriorDistribution(means, precision_diag=prec * scale)

    @staticmethod
    def from_variances(means, variances, scale: float = 1.0,
                       min_variance: float = 1e-12) -> "PriorDistribution":
        """A previous solve's means + VARIANCES (diag of the inverse
        Hessian) → the next solve's prior with Λ = diag(scale/var).
        Variances are required; a non-positive variance marks a dimension
        never estimated and gets precision 0 (no prior there). Takes (d,)
        vectors or stacked (E, d) per-entity blocks."""
        if variances is None:
            raise ValueError(
                "from_variances needs the previous run's coefficient "
                "variances; train it with variance_type=simple/full (or "
                "use from_coefficients for the flat-default-precision "
                "prior)")
        means = np.asarray(means, np.float32)
        var = np.asarray(variances, np.float32)
        if var.shape != means.shape:
            raise ValueError(
                f"variances shape {var.shape} != means shape {means.shape}")
        prec = np.where(var > 0.0, scale / np.maximum(var, min_variance),
                        0.0).astype(np.float32)
        return PriorDistribution(means, precision_diag=prec)

    @staticmethod
    def from_hessian(means, hessian, scale: float = 1.0
                     ) -> "PriorDistribution":
        """Full-covariance prior from a dense Hessian (the Laplace
        posterior of the previous solve)."""
        return PriorDistribution(
            np.asarray(means, np.float32),
            precision_full=np.asarray(hessian, np.float32) * scale)
