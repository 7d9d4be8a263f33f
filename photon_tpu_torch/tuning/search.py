"""Search-space definition and candidate generation (the port's copy of
`photon_tpu/tuning/search.py`: numpy and scipy only, the same candidates
bit for bit).

Reference parity: com.linkedin.photon.ml.hyperparameter.
{SearchRange, Sobol candidate generation, RandomSearch, grid search fallback}
and HyperparameterConfig's log-transform ranges. Candidates are generated in
the unit cube [0, 1]^d and mapped through per-dimension (optionally
log-scaled) ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SearchRange:
    """One hyperparameter's range (reference: DoubleRange + transform)."""

    lo: float
    hi: float
    log_scale: bool = False  # reference: "LOG" transform for reg weights

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError(f"empty range [{self.lo}, {self.hi}]")
        if self.log_scale and self.lo <= 0:
            raise ValueError("log-scaled range requires lo > 0")

    def from_unit(self, u):
        u = np.asarray(u)
        if self.log_scale:
            lo, hi = np.log(self.lo), np.log(self.hi)
            return np.exp(lo + u * (hi - lo))
        return self.lo + u * (self.hi - self.lo)

    def to_unit(self, x):
        x = np.asarray(x)
        if self.log_scale:
            lo, hi = np.log(self.lo), np.log(self.hi)
            return (np.log(x) - lo) / (hi - lo)
        return (x - self.lo) / (self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    ranges: Sequence[SearchRange]

    @property
    def dim(self) -> int:
        return len(self.ranges)

    def from_unit(self, U: np.ndarray) -> np.ndarray:
        return np.stack(
            [r.from_unit(U[..., j]) for j, r in enumerate(self.ranges)], -1
        )

    def to_unit(self, X: np.ndarray) -> np.ndarray:
        return np.stack(
            [r.to_unit(X[..., j]) for j, r in enumerate(self.ranges)], -1
        )


def sobol_candidates(space: SearchSpace, n: int, seed: int = 0) -> np.ndarray:
    """Scrambled Sobol points (reference: SobolSequence candidate draws);
    returns UNIT-cube points (n, d)."""
    from scipy.stats import qmc

    try:
        eng = qmc.Sobol(space.dim, scramble=True,
                        rng=np.random.default_rng(seed))
    except TypeError:  # scipy < 1.15 spells the argument `seed`
        eng = qmc.Sobol(space.dim, scramble=True, seed=seed)
    return eng.random(n).astype(np.float64)


def random_candidates(space: SearchSpace, n: int, seed: int = 0) -> np.ndarray:
    """Uniform unit-cube candidates (reference: RandomSearch draws)."""
    return np.random.default_rng(seed).uniform(size=(n, space.dim))


def grid_candidates(space: SearchSpace, points_per_dim: int) -> np.ndarray:
    """Full-factorial unit grid (reference: grid-search fallback)."""
    axes = [np.linspace(0.0, 1.0, points_per_dim)] * space.dim
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], -1)


def candidates(
    space: SearchSpace,
    n: int,
    method: str = "sobol",
    seed: int = 0,
    points_per_dim: Optional[int] = None,
) -> np.ndarray:
    if method == "sobol":
        return sobol_candidates(space, n, seed)
    if method == "random":
        return random_candidates(space, n, seed)
    if method == "grid":
        return grid_candidates(space, points_per_dim or max(2, round(n ** (1 / space.dim))))
    raise ValueError(f"unknown candidate method {method!r}")
