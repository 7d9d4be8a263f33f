"""Acquisition functions over a fitted GP (port of
`photon_tpu/tuning/acquisition.py`).

Reference parity: com.linkedin.photon.ml.hyperparameter.criteria.
{ExpectedImprovement, ConfidenceBound}. Minimization convention throughout
(the tuner negates AUC-like metrics before they get here). EI and LCB run
on the GP's device (the normal cdf by `torch.special.ndtr`); the joint
q-EI works on the host over `GaussianProcess.sample_joint`'s fantasies,
as the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from photon_tpu_torch.tuning.gp import GaussianProcess

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def expected_improvement(gp: GaussianProcess, Xq, best_y: float,
                         device=None) -> torch.Tensor:
    """EI(x) = E[max(best_y − f(x), 0)] (reference: ExpectedImprovement)."""
    mean, std = gp.predict(Xq, device=device)
    std = torch.clamp(std, min=1e-12)
    z = (best_y - mean) / std
    pdf = torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    return std * (z * torch.special.ndtr(z) + pdf)


def lower_confidence_bound(gp: GaussianProcess, Xq, beta: float = 2.0,
                           device=None) -> torch.Tensor:
    """LCB(x) = μ(x) − β·σ(x); SMALLER is better (reference:
    ConfidenceBound). Returned negated so that, like EI, the best
    candidate MAXIMIZES it."""
    mean, std = gp.predict(Xq, device=device)
    return -(mean - beta * std)


# Joint batch expected improvement by Monte-Carlo fantasies: S joint
# posterior draws over the candidate pool carry the full cross-candidate
# covariance, so a batch's value is E[max(0, best − min_i f(x_i))] up to
# MC error. The reference's HyperparameterTuner proposes one candidate a
# round; batch proposals feed one `train_glm_grid` per batch.


def qei(gp: GaussianProcess, X_batch, best_y: float, n_samples: int = 512,
        seed: int = 0) -> float:
    """Monte-Carlo joint q-EI of a FIXED batch: E[max(0, best_y −
    min_i f(x_i))] over joint posterior fantasies."""
    Z = gp.sample_joint(X_batch, n_samples, seed)  # (S, q)
    return float(np.mean(np.maximum(0.0, best_y - Z.min(axis=1))))


def qei_greedy(gp: GaussianProcess, pool, best_y: float, q: int,
               n_samples: int = 256, seed: int = 0, costs=None) -> list:
    """Greedy true-q-EI batch selection over a candidate pool: one set of
    S joint fantasies over the whole pool, pick j+1 maximizing the MC
    increment of the joint q-EI given picks 1..j. Returns pool indices in
    pick order. ``costs`` ((P,), positive) picks by marginal improvement
    per unit cost; uniform costs reduce exactly to the plain greedy."""
    Z = gp.sample_joint(pool, n_samples, seed)  # (S, P)
    S, P = Z.shape
    if costs is not None:
        costs = np.asarray(costs, np.float64)
        if costs.shape != (P,):
            raise ValueError(
                f"costs must be shaped like the pool ({P},), got "
                f"{costs.shape}")
        if not (costs > 0).all():
            raise ValueError("costs must be positive")
    m = np.full(S, np.inf, np.float64)  # per-fantasy running batch minimum
    picked: list = []
    avail = np.ones(P, bool)
    for _ in range(min(q, P)):
        gains = np.mean(np.maximum(0.0, best_y - np.minimum(m[:, None], Z)),
                        axis=0)
        if costs is not None:
            # the MARGINAL increment over the batch so far (a constant
            # across candidates: without costs the argmax is unchanged)
            cur = float(np.mean(np.maximum(0.0, best_y - m)))
            gains = (gains - cur) / costs
        gains[~avail] = -np.inf
        j = int(np.argmax(gains))
        picked.append(j)
        avail[j] = False
        m = np.minimum(m, Z[:, j])
    return picked
