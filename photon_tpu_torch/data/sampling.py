"""Down-sampling with weight correction.

Reference parity: com.linkedin.photon.ml.sampling.{DownSampler,
DefaultDownSampler, BinaryClassificationDownSampler}. The reference
down-samples the fixed-effect training data per coordinate-descent iteration:
the default sampler keeps every row with probability p and multiplies kept
weights by 1/p (unbiased); the binary-classification sampler keeps ALL
positives and down-samples only negatives, re-weighting the kept negatives by
1/p so the effective class balance (sum of weights) is preserved.

The port's copy of `photon_tpu/data/sampling.py` (host numpy, the same
rng streams, so the same rows for the same seed): returns selected row
indices + corrected weights, from which callers rebuild batches/GameData
(the reference likewise produces a new RDD).
"""
from __future__ import annotations

import numpy as np


def default_down_sample(
    n: int,
    rate: float,
    weights=None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform row sampling (reference: DefaultDownSampler): keep each row
    w.p. ``rate``; kept weights scale by 1/rate. Returns (indices, weights)."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
    w = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
    if rate == 1.0:
        return np.arange(n), w.copy()
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=n) < rate
    idx = np.nonzero(keep)[0]
    return idx, (w[idx] / rate).astype(np.float32)


def down_sample_weights(
    y,
    rate: float,
    weights=None,
    seed: int = 0,
    binary: bool = False,
) -> np.ndarray:
    """Down-sampling expressed as a WEIGHT vector instead of row selection:
    dropped rows get weight 0, kept down-sampled rows get weight/rate, and
    the row count is unchanged. Every weighted objective/gradient/metric
    then equals the row-selected samplers' exactly (a weight-0 row
    contributes zero terms), which is what the streaming drivers need —
    device-resident data cannot be re-indexed without a host round-trip.

    The keep decision replays the SAME rng stream as default_down_sample /
    binary_down_sample with the same seed, so the two forms select
    identical rows. Runs on host numpy — callers with device-resident data
    read back `y` (and `weights`, if not None) first."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
    y = np.asarray(y)
    n = y.shape[0]
    w = (np.ones(n, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    if rate == 1.0:
        return w.copy()
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n)
    if binary:
        pos = y > 0
        keep = pos | (u < rate)
        scale = np.where(pos, 1.0, 1.0 / rate).astype(np.float32)
    else:
        keep = u < rate
        scale = np.float32(1.0 / rate)
    return np.where(keep, w * scale, 0.0).astype(np.float32)


def binary_down_sample(
    y,
    rate: float,
    weights=None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Negative-class down-sampling (reference:
    BinaryClassificationDownSampler): positives (y > 0) all kept with weights
    untouched; negatives kept w.p. ``rate`` with weights scaled by 1/rate.
    Returns (indices, weights) with original row order preserved."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
    y = np.asarray(y)
    n = y.shape[0]
    w = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
    if rate == 1.0:
        return np.arange(n), w.copy()
    rng = np.random.default_rng(seed)
    pos = y > 0
    keep = pos | (rng.uniform(size=n) < rate)
    idx = np.nonzero(keep)[0]
    out_w = w[idx].copy()
    out_w[~pos[idx]] /= rate
    return idx, out_w.astype(np.float32)
