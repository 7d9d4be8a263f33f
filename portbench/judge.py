"""What every entry's judge shares: relative gaps, and the verdict of a
run's numbers against its cell's limits (``portbench/limits/<cell>.json``,
one limit a number, every number the entry compares)."""
from __future__ import annotations

import numpy as np


def rel(got, want) -> float:
    """The largest |got - want| / |want| over the elements; inf where one
    is not finite."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name is there, finite and within its
    limit."""
    return all(k in numbers and np.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)


def last_losses(history, iterations) -> np.ndarray:
    """(G,) each lane's loss at its last iteration, from a (G, T + 1)
    history and (G,) iteration counts."""
    h = np.asarray(history, np.float64)
    return h[np.arange(h.shape[0]), np.asarray(iterations, np.int64)]
