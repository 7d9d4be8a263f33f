"""Pre-training data validation.

Reference parity: com.linkedin.photon.ml.data.DataValidators — per-task row
checks (finite labels/features/offsets, positive weights, binary labels for
logistic/hinge, non-negative labels for Poisson) with a validate-all /
validate-sample / disable switch (reference: DataValidationType).

The port's copy of `photon_tpu/data/validators.py`: vectorized numpy over
whole columns (the reference maps row-predicates over the RDD); failures
raise ValueError naming each violated check and its count, so shape/NaN
problems surface here instead of mid-solve. Columns given as tensors are
read on the host.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from photon_tpu_torch.data.matrix import SparseRows, _host
from photon_tpu_torch.ops.losses import TaskType


class DataValidationType(enum.Enum):
    """Reference: DataValidationType (VALIDATE_FULL/VALIDATE_SAMPLE/DISABLED)."""

    VALIDATE_FULL = "validate_full"
    VALIDATE_SAMPLE = "validate_sample"
    DISABLED = "disabled"


SAMPLE_SIZE = 100_000


def _feature_values(X) -> np.ndarray:
    v = X.values if isinstance(X, SparseRows) else X
    return _host(v.float() if isinstance(v, torch.Tensor) else v)


def _subsample(arr: np.ndarray, rng) -> np.ndarray:
    n = arr.shape[0]
    if n <= SAMPLE_SIZE:
        return arr
    return arr[rng.choice(n, SAMPLE_SIZE, replace=False)]


def validate_glm_data(
    y,
    X=None,
    weights=None,
    offsets=None,
    task: TaskType = TaskType.LINEAR_REGRESSION,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Raise ValueError listing every failed check (reference:
    DataValidators.sanityCheckData collects all failures before erroring)."""
    if mode is DataValidationType.DISABLED:
        return
    rng = np.random.default_rng(seed)
    sample = mode is DataValidationType.VALIDATE_SAMPLE

    y = _host(y)
    if sample:
        y = _subsample(y, rng)
    failures = []

    bad = ~np.isfinite(y)
    if bad.any():
        failures.append(f"non-finite labels: {int(bad.sum())} rows")
    if task is TaskType.LOGISTIC_REGRESSION or (
        task is TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
    ):
        finite = y[np.isfinite(y)]
        nonbin = ~np.isin(finite, (0.0, 1.0))
        if nonbin.any():
            failures.append(
                f"non-binary labels for {task.name}: {int(nonbin.sum())} rows "
                "(labels must be 0/1)"
            )
    if task is TaskType.POISSON_REGRESSION:
        neg = y[np.isfinite(y)] < 0
        if neg.any():
            failures.append(
                f"negative labels for POISSON_REGRESSION: {int(neg.sum())} rows"
            )

    if X is not None:
        vals = _feature_values(X)
        flat = vals.reshape(-1)
        if sample:
            flat = _subsample(flat, rng)
        bad = ~np.isfinite(flat)
        if bad.any():
            failures.append(f"non-finite feature values: {int(bad.sum())} entries")

    if weights is not None:
        w = _host(weights)
        if sample:
            w = _subsample(w, rng)
        bad = ~np.isfinite(w) | (w < 0)
        if bad.any():
            failures.append(
                f"negative or non-finite weights: {int(bad.sum())} rows"
            )

    if offsets is not None:
        o = _host(offsets)
        if sample:
            o = _subsample(o, rng)
        bad = ~np.isfinite(o)
        if bad.any():
            failures.append(f"non-finite offsets: {int(bad.sum())} rows")

    if failures:
        raise ValueError("data validation failed: " + "; ".join(failures))


def validate_game_data(
    data,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Validate a game.dataset.GameData across every feature shard."""
    if mode is DataValidationType.DISABLED:
        return
    validate_glm_data(
        data.y, X=None, weights=data.weights, offsets=data.offsets,
        task=task, mode=mode,
    )
    for name, X in data.shards.items():
        try:
            validate_glm_data(np.zeros(1), X=X, task=TaskType.LINEAR_REGRESSION,
                              mode=mode)
        except ValueError as e:
            raise ValueError(f"shard {name!r}: {e}") from None
    for name, ids in data.entity_ids.items():
        if len(np.asarray(ids)) != data.n:
            raise ValueError(
                f"entity id column {name!r} has {len(np.asarray(ids))} rows, "
                f"data has {data.n}"
            )
