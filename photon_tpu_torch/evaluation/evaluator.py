"""Evaluator objects and their factory (port of
`photon_tpu/evaluation/evaluator.py`).

Reference parity: com.linkedin.photon.ml.evaluation.{EvaluatorType,
EvaluatorFactory, Evaluator} — including ``betterThan``'s direction (AUC,
AUPR and P@K: higher is better; the losses: lower is better), which
`GameEstimator` uses to select a model on validation data, and the
per-task default evaluator used when none is configured.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.evaluation import grouped, metrics
from photon_tpu_torch.ops.losses import TaskType


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    AUPR = "AUPR"
    RMSE = "RMSE"
    SQUARED_LOSS = "SQUARED_LOSS"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"
    PRECISION_AT_K = "PRECISION_AT_K"
    SHARDED_AUC = "SHARDED_AUC"
    SHARDED_AUPR = "SHARDED_AUPR"
    SHARDED_PRECISION_AT_K = "SHARDED_PRECISION_AT_K"


_HIGHER_IS_BETTER = {
    EvaluatorType.AUC,
    EvaluatorType.AUPR,
    EvaluatorType.SHARDED_AUPR,
    EvaluatorType.PRECISION_AT_K,
    EvaluatorType.SHARDED_AUC,
    EvaluatorType.SHARDED_PRECISION_AT_K,
}

_SHARDED = {EvaluatorType.SHARDED_AUC, EvaluatorType.SHARDED_AUPR,
            EvaluatorType.SHARDED_PRECISION_AT_K}

_AT_K = (EvaluatorType.PRECISION_AT_K, EvaluatorType.SHARDED_PRECISION_AT_K)

_METRIC_FNS = {
    EvaluatorType.AUC: metrics.auc,
    EvaluatorType.AUPR: metrics.aupr,
    EvaluatorType.RMSE: metrics.rmse,
    EvaluatorType.SQUARED_LOSS: metrics.squared_loss,
    EvaluatorType.LOGISTIC_LOSS: metrics.logistic_loss,
    EvaluatorType.POISSON_LOSS: metrics.poisson_loss,
    EvaluatorType.SMOOTHED_HINGE_LOSS: metrics.smoothed_hinge_loss,
}

_GROUPED_FNS = {
    EvaluatorType.SHARDED_AUC: grouped.grouped_auc,
    EvaluatorType.SHARDED_AUPR: grouped.grouped_aupr,
}


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """One metric over (scores, labels, weights[, groups]): ``k`` for the
    P@K evaluators, ``num_groups`` for the sharded ones (dense int group
    ids, see `evaluation.grouped`)."""

    kind: EvaluatorType
    k: int = 10
    num_groups: Optional[int] = None

    @property
    def higher_is_better(self) -> bool:
        return self.kind in _HIGHER_IS_BETTER

    @property
    def needs_groups(self) -> bool:
        return self.kind in _SHARDED

    def better_than(self, a: float, b: Optional[float]) -> bool:
        """Is score ``a`` better than the incumbent ``b``? (reference:
        Evaluator.betterThan; no incumbent or a NaN one always loses)"""
        if b is None or math.isnan(float(b)):
            return True
        return a > b if self.higher_is_better else a < b

    def evaluate(self, scores, labels, weights=None, groups=None) -> float:
        """The metric as a Python float (one read-back), computed on the
        scores' device."""
        if self.needs_groups:
            if groups is None or self.num_groups is None:
                raise ValueError(f"{self.kind} requires groups and num_groups")
            if weights is None:
                s = torch.as_tensor(scores)
                weights = torch.ones(s.shape, dtype=torch.float32,
                                     device=s.device)
            fn = _GROUPED_FNS.get(self.kind)
            if fn is not None:
                _, _, mean = fn(scores, labels, weights, groups,
                                self.num_groups)
            else:
                _, _, mean = grouped.grouped_precision_at_k(
                    scores, labels, weights, groups, self.num_groups, self.k)
            return float(mean)
        if self.kind is EvaluatorType.PRECISION_AT_K:
            return float(metrics.precision_at_k(scores, labels, self.k,
                                                weights))
        fn = _METRIC_FNS.get(self.kind)
        if fn is None:
            raise ValueError(f"unknown evaluator kind: {self.kind}")
        return float(fn(scores, labels, weights))


def evaluate_with_entity(evaluator: Evaluator, scores, labels, weights,
                         entity_ids: dict, entity: Optional[str]) -> float:
    """The sharded evaluators' one path (GameEstimator and the drivers):
    the raw entity-id column densified to group ids on the host, then the
    metric on the scores' device. Raises ValueError when the entity column
    is missing."""
    if entity is None or entity not in entity_ids:
        raise ValueError(
            f"sharded evaluator {evaluator.kind.name} needs an entity id "
            f"column; got {entity!r}, available: {list(entity_ids)}")
    _, groups = np.unique(np.asarray(entity_ids[entity]),
                          return_inverse=True)
    groups = groups.reshape(-1)
    ev = dataclasses.replace(evaluator, num_groups=int(groups.max()) + 1)
    return ev.evaluate(scores, labels, weights, groups)


def parse_evaluator(spec: str) -> Evaluator:
    """An evaluator from its config string (``AUC``, ``RMSE``,
    ``PRECISION@5``): an EvaluatorType name in any case, with an ``@k`` or
    ``:k`` suffix for the precision evaluators."""
    s = spec.strip().upper().replace("@", ":")
    k = None
    if ":" in s:
        s, _, knum = s.partition(":")
        k = int(knum)
    s = s.strip()
    if s == "PRECISION":
        s = "PRECISION_AT_K"
    try:
        kind = EvaluatorType[s]
    except KeyError:
        raise ValueError(
            f"unknown evaluator {spec!r}; valid: "
            f"{[e.name for e in EvaluatorType]}") from None
    if k is not None and kind not in _AT_K:
        raise ValueError(
            f"evaluator {spec!r}: @k only applies to the precision "
            "evaluators (did you mean PRECISION@k?)")
    return Evaluator(kind, k=10 if k is None else k)


def evaluator_name(ev: Evaluator) -> str:
    """The config name, which `parse_evaluator` reads back."""
    if ev.kind in _AT_K:
        return f"{ev.kind.name}@{ev.k}"
    return ev.kind.name


def default_evaluator(task: TaskType) -> Evaluator:
    """The per-task default (reference: the driver's TaskType →
    evaluator)."""
    if task is TaskType.LINEAR_REGRESSION:
        return Evaluator(EvaluatorType.RMSE)
    if task is TaskType.POISSON_REGRESSION:
        return Evaluator(EvaluatorType.POISSON_LOSS)
    return Evaluator(EvaluatorType.AUC)


def evaluator_suite(task: TaskType) -> list:
    """Every unsharded evaluator that applies to ``task``."""
    if task is TaskType.LOGISTIC_REGRESSION:
        return [
            Evaluator(EvaluatorType.AUC),
            Evaluator(EvaluatorType.AUPR),
            Evaluator(EvaluatorType.LOGISTIC_LOSS),
            Evaluator(EvaluatorType.PRECISION_AT_K),
        ]
    if task is TaskType.LINEAR_REGRESSION:
        return [Evaluator(EvaluatorType.RMSE),
                Evaluator(EvaluatorType.SQUARED_LOSS)]
    if task is TaskType.POISSON_REGRESSION:
        return [Evaluator(EvaluatorType.POISSON_LOSS)]
    return [Evaluator(EvaluatorType.AUC),
            Evaluator(EvaluatorType.SMOOTHED_HINGE_LOSS)]
