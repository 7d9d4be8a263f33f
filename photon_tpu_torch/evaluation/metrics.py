"""Evaluation metrics, weight-aware, on the scores' device (port of
`photon_tpu/evaluation/metrics.py`).

Reference parity: com.linkedin.photon.ml.evaluation.{AreaUnderROCCurve
Evaluator, RMSEEvaluator, SquaredLossEvaluator, LogisticLossEvaluator,
PoissonLossEvaluator, SmoothedHingeLossEvaluator, PrecisionAtKEvaluator}.

Each metric is a handful of PyTorch ops where the scores live (a CUDA
tensor keeps the whole metric on the card; numpy input is read as a CPU
tensor) and returns a 0-d f32 tensor. Rows of weight 0 are padding and
contribute nothing. ``scores`` are raw margins or means as each metric
expects (AUC is rank-based, so either works); binary labels are {0, 1}.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.evaluation.grouped import (_grouped_auc,
                                                 _grouped_aupr, _inputs)
from photon_tpu_torch.ops.losses import TaskType, loss_fns


def _asarrays(scores, labels, weights):
    if weights is None:
        s = scores if isinstance(scores, torch.Tensor) else \
            torch.as_tensor(scores)
        weights = torch.ones(s.shape, dtype=torch.float32, device=s.device)
    s, y, w, _ = _inputs(scores, labels, weights)
    return s, y, w


def _one_group(s):
    return torch.zeros(s.shape, dtype=torch.int64, device=s.device)


def auc(scores, labels, weights=None) -> torch.Tensor:
    """Weighted, tie-aware area under the ROC curve: P(s⁺ > s⁻) +
    ½ P(s⁺ = s⁻) under the weighted empirical distribution. NaN when a
    class has zero total weight. The one-group case of
    `grouped.grouped_auc`, so the tie handling lives in one place."""
    s, y, w = _asarrays(scores, labels, weights)
    per_group, _, _ = _grouped_auc(s, y, w, _one_group(s), 1)
    return per_group[0]


def aupr(scores, labels, weights=None) -> torch.Tensor:
    """Weighted, tie-aware area under the precision–recall curve in the
    step-wise average-precision form; NaN when the positive weight is
    zero. The one-group case of `grouped.grouped_aupr`."""
    s, y, w = _asarrays(scores, labels, weights)
    per_group, _, _ = _grouped_aupr(s, y, w, _one_group(s), 1)
    return per_group[0]


def rmse(scores, labels, weights=None) -> torch.Tensor:
    """Weighted root-mean-squared error (scores: mean predictions, for
    linear regression the raw margin)."""
    s, y, w = _asarrays(scores, labels, weights)
    d = s - y
    return torch.sqrt(torch.sum(w * d * d) / torch.sum(w))


def _mean_pointwise_loss(task: TaskType):
    loss, _, _ = loss_fns(task)

    def metric(scores, labels, weights=None) -> torch.Tensor:
        s, y, w = _asarrays(scores, labels, weights)
        return torch.sum(w * loss(s, y)) / torch.sum(w)

    return metric


# the reference's evaluators take the raw margin (offset + score) for these
logistic_loss = _mean_pointwise_loss(TaskType.LOGISTIC_REGRESSION)
squared_loss = _mean_pointwise_loss(TaskType.LINEAR_REGRESSION)
poisson_loss = _mean_pointwise_loss(TaskType.POISSON_REGRESSION)
smoothed_hinge_loss = _mean_pointwise_loss(
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def precision_at_k(scores, labels, k: int, weights=None) -> torch.Tensor:
    """Share of positives among the k highest-scoring real rows (labels
    counted unweighted; weight 0 marks padding). With fewer than k real
    rows, the share of the rows there are."""
    s, y, w = _asarrays(scores, labels, weights)
    real = w > 0.0
    key = torch.where(real, s, torch.full_like(s, float("-inf")))
    topk = torch.argsort(-key, stable=True)[:int(k)]
    mask = real[topk].to(torch.float32)
    return torch.sum(y[topk] * mask) / torch.clamp(torch.sum(mask), min=1.0)
