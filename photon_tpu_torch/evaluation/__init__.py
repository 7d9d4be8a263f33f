"""Evaluation metrics and evaluators (port of `photon_tpu/evaluation`):
plain PyTorch on the scores' device, the grouped metrics by sorted
segments (no scatter)."""
from photon_tpu_torch.evaluation.evaluator import (
    Evaluator,
    EvaluatorType,
    default_evaluator,
    evaluator_suite,
)
from photon_tpu_torch.evaluation.grouped import (
    grouped_auc,
    grouped_aupr,
    grouped_precision_at_k,
)
from photon_tpu_torch.evaluation.metrics import (
    auc,
    aupr,
    logistic_loss,
    poisson_loss,
    precision_at_k,
    rmse,
    smoothed_hinge_loss,
    squared_loss,
)

__all__ = [
    "Evaluator",
    "EvaluatorType",
    "default_evaluator",
    "evaluator_suite",
    "grouped_auc",
    "grouped_aupr",
    "grouped_precision_at_k",
    "auc",
    "aupr",
    "rmse",
    "squared_loss",
    "logistic_loss",
    "poisson_loss",
    "smoothed_hinge_loss",
    "precision_at_k",
]
