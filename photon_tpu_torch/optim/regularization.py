"""Regularization configuration (port of `photon_tpu/optim/regularization.py`,
framework-free, kept as the port's own copy).

Reference parity: com.linkedin.photon.ml.optimization.RegularizationContext /
RegularizationType. The elastic-net split matches the reference:
l1 weight = alpha * lambda, l2 weight = (1 - alpha) * lambda.

The smooth L2 part lives in the objective (value/grad/Hessian); the
non-smooth L1 part is handled by OWL-QN (as in the reference, where Breeze's
OWLQN owns the L1 term and the DiffFunction carries only L2).
"""
from __future__ import annotations

import dataclasses
import enum


class RegularizationType(enum.Enum):
    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    reg_type: RegularizationType = RegularizationType.NONE
    # ELASTIC_NET mixing in [0, 1]: 1 → pure L1, 0 → pure L2
    # (reference: RegularizationContext.elasticNetParam).
    alpha: float = 0.0

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type is RegularizationType.L1:
            return reg_weight
        if self.reg_type is RegularizationType.ELASTIC_NET:
            return self.alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type is RegularizationType.L2:
            return reg_weight
        if self.reg_type is RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * reg_weight
        return 0.0


NONE = RegularizationContext(RegularizationType.NONE)


def l1() -> RegularizationContext:
    return RegularizationContext(RegularizationType.L1)


def l2() -> RegularizationContext:
    return RegularizationContext(RegularizationType.L2)


def elastic_net(alpha: float) -> RegularizationContext:
    return RegularizationContext(RegularizationType.ELASTIC_NET, alpha)
