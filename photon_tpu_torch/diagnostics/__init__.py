"""Model diagnostics (port of `photon_tpu/diagnostics`): the Poisson
bootstrap, the Hosmer–Lemeshow calibration test and feature importance."""
from photon_tpu_torch.diagnostics.bootstrap import (BootstrapReport,
                                                    bootstrap_from_weights,
                                                    bootstrap_glm)
from photon_tpu_torch.diagnostics.hosmer_lemeshow import (
    HosmerLemeshowResult,
    hosmer_lemeshow,
)
from photon_tpu_torch.diagnostics.importance import (
    FeatureImportanceReport,
    expected_magnitude_importance,
    variance_importance,
)

__all__ = [
    "BootstrapReport",
    "bootstrap_glm",
    "bootstrap_from_weights",
    "HosmerLemeshowResult",
    "hosmer_lemeshow",
    "FeatureImportanceReport",
    "expected_magnitude_importance",
    "variance_importance",
]
