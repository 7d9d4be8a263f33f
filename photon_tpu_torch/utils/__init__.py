"""Utility helpers (port of `photon_tpu/utils`; reference:
com.linkedin.photon.ml.util)."""
from photon_tpu_torch.utils.logging import photon_logger
from photon_tpu_torch.utils.timing import PhaseTimers, Timer

__all__ = ["photon_logger", "PhaseTimers", "Timer"]
