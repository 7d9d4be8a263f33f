"""Hosmer–Lemeshow goodness-of-fit (calibration) test for logistic models
(port of `photon_tpu/diagnostics/hosmer_lemeshow.py`).

Reference parity: com.linkedin.photon.ml.diagnostics.hl.
HosmerLemeshowDiagnostic — decile binning of predicted probabilities and
a chi-square statistic over observed against expected positives per bin.

On the probabilities' device (or ``device``): a stable sort by predicted
probability; weighted-decile bin ids from the cumulative-weight fraction,
the prefix sum taken by `data.matrix.prefix_sum` (a float CUDA cumsum
changes its bits from call to call); the per-bin observed / expected /
mass sums, and each bin's O − E summed as Σ w·(y − p) (no cancellation
of two near sums), by `data.matrix.sorted_segment_sum` (the bins are
monotone after the sort); padding (weight 0) adds nothing to any bin —
its contributions are zeroed where it stands, as the reference routes it
to a bin it drops; one chi-square reduction. The p-value is the
regularized upper incomplete gamma, χ²_{G-2} survival = Γ((G−2)/2,
χ²/2) / Γ((G−2)/2), by `torch.special.gammaincc`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photon_tpu_torch.data.dataset import _f32
from photon_tpu_torch.data.matrix import prefix_sum, sorted_segment_sum


class HosmerLemeshowResult(NamedTuple):
    chi2: torch.Tensor
    p_value: torch.Tensor
    dof: torch.Tensor
    observed_pos: torch.Tensor  # (n_bins,) weighted positives per bin
    expected_pos: torch.Tensor  # (n_bins,) sum of predicted probabilities
    bin_weight: torch.Tensor  # (n_bins,) total weight per bin

    @property
    def well_calibrated(self) -> torch.Tensor:
        """True when the test fails to reject calibration at the 5% level."""
        return self.p_value > 0.05


def hosmer_lemeshow(probs, labels, weights=None, n_bins: int = 10,
                    device=None) -> HosmerLemeshowResult:
    """HL test on predicted probabilities against binary labels, on
    ``device`` (default: the probabilities' device; ``cuda`` for numpy
    inputs).

    probs: model probabilities in (0, 1) (NOT raw margins). Rows of weight
    0 are padding and land in no bin. Bins are weighted deciles of the
    score distribution, the reference's equal-population binning."""
    from photon_tpu_torch.device import resolve_device

    if device is None and isinstance(probs, torch.Tensor):
        dev = probs.device
    else:
        dev = resolve_device(device)
    probs = _f32(probs, dev)
    labels = _f32(labels, dev)
    weights = (torch.ones_like(probs) if weights is None
               else _f32(weights, dev))

    order = torch.sort(probs, stable=True).indices
    p, y, w = probs[order], labels[order], weights[order]
    total = torch.sum(w)
    # the weight midpoint of each row → its decile
    cumw = prefix_sum(w) - 0.5 * w
    bins = torch.clamp((cumw / total * n_bins).to(torch.int32), 0,
                       n_bins - 1)
    real = w > 0.0
    zero = torch.zeros_like(w)
    obs = sorted_segment_sum(torch.where(real, w * y, zero), bins, n_bins)
    exp = sorted_segment_sum(torch.where(real, w * p, zero), bins, n_bins)
    mass = sorted_segment_sum(torch.where(real, w, zero), bins, n_bins)
    # O_g − E_g summed directly as Σ w·(y − p): the difference of the two
    # sums would cancel most of their bits in a calibrated bin
    gap = sorted_segment_sum(torch.where(real, w * (y - p), zero), bins,
                             n_bins)

    # χ² = Σ_g (O_g − E_g)² / (E_g (1 − E_g / n_g)); empty bins add 0
    denom = exp * (1.0 - exp / torch.clamp(mass, min=1e-12))
    term = torch.where(mass > 0.0,
                       gap * gap / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(mass))
    chi2 = torch.sum(term)
    # dof counts the bins that received mass (heavy rows can empty some)
    n_occupied = torch.sum((mass > 0.0).to(torch.float32))
    dof = torch.clamp(n_occupied - 2.0, min=1.0)
    p_value = torch.special.gammaincc(dof / 2.0, chi2 / 2.0)
    return HosmerLemeshowResult(chi2, p_value, dof, obs, exp, mass)
