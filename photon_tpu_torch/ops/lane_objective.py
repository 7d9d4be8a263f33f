"""Lane-stacked GLM objective: G regularization lanes solved lock-step in
LANE-MINOR layout (port of `photon_tpu/ops/lane_objective.py`) —
coefficients (d, G), margins (n, G), per-lane scalars (G,).

Lane-minor keeps the lane axis contiguous: the hot-block (or dense)
matvec is one (n, d_sel) × (d_sel, G) product, and every tail gather and
scatter of the blocked-ELL kernels moves G contiguous floats per index,
the same number of random accesses as a single lane.

The functions mirror `ops.objective.Objective`'s margin-space API; the
``Objective`` supplies the task and ``reg_mask``, and per-lane L2 weights
arrive as an explicit ``l2s`` (G,) tensor. Priors are not supported here
(`train_glm_grid` sends prior sweeps to its general runner). Feature
normalization is not ported (ROADMAP queue A item 4): the normalization
hooks keep the reference's shape and raise for an objective that carries
one. One device, so there is no cross-device sum.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.data.matrix import matvec_lanes, rmatvec_lanes
from photon_tpu_torch.ops.losses import loss_fns
from photon_tpu_torch.ops.objective import Objective


def supports_lanes(obj: Objective) -> bool:
    """Whether the lane-minor path can run this objective (no priors)."""
    return obj.prior_mean is None and obj.prior_precision is None


def _no_normalization(obj) -> None:
    if getattr(obj, "norm_factors", None) is not None \
            or getattr(obj, "norm_shifts", None) is not None:
        raise NotImplementedError(
            "feature normalization is not ported yet (ROADMAP queue A "
            "item 4)")


def _eff_w_lanes(obj: Objective, W):
    """The coefficients the margin sees (the reference folds normalization
    factors in here)."""
    _no_normalization(obj)
    return W


def margin_lanes(obj: Objective, W, batch: GLMBatch):
    """z(W) = XW + offsets: (n, G) per-row margins."""
    return matvec_lanes(batch.X, _eff_w_lanes(obj, W)) \
        + batch.offsets[:, None]


def direction_margin_lanes(obj: Objective, P, batch: GLMBatch):
    """dz = X·P per lane (offset-free): (n, G)."""
    return matvec_lanes(batch.X, _eff_w_lanes(obj, P))


def _backprop_lanes(obj: Objective, batch: GLMBatch, Gm):
    """Pull an (n, G) per-row cotangent back to (d, G): (Xᵀ Gm, the shift
    term's column sums, None without normalization)."""
    _no_normalization(obj)
    return rmatvec_lanes(batch.X, Gm), None


def _finish_backprop_lanes(obj: Objective, gX, gsum=None):
    _no_normalization(obj)
    return gX


def _masked(obj: Objective, W):
    return W if obj.reg_mask is None else W * obj.reg_mask[:, None]


def _reg_terms_lanes(obj: Objective, l2s, W):
    """(value (G,), grad (d, G)) of the per-lane L2 regularizer."""
    masked = _masked(obj, W)
    return 0.5 * l2s * torch.sum(masked * W, dim=0), l2s[None, :] * masked


def ray_reg_coeffs_lanes(obj: Objective, l2s, W, P):
    """Per-lane (c0, c1, c2), each (G,): the regularizer along W + a∘P is
    exactly c0 + a·c1 + a²/2·c2 per lane."""
    mW = _masked(obj, W)
    c0 = 0.5 * l2s * torch.sum(mW * W, dim=0)
    c1 = l2s * torch.sum(mW * P, dim=0)
    c2 = l2s * torch.sum(_masked(obj, P) * P, dim=0)
    return c0, c1, c2


def phi_at_ray_lanes(obj: Objective, z, dz, a, coeffs, batch: GLMBatch):
    """(φ(a), φ'(a)) per lane from cached margins — one (n, G) elementwise
    pass and two (G,) column sums, no pass over X. ``a``: (G,)."""
    loss, d1, _ = loss_fns(obj.task)
    za = z + a[None, :] * dz
    y = batch.y[:, None]
    wt = batch.weights[:, None]
    f = torch.sum(wt * loss(za, y), dim=0)
    dphi = torch.sum(wt * d1(za, y) * dz, dim=0)
    c0, c1, c2 = coeffs
    return f + c0 + a * (c1 + 0.5 * a * c2), dphi + c1 + a * c2


def hvp_at_margin_lanes(obj: Objective, l2s, z, batch: GLMBatch, V,
                        dZv=None):
    """H·V per lane with the margin z cached (Gauss-Newton form, exact for
    GLMs): one X pass for the directions' margins (none when the caller
    passes ``dZv``, as TRON's CG does) and one lane-stacked Xᵀ pass."""
    _, _, d2 = loss_fns(obj.task)
    if dZv is None:
        dZv = direction_margin_lanes(obj, V, batch)
    r = batch.weights[:, None] * d2(z, batch.y[:, None]) * dZv
    hv = _finish_backprop_lanes(obj, *_backprop_lanes(obj, batch, r))
    return hv + l2s[None, :] * _masked(obj, V)


def value_at_margin_lanes(obj: Objective, l2s, W, z, batch: GLMBatch):
    """Per-lane smooth objective (data loss + L2) from cached margins —
    one (n, G) elementwise pass, no X pass and no gradient (the lane
    OWL-QN's backtracking trials need values only)."""
    loss, _, _ = loss_fns(obj.task)
    value = torch.sum(batch.weights[:, None] * loss(z, batch.y[:, None]),
                      dim=0)
    return value + _reg_terms_lanes(obj, l2s, W)[0]


def grad_at_margin_lanes(obj: Objective, l2s, W, z, batch: GLMBatch):
    """Per-lane gradient from cached margins — one lane-stacked Xᵀ pass."""
    _, d1, _ = loss_fns(obj.task)
    r = batch.weights[:, None] * d1(z, batch.y[:, None])
    grad = _finish_backprop_lanes(obj, *_backprop_lanes(obj, batch, r))
    return grad + _reg_terms_lanes(obj, l2s, W)[1]


def value_and_grad_at_margin_lanes(obj: Objective, l2s, W, z,
                                   batch: GLMBatch):
    """(f (G,), g (d, G)) from cached margins: one elementwise pass and
    one lane-stacked Xᵀ pass."""
    loss, d1, _ = loss_fns(obj.task)
    y = batch.y[:, None]
    wt = batch.weights[:, None]
    grad = _finish_backprop_lanes(
        obj, *_backprop_lanes(obj, batch, wt * d1(z, y)))
    value = torch.sum(wt * loss(z, y), dim=0)
    rv, rg = _reg_terms_lanes(obj, l2s, W)
    return value + rv, grad + rg
