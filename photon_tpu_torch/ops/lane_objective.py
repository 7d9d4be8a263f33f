"""Lane-stacked GLM objective: G lanes solved lock-step in LANE-MINOR
layout (port of `photon_tpu/ops/lane_objective.py`) — coefficients (d, G),
margins (n, G), per-lane scalars (G,).

Lane-minor keeps the lane axis contiguous: the hot-block (or dense)
matvec is one (n, d_sel) × (d_sel, G) product, and every tail gather and
scatter of the blocked-ELL kernels moves G contiguous floats per index,
the same number of random accesses as a single lane.

The functions mirror `ops.objective.Objective`'s margin-space API; the
``Objective`` supplies the task, ``reg_mask`` and the normalization fold
(shared by every lane), and per-lane L2 weights arrive as an explicit
``l2s`` (G,) tensor. On a mesh (a row-sharded `parallel.mesh.SlotRows`
X) the column sums and the lane-stacked Xᵀ pass are per-slot partials,
and each evaluation closes them with one reduction (`objective.
reduce_rows`), as the single-lane objective does.

Lanes are either regularization weights over one shared batch (the grid:
X shared, (n,) labels, weights and offsets broadcast over the lanes) or
ENTITIES (a random effect's bucket: X an `EntityBlocks` whose lane passes
multiply each lane by its own rows, and (m, G) labels, weights and
offsets, one column per entity). Entity lanes may carry their own
diagonal prior: ``prior_mean`` / ``prior_precision`` of shape (d, G). A
shared (d,) prior or a full-covariance one is not a lane objective
(`supports_lanes`).
"""
from __future__ import annotations

import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.data.matrix import (matvec_lanes, rmatvec_lanes,
                                          sq_rmatvec_lanes)
from photon_tpu_torch.ops.losses import loss_fns
from photon_tpu_torch.ops.objective import (Objective, reduce_rows, row_sum,
                                            slot_map)


def _lane_prior(v) -> bool:
    return v is None or v.dim() == 2


def supports_lanes(obj: Objective) -> bool:
    """Whether the lane-minor path can run this objective: no prior, or
    per-lane (d, G) diagonal priors; never a full-covariance one."""
    return (obj.prior_full_precision is None
            and _lane_prior(obj.prior_mean)
            and _lane_prior(obj.prior_precision))


def _col(v):
    """A per-row batch column as (n, 1) — or (m, G) as it is, per lane."""
    return v if v.dim() == 2 else v[:, None]


def _eff_w_lanes(obj: Objective, W):
    return W if obj.norm_factors is None else W * obj.norm_factors[:, None]


def margin_lanes(obj: Objective, W, batch: GLMBatch):
    """z(W) = X(f∘W) − s·(f∘W) + offsets: (n, G) per-row margins."""
    Wt = _eff_w_lanes(obj, W)
    z = matvec_lanes(batch.X, Wt) + _col(batch.offsets)
    if obj.norm_shifts is not None:
        z = z - (obj.norm_shifts @ Wt)[None, :]
    return z


def direction_margin_lanes(obj: Objective, P, batch: GLMBatch):
    """dz = ∂z/∂w · P per lane (offset-free): (n, G)."""
    Pt = _eff_w_lanes(obj, P)
    dz = matvec_lanes(batch.X, Pt)
    if obj.norm_shifts is not None:
        dz = dz - (obj.norm_shifts @ Pt)[None, :]
    return dz


def _backprop_parts_lanes(obj: Objective, batch: GLMBatch, Gm):
    """The row sums of `_backprop_lanes`: (XᵀGm, ΣGm or None)."""
    gsum = row_sum(batch, Gm, 0) if obj.norm_shifts is not None else None
    return rmatvec_lanes(batch.X, Gm), gsum


def _finish_backprop_lanes(obj: Objective, out, gsum):
    if obj.norm_shifts is not None:
        out = out - obj.norm_shifts[:, None] * gsum[None, :]
    if obj.norm_factors is not None:
        out = out * obj.norm_factors[:, None]
    return out


def _backprop_lanes(obj: Objective, batch: GLMBatch, Gm):
    """Pull an (n, G) per-row cotangent back to (d, G):
    f∘(XᵀGm − s·ΣGm) (one reduction on a mesh)."""
    return _finish_backprop_lanes(
        obj, *reduce_rows(batch, *_backprop_parts_lanes(obj, batch, Gm)))


def _masked(obj: Objective, W):
    return W if obj.reg_mask is None else W * obj.reg_mask[:, None]


def _has_prior(obj: Objective) -> bool:
    return obj.prior_mean is not None or obj.prior_precision is not None


def _prior_parts(obj: Objective, l2s):
    """((d, G) per-lane coefficients (l2 + τ)·mask, (d, G) or 0 means)."""
    tau = obj.prior_precision if obj.prior_precision is not None else 0.0
    coeff = l2s[None, :] + tau
    if obj.reg_mask is not None:
        coeff = coeff * obj.reg_mask[:, None]
    mu = obj.prior_mean if obj.prior_mean is not None else 0.0
    return coeff, mu


def _reg_terms_lanes(obj: Objective, l2s, W):
    """(value (G,), grad (d, G)) of the per-lane smooth regularizer."""
    if _has_prior(obj):
        coeff, mu = _prior_parts(obj, l2s)
        dW = W - mu
        return 0.5 * torch.sum(coeff * dW * dW, dim=0), coeff * dW
    masked = _masked(obj, W)
    return 0.5 * l2s * torch.sum(masked * W, dim=0), l2s[None, :] * masked


def ray_reg_coeffs_lanes(obj: Objective, l2s, W, P):
    """Per-lane (c0, c1, c2), each (G,): the regularizer along W + a∘P is
    exactly c0 + a·c1 + a²/2·c2 per lane."""
    if _has_prior(obj):
        coeff, mu = _prior_parts(obj, l2s)
        dW = W - mu
        return (0.5 * torch.sum(coeff * dW * dW, dim=0),
                torch.sum(coeff * dW * P, dim=0),
                torch.sum(coeff * P * P, dim=0))
    mW = _masked(obj, W)
    c0 = 0.5 * l2s * torch.sum(mW * W, dim=0)
    c1 = l2s * torch.sum(mW * P, dim=0)
    c2 = l2s * torch.sum(_masked(obj, P) * P, dim=0)
    return c0, c1, c2


def _reg_hvp_lanes(obj: Objective, l2s, V):
    if _has_prior(obj):
        return _prior_parts(obj, l2s)[0] * V
    return l2s[None, :] * _masked(obj, V)


def phi_at_ray_lanes(obj: Objective, z, dz, a, coeffs, batch: GLMBatch):
    """(φ(a), φ'(a)) per lane from cached margins — one (n, G) elementwise
    pass and two (G,) column sums, no pass over X. ``a``: (G,)."""
    loss, d1, _ = loss_fns(obj.task)

    def rows(za, y, wt, dz):
        y, wt = _col(y), _col(wt)
        return wt * loss(za, y), wt * d1(za, y) * dz

    wl, wd = slot_map(batch, rows, z + a[None, :] * dz, batch.y,
                      batch.weights, dz)
    f, dphi = reduce_rows(batch, row_sum(batch, wl, 0),
                          row_sum(batch, wd, 0))
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
    r = slot_map(batch, lambda z, y, wt, dz: _col(wt) * d2(z, _col(y)) * dz,
                 z, batch.y, batch.weights, dZv)
    return _backprop_lanes(obj, batch, r) + _reg_hvp_lanes(obj, l2s, V)


def value_at_margin_lanes(obj: Objective, l2s, W, z, batch: GLMBatch):
    """Per-lane smooth objective (data loss + regularizer) from cached
    margins — one (n, G) elementwise pass, no X pass and no gradient (the
    lane OWL-QN's backtracking trials need values only)."""
    loss, _, _ = loss_fns(obj.task)
    wl = slot_map(batch, lambda z, y, wt: _col(wt) * loss(z, _col(y)), z,
                  batch.y, batch.weights)
    (value,) = reduce_rows(batch, row_sum(batch, wl, 0))
    return value + _reg_terms_lanes(obj, l2s, W)[0]


def grad_at_margin_lanes(obj: Objective, l2s, W, z, batch: GLMBatch):
    """Per-lane gradient from cached margins — one lane-stacked Xᵀ pass."""
    _, d1, _ = loss_fns(obj.task)
    r = slot_map(batch, lambda z, y, wt: _col(wt) * d1(z, _col(y)), z,
                 batch.y, batch.weights)
    return _backprop_lanes(obj, batch, r) + _reg_terms_lanes(obj, l2s, W)[1]


def value_and_grad_at_margin_lanes(obj: Objective, l2s, W, z,
                                   batch: GLMBatch):
    """(f (G,), g (d, G)) from cached margins: one elementwise pass and
    one lane-stacked Xᵀ pass."""
    loss, d1, _ = loss_fns(obj.task)

    def rows(z, y, wt):
        y, wt = _col(y), _col(wt)
        return wt * d1(z, y), wt * loss(z, y)

    r, wl = slot_map(batch, rows, z, batch.y, batch.weights)
    gX, gsum = _backprop_parts_lanes(obj, batch, r)
    value, gX, gsum = reduce_rows(batch, row_sum(batch, wl, 0), gX, gsum)
    grad = _finish_backprop_lanes(obj, gX, gsum)
    rv, rg = _reg_terms_lanes(obj, l2s, W)
    return value + rv, grad + rg


def _reg_hess_diag_lanes(obj: Objective, l2s, W):
    if _has_prior(obj):
        return _prior_parts(obj, l2s)[0] * torch.ones_like(W)
    return l2s[None, :] * _masked(obj, torch.ones_like(W))


def hess_diag_lanes(obj: Objective, l2s, W, batch: GLMBatch):
    """diag(H) per lane, (d, G): `Objective.hess_diag` of every lane."""
    _, _, d2 = loss_fns(obj.task)
    w2 = _col(batch.weights) * d2(margin_lanes(obj, W, batch), _col(batch.y))
    diag = sq_rmatvec_lanes(batch.X, w2)
    if obj.norm_shifts is not None:
        s = obj.norm_shifts[:, None]
        diag = (diag - 2.0 * s * rmatvec_lanes(batch.X, w2)
                + s * s * torch.sum(w2, dim=0)[None, :])
    if obj.norm_factors is not None:
        f = obj.norm_factors[:, None]
        diag = diag * f * f
    return diag + _reg_hess_diag_lanes(obj, l2s, W)


def full_hessian_lanes(obj: Objective, l2s, W, batch: GLMBatch):
    """The dense Hessian of every lane, (G, d, d): `Objective.full_hessian`
    per lane (its X must give per-lane Gram matrices: `EntityBlocks`)."""
    _, _, d2 = loss_fns(obj.task)
    w2 = _col(batch.weights) * d2(margin_lanes(obj, W, batch), _col(batch.y))
    H = batch.X.weighted_gram_lanes(w2)
    if obj.norm_shifts is not None:
        s = obj.norm_shifts
        q = rmatvec_lanes(batch.X, w2).t()  # (G, d)
        ss = torch.outer(s, s)
        H = (H - s[None, :, None] * q[:, None, :]
             - q[:, :, None] * s[None, None, :]
             + torch.sum(w2, dim=0)[:, None, None] * ss[None])
    if obj.norm_factors is not None:
        H = H * torch.outer(obj.norm_factors, obj.norm_factors)[None]
    return H + torch.diag_embed(_reg_hess_diag_lanes(obj, l2s, W).t())
