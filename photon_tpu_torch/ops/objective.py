"""GLM objective: value / gradient / Hessian products over one device's batch
(port of the single-device part of `photon_tpu/ops/objective.py`).

Reference parity: com.linkedin.photon.ml.function.glm.SingleNodeGLMLossFunction
and function.L2RegularizationTwiceDiffFunction. All quantities use the
reference's SUM convention (weighted sum over examples, not mean), so
regularization weights mean the same thing.

Ported: the smooth regularizer (L2 weight, ``reg_mask``, diagonal and
full-covariance priors), feature normalization folded into the margin and
the backprop, the margin-cached family (`margin`, `direction_margin`,
`ray_reg_coeffs`, `phi_at_ray`, `*_at_margin`, `hvp_at_margin`),
`value_and_grad` (through the fused kernel when ``fused`` is set and X
qualifies), `hvp`, `hess_diag`, `full_hessian`, and the chunk-partial API
of the streamed solvers (`chunk_value_grad_partials` and its kin).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.data.matrix import (matvec, matvec_lanes, rmatvec,
                                          sq_rmatvec, weighted_gram)
from photon_tpu_torch.kernels.fused import can_fuse, fused_value_and_grad
from photon_tpu_torch.ops.losses import TaskType, loss_fns


@dataclasses.dataclass(frozen=True)
class Objective:
    """Smooth part of the regularized negative log-likelihood.

    ``l2`` is the smooth L2 weight. ``reg_mask``: optional (d,) 0/1
    per-coordinate regularization mask (excludes the intercept when
    configured). ``prior_mean`` / ``prior_precision``: a diagonal
    informative prior; the L2 term becomes 0.5 Σ_j (l2 + τ_j)(w_j − μ_j)²
    (the lane objective also takes them lane-minor, (d, G)).
    ``prior_full_precision``: a dense (d, d) precision P adding
    0.5·dwᵀ P dw (small d only). ``norm_factors`` / ``norm_shifts``:
    feature normalization folded into the margin, z = X(f∘w) − s·(f∘w) +
    offsets, so the solve runs in normalized coefficient space.
    ``fused``: `value_and_grad` takes the fused value+grad kernel
    (`kernels.fused`, one pass over X) when X qualifies (`can_fuse`) and
    nothing is normalized; `train_glm` sets it for dense OWL-QN solves.
    """

    task: TaskType
    l2: float = 0.0
    fused: bool = False
    reg_mask: Optional[torch.Tensor] = None
    prior_mean: Optional[torch.Tensor] = None
    prior_precision: Optional[torch.Tensor] = None
    prior_full_precision: Optional[torch.Tensor] = None
    norm_factors: Optional[torch.Tensor] = None
    norm_shifts: Optional[torch.Tensor] = None

    # ---------------------------------------------------------------- helpers
    def _eff_w(self, w):
        """The coefficients the data sees: f∘w."""
        return w if self.norm_factors is None else w * self.norm_factors

    def _margin_of_eff(self, wt, X):
        z = matvec(X, wt)
        if self.norm_shifts is not None:
            z = z - torch.dot(self.norm_shifts, wt)
        return z

    def _backprop(self, batch: GLMBatch, g):
        """∂z/∂w pulled back over a per-row cotangent g: f∘(Xᵀg − s·Σg)."""
        return self._finish_backprop(*self._backprop_parts(batch, g))

    def _backprop_parts(self, batch: GLMBatch, g):
        """The pieces of `_backprop` that sum over rows: (Xᵀg, Σg), Σg only
        when a shift exists (None otherwise)."""
        gsum = torch.sum(g) if self.norm_shifts is not None else None
        return rmatvec(batch.X, g), gsum

    def _finish_backprop(self, gX, gsum=None):
        out = gX
        if self.norm_shifts is not None:
            out = out - self.norm_shifts * gsum
        if self.norm_factors is not None:
            out = out * self.norm_factors
        return out

    def _reg_parts(self):
        mask = self.reg_mask if self.reg_mask is not None else 1.0
        mu = self.prior_mean if self.prior_mean is not None else 0.0
        tau = self.prior_precision if self.prior_precision is not None else 0.0
        return (self.l2 + tau) * mask, mu

    def _reg_terms(self, w):
        """(value, grad) of the smooth regularizer at w."""
        coeff, mu = self._reg_parts()
        dw = w - mu
        value = 0.5 * torch.sum(coeff * dw * dw)
        grad = coeff * dw
        if self.prior_full_precision is not None:
            Pdw = self.prior_full_precision @ dw
            value = value + 0.5 * torch.dot(dw, Pdw)
            grad = grad + Pdw
        return value, grad

    def _reg_hess_diag(self, w):
        diag = self._reg_parts()[0] * torch.ones_like(w)
        if self.prior_full_precision is not None:
            diag = diag + torch.diagonal(self.prior_full_precision)
        return diag

    def _reg_hvp(self, v):
        out = self._reg_parts()[0] * v
        if self.prior_full_precision is not None:
            out = out + self.prior_full_precision @ v
        return out

    # ------------------------------------------------------------------- API
    def value_and_grad(self, w, batch: GLMBatch):
        """(f, g) at w: one fused pass over X when ``fused`` is set, X
        qualifies and nothing is normalized, else one X pass for the
        margin and one for Xᵀr."""
        if (self.fused and self.norm_factors is None
                and self.norm_shifts is None and can_fuse(batch.X)):
            value, gX = fused_value_and_grad(self.task, batch.X, w, batch.y,
                                             batch.weights, batch.offsets)
            rv, rg = self._reg_terms(w)
            return value + rv, gX + rg
        return self.value_and_grad_at_margin(w, self.margin(w, batch), batch)

    # ------------------------------------------------ margin-space API
    # The margin is LINEAR in w: z(w + a·p) = z(w) + a·dz, so the
    # margin-cached L-BFGS runs its line search elementwise on cached
    # (z, dz) and pays exactly two X passes per iteration.

    def margin(self, w, batch: GLMBatch):
        """z(w) = X(f∘w) − s·(f∘w) + offsets."""
        wt = self._eff_w(w)
        z = matvec(batch.X, wt) + batch.offsets
        if self.norm_shifts is not None:
            z = z - torch.dot(self.norm_shifts, wt)
        return z

    def direction_margin(self, p, batch: GLMBatch):
        """dz = ∂z/∂w · p (the offset-free margin of the direction)."""
        return self._margin_of_eff(self._eff_w(p), batch.X)

    def ray_reg_coeffs(self, w, p):
        """Scalars (c0, c1, c2) of the regularizer along the ray w + a·p:
        every smooth term (L2, diagonal and full priors) is quadratic in
        w, so its value is c0 + a·c1 + a²/2·c2 exactly and its slope
        c1 + a·c2 — one O(d) pass per line search."""
        coeff, mu = self._reg_parts()
        dw = w - mu
        c0 = 0.5 * torch.sum(coeff * dw * dw)
        c1 = torch.sum(coeff * dw * p)
        c2 = torch.sum(coeff * p * p)
        if self.prior_full_precision is not None:
            Pdw = self.prior_full_precision @ dw
            Pp = self.prior_full_precision @ p
            c0 = c0 + 0.5 * torch.dot(dw, Pdw)
            c1 = c1 + torch.dot(dw, Pp)
            c2 = c2 + torch.dot(p, Pp)
        return c0, c1, c2

    def phi_at_ray(self, z, dz, a, coeffs, batch: GLMBatch):
        """(φ(a), φ'(a)) along w + a·p from the cached margins and the
        ray's regularizer coefficients: O(n) elementwise plus scalars, no
        (d,) work."""
        loss, d1, _ = loss_fns(self.task)
        za = z + a * dz
        f = torch.sum(batch.weights * loss(za, batch.y))
        dphi = torch.sum(batch.weights * d1(za, batch.y) * dz)
        c0, c1, c2 = coeffs
        return f + c0 + a * (c1 + 0.5 * a * c2), dphi + c1 + a * c2

    def value_at_margin(self, w, z, batch: GLMBatch):
        """f(w) from a cached margin — elementwise only, no pass over X."""
        loss, _, _ = loss_fns(self.task)
        return (torch.sum(batch.weights * loss(z, batch.y))
                + self._reg_terms(w)[0])

    def grad_at_margin(self, w, z, batch: GLMBatch):
        """Full gradient from a cached margin — ONE pass over X (Xᵀr)."""
        _, d1, _ = loss_fns(self.task)
        r = batch.weights * d1(z, batch.y)
        return self._backprop(batch, r) + self._reg_terms(w)[1]

    def value_and_grad_at_margin(self, w, z, batch: GLMBatch):
        """(f, g) from a cached margin — one elementwise pass + one Xᵀr."""
        loss, d1, _ = loss_fns(self.task)
        r = batch.weights * d1(z, batch.y)
        gX = self._backprop(batch, r)
        value = torch.sum(batch.weights * loss(z, batch.y))
        rv, rg = self._reg_terms(w)
        return value + rv, gX + rg

    # ------------------------------------------------ chunk-partial API
    # The streamed solvers (optim/streamed.py) stream a dataset too big
    # for device memory through the solve chunk by chunk, and each
    # evaluation sums per-chunk partials on the device, in chunk order, in
    # f32 (the reference's per-partition treeAggregate leaves). Partials
    # carry NO regularizer terms: the regularizer is a function of w alone
    # and `finish_value_grad` adds it once.

    def chunk_value_grad_partials(self, w, batch: GLMBatch):
        """(margin, partials) of ONE chunk: the margin for the caller's
        per-chunk cache, the partials to sum with `add_partials` and close
        with `finish_value_grad`."""
        z = self.margin(w, batch)
        return z, self.chunk_partials_at_margin(z, batch)

    def chunk_partials_at_margin(self, z, batch: GLMBatch):
        """(loss sum, Xᵀr, Σr or None) of one chunk from its cached margin:
        one elementwise pass and one Xᵀr pass."""
        loss, d1, _ = loss_fns(self.task)
        r = batch.weights * d1(z, batch.y)
        gX, gsum = self._backprop_parts(batch, r)
        return torch.sum(batch.weights * loss(z, batch.y)), gX, gsum

    @staticmethod
    def add_partials(a, b):
        """Two chunk-partial tuples summed leaf by leaf (None stays None)."""
        return tuple(None if x is None else x + y for x, y in zip(a, b))

    def finish_value_grad(self, w, partials):
        """(f, g) from summed chunk partials plus the regularizer at w."""
        val, gX, gsum = partials
        rv, rg = self._reg_terms(w)
        return val + rv, self._finish_backprop(gX, gsum) + rg

    def chunk_phi_partials(self, z, dz, a, y, weights):
        """(φ_loss, φ'_loss) partials of one chunk at step ``a`` along its
        cached (z, dz): elementwise only, no X, no (d,) work (the caller
        adds the regularizer's exact quadratic ray once)."""
        loss, d1, _ = loss_fns(self.task)
        za = z + a * dz
        return (torch.sum(weights * loss(za, y)),
                torch.sum(weights * d1(za, y) * dz))

    def chunk_value_partials_many(self, W, batch: GLMBatch):
        """(K,) loss partials of K candidate coefficient vectors (rows of
        ``W``, (K, d)) over ONE chunk, the streamed OWL-QN ladder's leaf:
        one lane pass over X for all K (`matvec_lanes`, the blocked-ELL
        kernels at K lanes), so one chunk upload prices every candidate.
        ``W.t()`` is used as it is when contiguous (pass the transpose of
        a lane-minor (d, K) tensor to avoid a copy)."""
        loss, _, _ = loss_fns(self.task)
        Wl = W.t()
        if self.norm_factors is not None:
            Wl = Wl * self.norm_factors[:, None]
        Z = matvec_lanes(batch.X, Wl.contiguous())
        if self.norm_shifts is not None:
            Z = Z - (self.norm_shifts @ Wl)[None, :]
        Z = Z + batch.offsets[:, None]
        return torch.sum(batch.weights[:, None] * loss(Z, batch.y[:, None]),
                         dim=0)

    def hess_diag(self, w, batch: GLMBatch):
        """diag(H) = f²∘(X∘X)ᵀ(weight·d2(z)) (with shifts, the expansion
        Σ w2 (x − s)², so sparse X never densifies) + the regularizer's
        diagonal (reference: TwiceDiffFunction.hessianDiagonal, behind
        SIMPLE variances)."""
        _, _, d2 = loss_fns(self.task)
        w2 = batch.weights * d2(self.margin(w, batch), batch.y)
        diag = sq_rmatvec(batch.X, w2)
        if self.norm_shifts is not None:
            s = self.norm_shifts
            diag = (diag - 2.0 * s * rmatvec(batch.X, w2)
                    + s * s * torch.sum(w2))
        if self.norm_factors is not None:
            diag = diag * self.norm_factors * self.norm_factors
        return diag + self._reg_hess_diag(w)

    def hvp_at_margin(self, w, z, batch: GLMBatch, v, dz_v=None):
        """H(w)·v with the margin z cached (Gauss-Newton form, exact for
        GLMs): two X passes (dz_v and the backprop). Pass dz_v when the
        caller already has the direction's margin (TRON's CG does)."""
        _, _, d2 = loss_fns(self.task)
        if dz_v is None:
            dz_v = self.direction_margin(v, batch)
        g = batch.weights * d2(z, batch.y) * dz_v
        return self._backprop(batch, g) + self._reg_hvp(v)

    def hvp(self, w, batch: GLMBatch, v):
        """H(w)·v: Jᵀ diag(weight·d2(z)) J v + the regularizer's Hessian
        times v, J = ∂z/∂w (reference: TwiceDiffFunction.hessianVector)."""
        return self.hvp_at_margin(w, self.margin(w, batch), batch, v)

    def full_hessian(self, w, batch: GLMBatch):
        """Dense (d, d) Hessian (reference: TwiceDiffFunction.hessianMatrix,
        behind FULL variances; small feature spaces only). With
        normalization: F(G − s qᵀ − q sᵀ + (Σw2) s sᵀ)F, G = Xᵀdiag(w2)X,
        q = Xᵀw2, F = diag(factors)."""
        _, _, d2 = loss_fns(self.task)
        w2 = batch.weights * d2(self.margin(w, batch), batch.y)
        H = weighted_gram(batch.X, w2)
        if self.norm_shifts is not None:
            s = self.norm_shifts
            q = rmatvec(batch.X, w2)
            H = (H - torch.outer(s, q) - torch.outer(q, s)
                 + torch.sum(w2) * torch.outer(s, s))
        if self.norm_factors is not None:
            H = H * torch.outer(self.norm_factors, self.norm_factors)
        H = H + torch.diag(self._reg_parts()[0] * torch.ones_like(w))
        if self.prior_full_precision is not None:
            H = H + self.prior_full_precision
        return H
