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

On a mesh (a batch whose X is a row-sharded `parallel.mesh.SlotRows`)
the per-row math runs slot by slot (`slot_map`: each slot's rows as a
tensor of their own, so every rounding is the same whichever slots share
a process), every sum over rows becomes one partial per local slot
(`row_sum`, and the X passes' Xᵀr), and each evaluation closes them with
ONE reduction (`reduce_rows`, the mesh's slot-ordered `psum`) — the
reference's `_psum_many`: value and gradient ride one collective, a TRON
HVP is one pass plus one collective, a line-search trial's two totals
one more. On one device the helpers are the plain expressions and sums,
bit for bit.
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
from photon_tpu_torch.parallel.mesh import SlotParts, SlotRows


def slot_map(batch: GLMBatch, fn, *cols):
    """``fn`` of per-row columns ((n,) or (n, G) tensors): on one device
    ``fn(*cols)``; on a mesh batch ``fn`` of each local slot's rows, as
    `SlotParts` (a tuple of them when ``fn`` returns a tuple) — each slot
    a tensor of the same shape at every process count."""
    X = batch.X
    if not isinstance(X, SlotRows):
        return fn(*cols)
    s = X.rows_per_slot
    outs = [fn(*(c[k * s:(k + 1) * s] for c in cols))
            for k in range(X.mesh.n_local)]
    if isinstance(outs[0], tuple):
        return tuple(SlotParts(o[i] for o in outs)
                     for i in range(len(outs[0])))
    return SlotParts(outs)


def row_sum(batch: GLMBatch, x, dim=None):
    """Σ over the rows of a per-row quantity ``x`` ((n,) or (n, G), or a
    `slot_map` result): the sum on one device; on a mesh batch one
    partial per local slot, for `reduce_rows` to close."""
    def total(t):
        return torch.sum(t) if dim is None else torch.sum(t, dim=dim)

    X = batch.X
    if isinstance(X, SlotRows):
        if not isinstance(x, SlotParts):
            s = X.rows_per_slot
            x = [x[k * s:(k + 1) * s] for k in range(X.mesh.n_local)]
        return SlotParts(total(t) for t in x)
    return total(x)


def reduce_rows(batch: GLMBatch, *parts) -> tuple:
    """Close an evaluation's row partials (`row_sum`s, Xᵀr passes, None
    leaves) with ONE reduction over the mesh; on one device they are the
    totals already."""
    X = batch.X
    if not isinstance(X, SlotRows):
        return parts
    return X.mesh.psum([tuple(None if p is None else p[k] for p in parts)
                        for k in range(X.mesh.n_local)])


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
        """∂z/∂w pulled back over a per-row cotangent g: f∘(Xᵀg − s·Σg)
        (one reduction on a mesh)."""
        return self._finish_backprop(
            *reduce_rows(batch, *self._backprop_parts(batch, g)))

    def _backprop_parts(self, batch: GLMBatch, g):
        """The pieces of `_backprop` that sum over rows: (Xᵀg, Σg), Σg only
        when a shift exists (None otherwise); per-slot partials on a
        mesh."""
        gsum = row_sum(batch, g) if self.norm_shifts is not None else None
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
        wl, wd = slot_map(batch, lambda za, y, wt, dz: (
            wt * loss(za, y), wt * d1(za, y) * dz), z + a * dz, batch.y,
            batch.weights, dz)
        f, dphi = reduce_rows(batch, row_sum(batch, wl), row_sum(batch, wd))
        c0, c1, c2 = coeffs
        return f + c0 + a * (c1 + 0.5 * a * c2), dphi + c1 + a * c2

    def value_at_margin(self, w, z, batch: GLMBatch):
        """f(w) from a cached margin — elementwise only, no pass over X."""
        loss, _, _ = loss_fns(self.task)
        wl = slot_map(batch, lambda z, y, wt: wt * loss(z, y), z, batch.y,
                      batch.weights)
        (value,) = reduce_rows(batch, row_sum(batch, wl))
        return value + self._reg_terms(w)[0]

    def grad_at_margin(self, w, z, batch: GLMBatch):
        """Full gradient from a cached margin — ONE pass over X (Xᵀr)."""
        _, d1, _ = loss_fns(self.task)
        r = slot_map(batch, lambda z, y, wt: wt * d1(z, y), z, batch.y,
                     batch.weights)
        return self._backprop(batch, r) + self._reg_terms(w)[1]

    def value_and_grad_at_margin(self, w, z, batch: GLMBatch):
        """(f, g) from a cached margin — one elementwise pass + one Xᵀr."""
        loss, d1, _ = loss_fns(self.task)
        r, wl = slot_map(batch, lambda z, y, wt: (
            wt * d1(z, y), wt * loss(z, y)), z, batch.y, batch.weights)
        gX, gsum = self._backprop_parts(batch, r)
        value, gX, gsum = reduce_rows(batch, row_sum(batch, wl), gX, gsum)
        gX = self._finish_backprop(gX, gsum)
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
        return row_sum(batch, batch.weights * loss(z, batch.y)), gX, gsum

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
        w2 = slot_map(batch, lambda z, y, wt: wt * d2(z, y),
                      self.margin(w, batch), batch.y, batch.weights)
        diag = sq_rmatvec(batch.X, w2)
        if self.norm_shifts is not None:
            s = self.norm_shifts
            diag, q, w2sum = reduce_rows(batch, diag, rmatvec(batch.X, w2),
                                         row_sum(batch, w2))
            diag = diag - 2.0 * s * q + s * s * w2sum
        else:
            (diag,) = reduce_rows(batch, diag)
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
        g = slot_map(batch, lambda z, y, wt, dz: wt * d2(z, y) * dz, z,
                     batch.y, batch.weights, dz_v)
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
        w2 = slot_map(batch, lambda z, y, wt: wt * d2(z, y),
                      self.margin(w, batch), batch.y, batch.weights)
        H = weighted_gram(batch.X, w2)
        if self.norm_shifts is not None:
            s = self.norm_shifts
            H, q, w2sum = reduce_rows(batch, H, rmatvec(batch.X, w2),
                                      row_sum(batch, w2))
            H = (H - torch.outer(s, q) - torch.outer(q, s)
                 + w2sum * torch.outer(s, s))
        else:
            (H,) = reduce_rows(batch, H)
        if self.norm_factors is not None:
            H = H * torch.outer(self.norm_factors, self.norm_factors)
        H = H + torch.diag(self._reg_parts()[0] * torch.ones_like(w))
        if self.prior_full_precision is not None:
            H = H + self.prior_full_precision
        return H
