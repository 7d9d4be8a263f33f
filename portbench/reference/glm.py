"""Plain PyTorch reference of an L2-regularized logistic-regression grid,
one lane per L2 weight: the objective and its gradient, the first L-BFGS
iteration with its strong-Wolfe line search (Nocedal and Wright,
Numerical Optimization, algorithms 3.5 and 3.6), and the L-BFGS direction
over a history of (s, y) pairs (their algorithm 7.4).

It builds its own sparse matrix from the generated COO rows and imports
nothing of the program. It computes in float64. The configuration states
one precision below that for the hot block: its columns' operands (the
coefficients on a product, the residual on a transpose product) are
rounded to bfloat16 before the product, as the program's storage
precision makes them; ``hot_columns`` names those columns (the
``d_dense`` most frequent ones), and the reference rounds the same.

The objective of lane j is sum_i [softplus(z_i) - y_i z_i] + l2_j/2 |w|^2,
every coefficient regularized, z = X w.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

C1, C2 = 1e-4, 0.9   # sufficient decrease, curvature
MAX_EVALS = 12       # line-search trials an iteration
F64 = torch.float64


def hot_columns(indices: torch.Tensor, values: torch.Tensor,
                n_features: int, d_dense: int) -> torch.Tensor:
    """(n_features,) bool: the ``d_dense`` columns with the most stored
    nonzeros (ties to the lower column id)."""
    live = values != 0
    counts = torch.bincount(indices[live].long(), minlength=n_features)
    # a stable sort on -count keeps ties in column order
    order = torch.sort(-counts, stable=True).indices
    mask = torch.zeros(n_features, dtype=torch.bool, device=counts.device)
    mask[order[:min(d_dense, n_features)]] = True
    return mask


class Matrix:
    """X as float64 CSR matrices (hot columns and the rest) and their
    transposes, on the device of the padded COO rows it is built from
    (duplicates summed)."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 n_features: int, hot_mask: torch.Tensor):
        n, k = indices.shape
        self.shape = (n, n_features)
        self.device = indices.device
        self.hot_mask = hot_mask
        live = values != 0
        rows = torch.arange(n, device=self.device)[:, None].expand(n, k)[live]
        cols = indices[live].long()
        vals = values[live].to(F64)
        del live
        on_hot = hot_mask[cols]
        self.parts = [self._csr_pair(rows[sel], cols[sel], vals[sel])
                      for sel in (on_hot, ~on_hot)]

    def _csr_pair(self, rows, cols, vals):
        n, d = self.shape
        warnings.filterwarnings("ignore", "Sparse", UserWarning)
        fwd = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                      (n, d)).coalesce().to_sparse_csr()
        bwd = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                      (d, n)).coalesce().to_sparse_csr()
        return fwd, bwd

    def matvec(self, W):
        """X W for (d, G) W, the hot columns' operand in bfloat16."""
        hot = torch.where(self.hot_mask[:, None],
                          W.to(torch.bfloat16).to(F64), 0.0)
        cold = torch.where(self.hot_mask[:, None], 0.0, W)
        return self.parts[0][0] @ hot + self.parts[1][0] @ cold

    def rmatvec(self, R):
        """X^T R for (n, G) R, the hot columns taking R in bfloat16."""
        hot = self.parts[0][1] @ R.to(torch.bfloat16).to(F64)
        cold = self.parts[1][1] @ R
        return torch.where(self.hot_mask[:, None], hot, cold)


def _loss_terms(z, y):
    return torch.logaddexp(z, torch.zeros_like(z)) - y[:, None] * z


def objective(M: Matrix, y, l2s, W):
    """(f (G,), g (d, G), z (n, G)) at W (d, G)."""
    z = M.matvec(W)
    f = _loss_terms(z, y).sum(0) + 0.5 * l2s * (W * W).sum(0)
    r = torch.sigmoid(z) - y[:, None]
    g = M.rmatvec(r) + l2s[None, :] * W
    return f, g, z


def gradient_at(M: Matrix, y, l2s, z, W):
    """The gradient (d, G) at W (d, G), from given margins z (n, G)."""
    r = torch.sigmoid(z.to(F64)) - y[:, None]
    return M.rmatvec(r) + l2s[None, :] * W


def _cubic_min(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi):
    """Minimizer of the cubic through both ends (N&W eq. 3.59); bisection
    when it is degenerate or within 10% of an end."""
    span = a_hi - a_lo
    d1 = d_lo + d_hi - 3.0 * (f_lo - f_hi) / (-span if span != 0 else 1.0)
    disc = d1 * d1 - d_lo * d_hi
    d2 = np.sign(span) * np.sqrt(max(disc, 0.0))
    denom = d_hi - d_lo + 2.0 * d2
    a_c = a_hi - span * (d_hi + d2 - d1) / (denom if denom != 0 else 1.0)
    lo_m, hi_m = a_lo + 0.1 * span, a_hi - 0.1 * span
    inside = (lo_m <= a_c <= hi_m) if span > 0 else (hi_m <= a_c <= lo_m)
    if disc >= 0 and denom != 0 and np.isfinite(a_c) and inside:
        return a_c
    return 0.5 * (a_lo + a_hi)


def wolfe_search(phi, f0: float, g0: float, a: float):
    """Strong-Wolfe step along a descent ray: ``phi(a) -> (f, f')``.
    Returns (a, f(a), ok); ok is False when no trial met the conditions
    and none decreased f (then a is 0)."""
    prev = (0.0, f0, g0)
    lo = hi = None
    best = (0.0, f0)
    zoom = False
    for i in range(MAX_EVALS):
        f, d = phi(a)
        bad = not np.isfinite(f)
        armijo = (not bad) and f <= f0 + C1 * a * g0
        curv = abs(d) <= -C2 * g0
        if armijo and f < best[1]:
            best = (a, f)
        if not zoom:
            if bad or not armijo or (i > 0 and f >= prev[1]):
                lo, hi, zoom = prev, (a, f, d), True
            elif curv:
                return a, f, True
            elif d >= 0:
                lo, hi, zoom = (a, f, d), prev, True
            else:
                prev = (a, f, d)
                a = 2.0 * a
                continue
        else:
            if bad or not armijo or f >= lo[1]:
                hi = (a, f, d)
            elif curv:
                return a, f, True
            else:
                if d * (hi[0] - lo[0]) >= 0:
                    hi = lo
                lo = (a, f, d)
        prev = (a, f, d)
        if np.isfinite(hi[1]) and np.isfinite(hi[2]):
            a = _cubic_min(*lo, *hi)
        else:
            a = 0.5 * (lo[0] + hi[0])
    return best[0], best[1], best[0] > 0.0


def direction(g, pairs):
    """-H g per lane, float64, for g (d, G) and ``pairs`` [(s, y, taken)],
    oldest first: each (d, G) pair in any float dtype, taken into float64
    where it is used, and ``taken`` (G,) whether the solver stepped in that
    lane. A lane keeps a pair where it stepped and sᵀy > 1e-10 yᵀy; its
    scale comes from its newest kept pair (1 without one)."""
    q = g.to(F64)
    kept = []
    for s, yv, taken in pairs:
        s64, y64 = s.to(F64), yv.to(F64)
        sy, yy = (s64 * y64).sum(0), (y64 * y64).sum(0)
        ok = taken & (sy > 1e-10 * torch.clamp(yy, min=1e-20))
        kept.append((torch.where(ok, 1.0 / sy, 0.0), sy / yy, ok))
    alphas = []
    for (s, yv, _), (rho, _, _) in zip(reversed(pairs), reversed(kept)):
        al = rho * (s.to(F64) * q).sum(0)
        q = q - al[None, :] * yv.to(F64)
        alphas.append(al)
    gamma = torch.ones_like(q[0])
    found = torch.zeros_like(q[0], dtype=torch.bool)
    for _, scale, ok in reversed(kept):
        gamma = torch.where(ok & ~found, scale, gamma)
        found |= ok
    r = gamma[None, :] * q
    for (s, yv, _), (rho, _, _), al in zip(pairs, kept, reversed(alphas)):
        be = rho * (yv.to(F64) * r).sum(0)
        r = r + (al - be)[None, :] * s.to(F64)
    return -r


def first_step(M: Matrix, y, l2s):
    """The first L-BFGS iteration from zero for every lane: the steepest
    descent ray, scaled to unit length, and its strong-Wolfe step. Returns
    a dict: ``loss`` (2, G), the losses at iterations 0 and 1, and
    ``gnorm0`` (G,), the first gradient's norm, as host arrays."""
    dev = M.device
    y = y.to(dev, F64)
    l2s = torch.as_tensor(l2s, dtype=F64, device=dev)
    W = torch.zeros((M.shape[1], l2s.shape[0]), dtype=F64, device=dev)
    f, g, z = objective(M, y, l2s, W)
    gnorm0 = torch.linalg.vector_norm(g, dim=0)
    D = -g
    slope = -(g * g).sum(0)
    dz = M.matvec(D)
    a0 = 1.0 / torch.clamp(gnorm0, min=1.0)
    f1 = f.clone()
    for j in range(l2s.shape[0]):
        zj, dzj, lj = z[:, j], dz[:, j], float(l2s[j])
        dd = float((D[:, j] * D[:, j]).sum())

        def phi(a, zj=zj, dzj=dzj, lj=lj, dd=dd):
            za = zj + a * dzj
            fa = (torch.logaddexp(za, torch.zeros_like(za))
                  - y * za).sum() + 0.5 * lj * a * a * dd
            da = ((torch.sigmoid(za) - y) * dzj).sum() + lj * a * dd
            return float(fa), float(da)

        a, fa, ok = wolfe_search(phi, float(f[j]), float(slope[j]),
                                 float(a0[j]))
        if ok:
            f1[j] = fa
    return dict(loss=torch.stack([f, f1]).cpu().numpy(),
                gnorm0=gnorm0.cpu().numpy())
