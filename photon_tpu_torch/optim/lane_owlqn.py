"""OWL-QN over G regularization lanes in LANE-MINOR layout (port of
`pseudo_gradient_lanes` and `minimize_owlqn_lanes` of
`photon_tpu/optim/lane_owlqn.py`).

Reference parity: com.linkedin.photon.ml.optimization.OWLQN run once per
grid point by the reference's sweep (its forced optimizer for any L1
term). Like `optim.lane_lbfgs`, the sweep is one lock-step solver with a
trailing lane axis:

- the backtracking Armijo search runs lock-step with sticky per-lane
  success (a successful lane keeps its step while the rest keep halving);
  it stops where the reference's loop stops — once every live lane has
  succeeded, or after ``max_ls_evals`` trials — reading back one flag
  after each trial but the last;
- the orthant projection breaks margin linearity, so each trial pays one
  SHARED margin pass ``margin_lanes(W_try)`` for all lanes; the accepted
  lane's trial margin is carried out of the search, so the outer step
  adds only the gradient's Xᵀ pass;
- the (s, y) history is `optim.lane_lbfgs.LaneHistory`: a rotating slot,
  per-(slot, lane) validity, cached f32 sᵀy / yᵀy, optional bf16 storage.

The outer loop reads back one flag per iteration (is every lane done).
"""
from __future__ import annotations

import torch

from photon_tpu_torch.ops import lane_objective as lo
from photon_tpu_torch.optim.lane_lbfgs import (LaneHistory, _colnorm,
                                               _history_buffers)
from photon_tpu_torch.optim.tracker import OptResult

_C1 = 1e-4  # Armijo constant of the projected search


def pseudo_gradient_lanes(W, g, l1s, mask):
    """∂F selection per lane: where W_dj = 0, the one-sided derivative
    closest to 0 (Andrew & Gao). W/g: (d, G); l1s: (G,); mask: (d,) or
    the scalar 1.0."""
    if isinstance(mask, torch.Tensor) and mask.dim():
        lam = mask[:, None] * l1s[None, :]
    else:
        lam = mask * l1s[None, :]
    right = g + lam
    left = g - lam
    zero = torch.zeros_like(g)
    pg_zero = torch.where(right < 0.0, right,
                          torch.where(left > 0.0, left, zero))
    return torch.where(W != 0.0, g + lam * torch.sign(W), pg_zero)


def minimize_owlqn_lanes(obj, l2s, l1s, batch, W0, max_iters: int = 100,
                         tolerance: float = 1e-7, history: int = 10,
                         max_ls_evals: int = 20, reg_mask=None,
                         history_dtype=None) -> OptResult:
    """Lock-step lane-minor OWL-QN of F = f + l1s·|W|₁ per lane (f the
    smooth part, L2 weights ``l2s``); same return convention as
    `optim.lane_lbfgs.minimize_lbfgs_margin_lanes`, with ``trials`` the
    backtracking trials (one shared margin pass each)."""
    W = W0.to(torch.float32).contiguous()
    d, G = W.shape
    dtype, dev = W.dtype, W.device
    mask = 1.0 if reg_mask is None else reg_mask.to(device=dev, dtype=dtype)

    def l1_term(W):
        absw = torch.abs(W) if reg_mask is None else mask[:, None] * \
            torch.abs(W)
        return l1s * torch.sum(absw, dim=0)

    z = lo.margin_lanes(obj, W, batch)
    f, g = lo.value_and_grad_at_margin_lanes(obj, l2s, W, z, batch)
    F = f + l1_term(W)
    pg0norm = _colnorm(pseudo_gradient_lanes(W, g, l1s, mask))
    hist, ghist = _history_buffers(F, pg0norm, max_iters)
    H = LaneHistory(history, d, G, history_dtype or dtype, dev)
    its = torch.zeros((G,), dtype=torch.int32, device=dev)
    done = pg0norm <= 1e-14
    converged = done.clone()
    failed = torch.zeros((G,), dtype=torch.bool, device=dev)
    it = trials = 0
    eps = torch.finfo(dtype).eps

    while it < max_iters and not bool(done.all()):  # sync: one flag
        active = ~done
        pg = pseudo_gradient_lanes(W, g, l1s, mask)
        D = H.direction(pg)
        D = torch.where(D * pg < 0.0, D, 0.0)  # orthant-constrained p_k
        dphi0 = torch.sum(D * pg, dim=0)
        bad_dir = dphi0 >= 0.0
        D = torch.where(bad_dir[None, :], -pg, D)
        dphi0 = torch.where(bad_dir, -torch.sum(pg * pg, dim=0), dphi0)
        xi = torch.where(W != 0.0, torch.sign(W), torch.sign(-pg))

        def project(V):
            return torch.where(V * xi > 0.0, V, 0.0)

        a = torch.where(H.has_pairs(), 1.0,
                        1.0 / torch.clamp(_colnorm(D), min=1.0))
        F_acc, z_acc = F, z
        succ = torch.zeros((G,), dtype=torch.bool, device=dev)
        for i in range(max_ls_evals):
            W_try = project(W + a[None, :] * D)
            z_try = lo.margin_lanes(obj, W_try, batch)  # shared X pass
            F_try = (lo.value_at_margin_lanes(obj, l2s, W_try, z_try, batch)
                     + l1_term(W_try))
            dec = torch.sum(pg * (W_try - W), dim=0)
            ok_now = (F_try <= F + _C1 * dec) & (dec < 0.0) \
                & torch.isfinite(F_try)
            moved = ~succ & active  # lanes this trial probed
            acc = moved & ok_now
            a = torch.where(moved & ~ok_now, 0.5 * a, a)
            F_acc = torch.where(acc, F_try, F_acc)
            z_acc = torch.where(acc[None, :], z_try, z_acc)
            succ = succ | acc
            trials += 1
            if i + 1 < max_ls_evals \
                    and not bool((~succ & active).any()):  # sync: one flag
                break

        step = active & succ
        W_new = torch.where(step[None, :], project(W + a[None, :] * D), W)
        # the accepted margins came from the search: one Xᵀ pass
        z_new = torch.where(step[None, :], z_acc, z)
        f_new, g_new = lo.value_and_grad_at_margin_lanes(obj, l2s, W_new,
                                                         z_new, batch)
        f_new = torch.where(step, f_new, f)
        g_new = torch.where(step[None, :], g_new, g)
        F_new = torch.where(step, F_acc, F)
        H.push(W_new - W, g_new - g, step)

        pgnorm = _colnorm(pseudo_gradient_lanes(W_new, g_new, l1s, mask))
        grad_conv = pgnorm <= tolerance * torch.clamp(pg0norm, min=1.0)
        f_conv = succ & (torch.abs(F - F_new) <= tolerance * torch.clamp(
            torch.maximum(torch.abs(F), torch.abs(F_new)), min=1e-12))
        noise = 4.0 * eps * torch.clamp(torch.abs(F), min=1.0)
        precision_limited = ~succ & (torch.abs(dphi0) <= noise)
        conv = grad_conv | f_conv | precision_limited

        it += 1
        its = torch.where(active, its + 1, its)
        done = done | (active & (conv | ~succ))
        converged = torch.where(active, conv, converged)
        failed = failed | (active & ~succ & ~conv)
        hist[it] = torch.where(active, F_new, hist[it])
        ghist[it] = torch.where(active, pgnorm, ghist[it])
        W, z, f, F, g = W_new, z_new, f_new, F_new, g_new

    pg = pseudo_gradient_lanes(W, g, l1s, mask)
    return OptResult(w=W, value=F, grad_norm=_colnorm(pg), iterations=its,
                     converged=converged, failed=failed, loss_history=hist,
                     grad_norm_history=ghist, trials=trials)
