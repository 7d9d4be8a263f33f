"""Margin-cached TRON over G regularization lanes in LANE-MINOR layout (port
of `_cg_step_geometry_lanes`, `_cg_trust_margin_lanes` and
`minimize_tron_margin_lanes` of `photon_tpu/optim/lane_tron.py`).

Reference parity: com.linkedin.photon.ml.optimization.TRON (LIBLINEAR's
tron.cpp) run once per grid point by the reference's sweep; here a TRON
sweep is one lock-step solver whose every Steihaug-CG Hessian-vector
product and trial-margin pass over X is shared by all lanes. Per lane, as
the scalar `optim.tron.minimize_tron_margin`: Gauss-Newton d2 on the
cached z (each CG HVP one lane-stacked Xᵀ pass, the direction's margin
reused from the CG state), the candidate step's margin accumulated beside
it (a rejected step costs no X pass), Hp from the CG residual.

The CG loop runs until every lane's subproblem ends (boundary hit or
residual tolerance) or ``max_cg`` steps, reading back one flag per step,
as the reference's loop condition; it does not run ``max_cg`` masked
steps. The outer loop reads back whether any lane accepted (an
all-rejected iteration pays no Xᵀ pass) and then its done flag. Trust
region acceptance and radius updates reuse `optim.tron`'s elementwise
`_tr_update` / `_tr_stops` on (G,) tensors.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.ops import lane_objective as lo
from photon_tpu_torch.optim.lane_lbfgs import _colnorm, _history_buffers
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.optim.tron import _tr_stops, _tr_update

_Z_REFRESH = 64  # as optim.tron: accept-chained margin re-derivation period


def _cg_step_geometry_lanes(p, dvec, Hd, rsq, delta):
    """Per-lane Steihaug step geometry (`optim.tron._cg_step_geometry` with
    column contractions): (step (G,), take_boundary (G,))."""
    dHd = torch.sum(dvec * Hd, dim=0)
    alpha = rsq / torch.clamp(dHd, min=1e-20)
    over = _colnorm(p + alpha[None, :] * dvec) >= delta
    pd = torch.sum(p * dvec, dim=0)
    dd = torch.sum(dvec * dvec, dim=0)
    pp = torch.sum(p * p, dim=0)
    rad = torch.sqrt(torch.clamp(pd * pd + dd * (delta * delta - pp),
                                 min=0.0))
    theta = (rad - pd) / torch.clamp(dd, min=1e-20)
    take_boundary = over | (dHd <= 0.0)
    return torch.where(take_boundary, theta, alpha), take_boundary


def _cg_trust_margin_lanes(obj, l2s, z, batch, g, delta, max_cg: int,
                           tol_factor=0.1, done0=None):
    """Lock-step per-lane Steihaug CG on the margin-cached Hessian:
    (p, zp, r, steps) — per-lane step, its margin, the final residual
    (Hp = -g - r for lanes whose subproblem ran) and the CG steps taken
    (one lane-stacked HVP each).

    ``done0``: outer-converged lanes, seeded as CG-done so a frozen lane's
    discarded subproblem cannot keep the loop running after every active
    lane has ended (a seeded lane returns p = 0, r = -g, so Hp = 0 and
    pred = 0: rejected, and the caller's step mask discards it anyway)."""
    cg_tol = tol_factor * _colnorm(g)
    p = torch.zeros_like(g)
    zp = torch.zeros_like(z)
    r = -g
    dvec = r
    dz = lo.direction_margin_lanes(obj, r, batch)
    rsq = torch.sum(r * r, dim=0)
    done = (torch.zeros_like(rsq, dtype=torch.bool) if done0 is None
            else done0)
    for it in range(max_cg):
        act = ~done
        Hd = lo.hvp_at_margin_lanes(obj, l2s, z, batch, dvec, dZv=dz)
        step, take_boundary = _cg_step_geometry_lanes(p, dvec, Hd, rsq,
                                                      delta)
        step = torch.where(act, step, 0.0)
        p = p + step[None, :] * dvec
        zp = zp + step[None, :] * dz
        r = torch.where(act[None, :], r - step[None, :] * Hd, r)
        rsq_new = torch.where(act, torch.sum(r * r, dim=0), rsq)
        small = torch.sqrt(rsq_new) <= cg_tol
        beta = rsq_new / torch.clamp(rsq, min=1e-20)
        dvec = torch.where(act[None, :], r + beta[None, :] * dvec, dvec)
        rsq = rsq_new
        done = done | (act & (take_boundary | small))
        if it + 1 == max_cg or bool(done.all()):  # sync: one flag a step
            return p, zp, r, it + 1
        # one shared X pass refreshes every continuing lane's dz
        dz = lo.direction_margin_lanes(obj, dvec, batch)
    return p, zp, r, 0


def minimize_tron_margin_lanes(obj, l2s, batch, W0, max_iters: int = 100,
                               tolerance: float = 1e-7,
                               cg_max_iters: int = 20) -> OptResult:
    """Lock-step lane-minor margin-cached TRON; same return convention as
    `optim.lane_lbfgs.minimize_lbfgs_margin_lanes`, with ``hvps`` the
    lane-stacked CG steps (two shared X passes each, less the one a
    terminating step skips)."""
    W = W0.to(torch.float32).contiguous()
    d, G = W.shape
    dtype, dev = W.dtype, W.device
    z = lo.margin_lanes(obj, W, batch)
    f, g = lo.value_and_grad_at_margin_lanes(obj, l2s, W, z, batch)
    g0norm = _colnorm(g)
    hist, ghist = _history_buffers(f, g0norm, max_iters)
    delta = torch.clamp(g0norm, min=1.0).to(dtype)
    its = torch.zeros((G,), dtype=torch.int32, device=dev)
    done = g0norm <= 1e-14
    converged = done.clone()
    failed = torch.zeros((G,), dtype=torch.bool, device=dev)
    it = hvps = 0

    while it < max_iters and not bool(done.all()):  # sync: one flag
        active = ~done
        p, zp, r, n_hv = _cg_trust_margin_lanes(obj, l2s, z, batch, g, delta,
                                                cg_max_iters, done0=done)
        hvps += n_hv
        Hp = -g - r
        pred = -(torch.sum(g * p, dim=0) + 0.5 * torch.sum(p * Hp, dim=0))
        z_try = z + zp
        f_try = lo.value_at_margin_lanes(obj, l2s, W + p, z_try, batch)
        accept, actual, delta_new = _tr_update(f, f_try, pred, _colnorm(p),
                                               delta)
        step = active & accept
        W_new = torch.where(step[None, :], W + p, W)
        z_new = torch.where(step[None, :], z_try, z)
        if (it + 1) % _Z_REFRESH == 0:
            z_new = lo.margin_lanes(obj, W_new, batch)
        f_new = torch.where(step, f_try, f)
        if bool(step.any()):  # sync: an all-rejected step skips Xᵀr
            g_new = torch.where(
                step[None, :],
                lo.grad_at_margin_lanes(obj, l2s, W_new, z_new, batch), g)
        else:
            g_new = g

        gnorm = _colnorm(g_new)
        conv, stuck = _tr_stops(accept, actual, pred, f, f_new, gnorm,
                                g0norm, delta_new, tolerance, dtype)
        it += 1
        its = torch.where(active, its + 1, its)
        delta = torch.where(active, delta_new, delta)
        done = done | (active & (conv | stuck))
        converged = torch.where(active, conv, converged)
        failed = failed | (active & stuck & ~conv)
        hist[it] = torch.where(active, f_new, hist[it])
        ghist[it] = torch.where(active, gnorm, ghist[it])
        W, z, f, g = W_new, z_new, f_new, g_new

    return OptResult(w=W, value=f, grad_norm=_colnorm(g), iterations=its,
                     converged=converged, failed=failed, loss_history=hist,
                     grad_norm_history=ghist, hvps=hvps)
