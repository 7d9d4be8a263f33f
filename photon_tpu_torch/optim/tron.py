"""TRON, trust-region Newton with a Steihaug conjugate-gradient subproblem
(port of `_cg_step_geometry`, `_cg_trust`, `_tr_update`, `_tr_stops`, the
generic `minimize_tron`, `_cg_trust_margin` and `minimize_tron_margin` of
`photon_tpu/optim/tron.py`).

Reference parity: com.linkedin.photon.ml.optimization.TRON (LIBLINEAR's
tron.cpp; Lin, Weng, Keerthi 2008), with its constants: eta0 = 1e-4
(acceptance), sigma1 = 0.25, sigma2 = 0.5, sigma3 = 4.

The reference's `lax.while_loop`s become Python loops on the host. The CG
loop reads its done flag back once per step (and skips the next
direction's X pass when it stops), as the L-BFGS loop reads once per
iteration; the outer loop reads back whether the step was accepted (a
rejected step pays no Xᵀr pass, as the reference's `lax.cond`) and then
its done flag (with the telemetry tap armed, f, |g| and the trust radius
ride in that read: `telemetry.taps`). The generic `minimize_tron` takes
a ``value_and_grad`` closure and an ``hvp_at(w, v)`` closure, and reads
back the same flags.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.checkpoint.taps import snapshot_tap
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.telemetry.taps import solver_tap, tap_enabled

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0
# Refresh the accept-chained margin from w every this many iterations (f32
# drift bound), as the reference.
_Z_REFRESH = 64


def _cg_step_geometry(p, dvec, Hd, rsq, delta):
    """One Steihaug step's geometry: (step, take_boundary) — the CG step
    length, or the step to the trust-region boundary along dvec on
    overshoot or non-positive curvature; p_new = p + step·dvec either
    way."""
    dHd = torch.dot(dvec, Hd)
    alpha = rsq / torch.clamp(dHd, min=1e-20)
    over = torch.linalg.vector_norm(p + alpha * dvec) >= delta
    pd = torch.dot(p, dvec)
    dd = torch.dot(dvec, dvec)
    pp = torch.dot(p, p)
    rad = torch.sqrt(torch.clamp(pd * pd + dd * (delta * delta - pp),
                                 min=0.0))
    theta = (rad - pd) / torch.clamp(dd, min=1e-20)
    take_boundary = over | (dHd <= 0.0)
    return torch.where(take_boundary, theta, alpha), take_boundary


def _tr_update(f, f_try, pred, pnorm, delta):
    """Trust-region acceptance and radius update: (accept, actual,
    delta_new). A non-finite trial is a hard rejection (rho = -inf
    shrinks the radius; a NaN rho would grow it)."""
    actual = f - f_try
    rho = torch.where(torch.isfinite(f_try) & (pred > 0.0),
                      actual / torch.clamp(pred, min=1e-20),
                      torch.full_like(actual, float("-inf")))
    accept = rho > ETA0
    delta_new = torch.where(
        rho < ETA1,
        torch.clamp(SIGMA1 * torch.minimum(pnorm, delta), min=1e-12),
        torch.where(rho < ETA2, delta, torch.clamp(SIGMA3 * delta,
                                                   max=1e10)))
    return accept, actual, delta_new


def _tr_stops(accept, actual, pred, f_old, f_new, gnorm, g0norm, delta_new,
              tolerance, dtype):
    """(converged, stuck): gradient tolerance, relative-f progress on
    accepted steps, LIBLINEAR's precision-limited stop (predicted
    reduction below the f32 noise floor), and the radius collapsing with
    no acceptance."""
    grad_conv = gnorm <= tolerance * torch.clamp(g0norm, min=1.0)
    f_conv = accept & (torch.abs(actual) <= tolerance * torch.clamp(
        torch.maximum(torch.abs(f_old), torch.abs(f_new)), min=1e-12))
    noise = 4.0 * torch.finfo(dtype).eps * torch.clamp(torch.abs(f_old),
                                                       min=1.0)
    precision_limited = ~accept & (pred <= noise)
    stuck = ~accept & (delta_new <= 1e-12)
    return grad_conv | f_conv | precision_limited, stuck


def _cg_trust(hvp, g, delta, max_cg: int, tol_factor=0.1):
    """Steihaug CG: approximately solve H p = -g subject to |p| <= delta.
    Returns (p, HVPs made)."""
    cg_tol = tol_factor * torch.linalg.vector_norm(g)
    p = torch.zeros_like(g)
    r = -g
    dvec = r
    rsq = torch.dot(r, r)
    for it in range(max_cg):
        Hd = hvp(dvec)
        step, take_boundary = _cg_step_geometry(p, dvec, Hd, rsq, delta)
        p = p + step * dvec
        r = r - step * Hd
        rsq_new = torch.dot(r, r)
        small = torch.sqrt(rsq_new) <= cg_tol
        dvec = r + rsq_new / torch.clamp(rsq, min=1e-20) * dvec
        rsq = rsq_new
        if it + 1 == max_cg or bool(take_boundary | small):  # sync
            return p, it + 1
    return p, 0


def minimize_tron(value_and_grad, hvp_at, w0: torch.Tensor,
                  max_iters: int = 100, tolerance: float = 1e-7,
                  cg_max_iters: int = 20) -> OptResult:
    """TRON over closures: ``value_and_grad(w) -> (f, g)`` and
    ``hvp_at(w, v) -> H(w) v``, with the reference's trust-region rules.
    Each iteration evaluates f and g once at the trial point and makes
    the CG's HVPs plus one for the predicted reduction."""
    w = w0 if w0.is_floating_point() else w0.float()
    dtype, dev = w.dtype, w.device
    f, g = value_and_grad(w)
    evals = 1
    g0norm = torch.linalg.vector_norm(g)
    hist = torch.full((max_iters + 1,), float("nan"), dtype=dtype,
                      device=dev)
    ghist = hist.clone()
    hist[0] = f
    ghist[0] = g0norm
    delta = torch.clamp(g0norm, min=1.0).to(dtype)
    converged = g0norm <= 1e-14
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    done = bool(converged)  # sync
    it = hvps = 0

    while not done and it < max_iters:
        p, n_hv = _cg_trust(lambda v, w=w: hvp_at(w, v), g, delta,
                            cg_max_iters)
        Hp = hvp_at(w, p)
        hvps += n_hv + 1
        pred = -(torch.dot(g, p) + 0.5 * torch.dot(p, Hp))
        f_try, g_try = value_and_grad(w + p)
        evals += 1
        accept, actual, delta_new = _tr_update(
            f, f_try, pred, torch.linalg.vector_norm(p), delta)
        w_new = torch.where(accept, w + p, w)
        f_new = torch.where(accept, f_try, f)
        g_new = torch.where(accept, g_try, g)
        gnorm = torch.linalg.vector_norm(g_new)
        converged, stuck = _tr_stops(accept, actual, pred, f, f_new, gnorm,
                                     g0norm, delta_new, tolerance, dtype)
        failed = failed | (stuck & ~converged)
        it += 1
        hist[it] = f_new
        ghist[it] = gnorm
        done = bool(converged | stuck)  # sync
        w, f, g, delta = w_new, f_new, g_new, delta_new

    return OptResult(
        w=w, value=f, grad_norm=torch.linalg.vector_norm(g), iterations=it,
        converged=converged, failed=failed, loss_history=hist,
        grad_norm_history=ghist, evaluations=evals, hvps=hvps)


def _cg_trust_margin(obj, w, z, batch, g, delta, max_cg: int,
                     tol_factor=0.1):
    """Steihaug CG over the margin-cached Hessian: (p, zp, r, hvps). zp,
    the step's margin, accumulates from the dz vectors the HVPs need
    anyway, and r = -g - Hp is the final residual, so the caller gets the
    trial margin and Hp with no extra pass over X."""
    cg_tol = tol_factor * torch.linalg.vector_norm(g)
    p = torch.zeros_like(g)
    zp = torch.zeros_like(z)
    r = -g
    dvec = r
    dz = obj.direction_margin(r, batch)
    rsq = torch.dot(r, r)
    for it in range(max_cg):
        Hd = obj.hvp_at_margin(w, z, batch, dvec, dz_v=dz)
        step, take_boundary = _cg_step_geometry(p, dvec, Hd, rsq, delta)
        p = p + step * dvec
        zp = zp + step * dz
        r = r - step * Hd
        rsq_new = torch.dot(r, r)
        small = torch.sqrt(rsq_new) <= cg_tol
        beta = rsq_new / torch.clamp(rsq, min=1e-20)
        dvec = r + beta * dvec
        rsq = rsq_new
        if it + 1 == max_cg or bool(take_boundary | small):  # sync
            return p, zp, r, it + 1
        dz = obj.direction_margin(dvec, batch)  # the next HVP's X pass
    return p, zp, r, 0


def minimize_tron_margin(obj, batch, w0: torch.Tensor, max_iters: int = 100,
                         tolerance: float = 1e-7,
                         cg_max_iters: int = 20) -> OptResult:
    """TRON over a GLM objective with a CACHED margin: each CG HVP is two
    X passes, the trial f(w + p) is elementwise on z + zp (a rejected
    step costs no pass over X), and Hp for the predicted reduction comes
    from the CG residual (Hp = -g - r)."""
    w = w0 if w0.is_floating_point() else w0.float()
    dtype, dev = w.dtype, w.device
    z = obj.margin(w, batch)
    f, g = obj.value_and_grad_at_margin(w, z, batch)
    g0norm = torch.linalg.vector_norm(g)
    hist = torch.full((max_iters + 1,), float("nan"), dtype=dtype,
                      device=dev)
    ghist = hist.clone()
    hist[0] = f
    ghist[0] = g0norm
    delta = torch.clamp(g0norm, min=1.0).to(dtype)
    converged = g0norm <= 1e-14
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    tap = tap_enabled()
    if tap:  # the tap's values ride the start's one read-back
        conv0, f0v, g0v = torch.stack(
            [converged.to(dtype), f.to(dtype), g0norm]).tolist()  # sync
        done = bool(conv0)
        solver_tap("tron_margin", 0, f0v, g0v)
    else:
        done = bool(converged)
    it = hvps = 0

    while not done and it < max_iters:
        p, zp, r, n_hv = _cg_trust_margin(obj, w, z, batch, g, delta,
                                          cg_max_iters)
        hvps += n_hv
        Hp = -g - r
        pred = -(torch.dot(g, p) + 0.5 * torch.dot(p, Hp))
        z_try = z + zp
        f_try = obj.value_at_margin(w + p, z_try, batch)  # elementwise
        accept, actual, delta_new = _tr_update(
            f, f_try, pred, torch.linalg.vector_norm(p), delta)

        accepted = bool(accept)  # sync: a rejected step skips Xᵀr
        w_new = w + p if accepted else w
        z_new = z_try if accepted else z
        if (it + 1) % _Z_REFRESH == 0:
            z_new = obj.margin(w_new, batch)
        f_new = f_try if accepted else f
        g_new = obj.grad_at_margin(w_new, z_new, batch) if accepted else g

        gnorm = torch.linalg.vector_norm(g_new)
        converged, stuck = _tr_stops(accept, actual, pred, f, f_new, gnorm,
                                     g0norm, delta_new, tolerance, dtype)
        failed = failed | (stuck & ~converged)
        it += 1
        hist[it] = f_new
        ghist[it] = gnorm
        snapshot_tap("tron_margin", it, w_new, f_new, gnorm, aux=delta_new)
        if tap:  # f, |g| and the trust radius ride the done flag's read
            done, fv, gv, dv = torch.stack([
                (converged | stuck).to(dtype), f_new.to(dtype), gnorm,
                delta_new.to(dtype)]).tolist()  # sync
            done = bool(done)
            solver_tap("tron_margin", it, fv, gv, dv)
        else:
            done = bool(converged | stuck)  # sync
        w, z, f, g, delta = w_new, z_new, f_new, g_new, delta_new

    return OptResult(
        w=w, value=f, grad_norm=torch.linalg.vector_norm(g), iterations=it,
        converged=converged, failed=failed, loss_history=hist,
        grad_norm_history=ghist, hvps=hvps)
