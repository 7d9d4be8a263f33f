"""OWL-QN for L1-regularized objectives (port of `pseudo_gradient` and
`minimize_owlqn` of `photon_tpu/optim/owlqn.py`).

Reference parity: com.linkedin.photon.ml.optimization.OWLQN (Breeze's
OWLQN; Andrew & Gao 2007). The smooth part f comes from the objective;
the solver owns the L1 term λ Σ m_j |w_j| (the mask m leaves the
intercept out), as Breeze's OWLQN does.

The reference's `lax.while_loop`s become Python loops on the host over
device tensors. The projected backtracking search stops at its FIRST
accepted trial, as the reference's inner while_loop does: the orthant
projection makes the margin non-linear in the step, so every trial is a
full evaluation of f and its gradient (one pass over X through the fused
kernel on dense X), and running all ``max_ls_evals`` trials masked, as
the L-BFGS line search runs its elementwise ones, would multiply the X
traffic up to twenty-fold. The price is one scalar read-back per trial,
plus one per iteration for the done flag and the curvature test.

The accepted trial's (f, g) are kept rather than evaluated again at the
same point (the reference's ``value_and_grad(w_new)`` after its search):
w_new is bit for bit the accepted w_try, and the objective is
deterministic, so the solve's history does not change. A search that
fails leaves w, f and g as they were, so it needs no evaluation either.

With the telemetry tap armed (`telemetry.taps`), F, |pg| and the step
ride in the iteration's one flag read-back; no read-back is added.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_tpu_torch.checkpoint.taps import snapshot_tap
from photon_tpu_torch.optim.lbfgs import _curvature, _push, two_loop
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.telemetry.taps import solver_tap, tap_enabled

_C1 = 1e-4  # Armijo constant of the projected search


def pseudo_gradient(w, g, l1, mask):
    """∂F selection for F = f + λ|w|₁: at w_j = 0 the one-sided
    derivative closest to 0."""
    lam = l1 * mask
    right = g + lam
    left = g - lam
    zero = torch.zeros_like(g)
    pg_zero = torch.where(right < 0.0, right,
                          torch.where(left > 0.0, left, zero))
    return torch.where(w != 0.0, g + lam * torch.sign(w), pg_zero)


def minimize_owlqn(value_and_grad: Callable, w0: torch.Tensor,
                   l1_weight: float, max_iters: int = 100,
                   tolerance: float = 1e-7, history: int = 10,
                   max_ls_evals: int = 20,
                   reg_mask: Optional[torch.Tensor] = None) -> OptResult:
    """Minimize f(w) + λ Σ m_j |w_j|; ``value_and_grad`` gives the smooth
    part's (f, g)."""
    w = w0 if w0.is_floating_point() else w0.float()
    dtype, dev = w.dtype, w.device
    d, m = w.shape[0], history
    mask = (torch.ones_like(w) if reg_mask is None
            else reg_mask.to(device=dev, dtype=dtype))
    evals = 0

    def evaluate(v):
        nonlocal evals
        evals += 1
        return value_and_grad(v)

    def l1_term(v):
        return l1_weight * torch.sum(mask * torch.abs(v))

    f, g = evaluate(w)
    F = f + l1_term(w)
    pg0norm = torch.linalg.vector_norm(pseudo_gradient(w, g, l1_weight,
                                                       mask))
    hist = torch.full((max_iters + 1,), float("nan"), dtype=dtype,
                      device=dev)
    ghist = hist.clone()
    hist[0] = F
    ghist[0] = pg0norm
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    sy = yy = torch.zeros((), dtype=dtype, device=dev)
    idx = count = it = 0
    converged = pg0norm <= 1e-14
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    tap = tap_enabled()
    if tap:  # the tap's values ride the start's one read-back
        conv0, F0v, pg0v = torch.stack(
            [converged.to(dtype), F.to(dtype), pg0norm]).tolist()  # sync
        done = bool(conv0)
        solver_tap("owlqn", 0, F0v, pg0v)
    else:
        done = bool(converged)

    while not done and it < max_iters:
        pg = pseudo_gradient(w, g, l1_weight, mask)
        direction = -two_loop(pg, S, Y, rho, idx, count, sy, yy)
        # keep the components that agree in sign with -pg (Andrew & Gao)
        direction = torch.where(direction * pg < 0.0, direction,
                                torch.zeros_like(direction))
        dphi0 = torch.dot(direction, pg)
        bad_dir = dphi0 >= 0.0
        direction = torch.where(bad_dir, -pg, direction)
        dphi0 = torch.where(bad_dir, -torch.dot(pg, pg), dphi0)
        # the orthant: sign(w), or sign(-pg) where w = 0
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

        a = (torch.ones((), dtype=dtype, device=dev) if count > 0 else
             1.0 / torch.clamp(torch.linalg.vector_norm(direction), min=1.0))
        ok = False
        for _ in range(max_ls_evals):
            step = w + a * direction  # projected onto the orthant
            w_try = torch.where(step * xi > 0.0, step, torch.zeros_like(w))
            f_try, g_try = evaluate(w_try)
            F_try = f_try + l1_term(w_try)
            # Armijo on F with the projected step (Andrew & Gao eq. 5)
            dec = torch.dot(pg, w_try - w)
            ok = bool((F_try <= F + _C1 * dec) & (dec < 0.0)
                      & torch.isfinite(F_try))  # sync: one per trial
            if ok:
                break
            a = 0.5 * a
        if ok:
            w_new, f_new, F_new, g_new = w_try, f_try, F_try, g_try
        else:
            w_new, f_new, F_new, g_new = w, f, F, g

        # the history takes smooth gradients (Andrew & Gao): y = Δg, s = Δw
        s, yv = w_new - w, g_new - g
        sy_new, yy_new, keep = _curvature(s, yv)
        pgnorm = torch.linalg.vector_norm(
            pseudo_gradient(w_new, g_new, l1_weight, mask))
        grad_conv = pgnorm <= tolerance * torch.clamp(pg0norm, min=1.0)
        # f progress counts on accepted steps only
        f_conv = (torch.abs(F - F_new) <= tolerance * torch.clamp(
            torch.maximum(torch.abs(F), torch.abs(F_new)), min=1e-12)) & ok
        # a failed search whose expected decrease is below F's noise floor
        # is machine-precision convergence, not a failure
        noise = 4.0 * torch.finfo(dtype).eps * torch.clamp(torch.abs(F),
                                                           min=1.0)
        precision_limited = (torch.abs(dphi0) <= noise) & (not ok)
        converged = grad_conv | f_conv | precision_limited
        failed = failed | (~converged & (not ok))
        it += 1
        hist[it] = F_new
        ghist[it] = pgnorm
        snapshot_tap("owlqn", it, w_new, F_new, pgnorm)
        if tap:
            step = a if ok else torch.zeros((), dtype=dtype, device=dev)
            keep, conv, Fv, pgv, av = torch.stack([
                keep.to(dtype), converged.to(dtype), F_new.to(dtype),
                pgnorm, step.to(dtype)]).tolist()  # sync
            keep, conv = bool(keep), bool(conv)
            solver_tap("owlqn", it, Fv, pgv, av)
        else:
            keep, conv = torch.stack([keep, converged]).tolist()  # sync
        done = conv or not ok
        if keep:
            idx, count = _push(S, Y, rho, idx, count, s, yv, sy_new)
            sy, yy = sy_new, yy_new
        w, f, F, g = w_new, f_new, F_new, g_new

    return OptResult(
        w=w, value=F,
        grad_norm=torch.linalg.vector_norm(
            pseudo_gradient(w, g, l1_weight, mask)),
        iterations=it, converged=converged, failed=failed,
        loss_history=hist, grad_norm_history=ghist, evaluations=evals)
