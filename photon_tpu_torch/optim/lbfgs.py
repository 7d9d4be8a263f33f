"""L-BFGS (port of `two_loop`, `_push`, `_convergence`, the generic
`minimize_lbfgs` and the margin-cached `minimize_lbfgs_margin` of
`photon_tpu/optim/lbfgs.py`).

Reference parity: com.linkedin.photon.ml.optimization.LBFGS (Breeze's
LBFGS): a circular (s, y) history of ``history`` pairs and a strong-Wolfe
line search. The reference's `lax.while_loop` becomes a Python loop on
the host over device tensors. Each iteration reads back ONE small tensor
— the done flag and whether the new (s, y) pair passed the curvature
test — so the host knows when to stop and which history slots are live;
everything else stays on the device. That read waits for the iteration's
device work, so the host cannot queue the next iteration ahead of it (a
CUDA-graph step is later work).

The (m, d) history updates in place (the reference's arrays are
immutable).

With the telemetry tap armed (`telemetry.taps`), the loss, |g| and step
ride in that same read-back and each iteration emits one event; with it
off the solve reads back exactly the two flags.

The generic `minimize_lbfgs` takes a ``value_and_grad`` closure (the
tuner's GP marginal likelihood, differentiated by autograd): each
line-search trial is one call of it, so its search stops at the trial
that satisfies the Wolfe conditions (one read-back a trial, the
reference's answer) rather than running its capped trials masked; an
iteration costs its trials plus one call at the accepted point
(`OptResult.evaluations`).
"""
from __future__ import annotations

import torch

from photon_tpu_torch.checkpoint.taps import snapshot_tap
from photon_tpu_torch.optim.linesearch import wolfe_line_search
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.telemetry.taps import solver_tap, tap_enabled

# Refresh the chained margin from w every this many iterations (f32 drift
# bound), as the reference.
_Z_REFRESH = 64


def two_loop(g, S, Y, rho, idx: int, count: int, sy, yy):
    """H·g approximation by the two-loop recursion over the circular
    buffer's ``count`` live slots, newest at ``idx - 1``. ``sy``/``yy`` are
    the newest accepted pair's sᵀy / yᵀy, cached by the push."""
    m = S.shape[0]
    q = g
    alphas = {}
    for i in range(count):  # newest → oldest
        slot = (idx - 1 - i) % m
        alpha = rho[slot] * torch.dot(S[slot], q)
        q = q - alpha * Y[slot]
        alphas[slot] = alpha
    r = (sy / torch.clamp(yy, min=1e-20)) * q if count > 0 else q
    for i in reversed(range(count)):  # oldest → newest
        slot = (idx - 1 - i) % m
        beta = rho[slot] * torch.dot(Y[slot], r)
        r = r + (alphas[slot] - beta) * S[slot]
    return r


def _curvature(s, y):
    """(sᵀy, yᵀy, ok) for a candidate pair: it is kept only when the
    curvature condition holds (sᵀy not too small), as Breeze does."""
    sy = torch.dot(s, y)
    yy = torch.dot(y, y)
    return sy, yy, sy > 1e-10 * torch.clamp(yy, min=1e-20)


def _push(S, Y, rho, idx: int, count: int, s, y, sy):
    """Write an accepted (s, y) pair into slot ``idx`` (in place); returns
    the new (idx, count)."""
    m = S.shape[0]
    S[idx] = s
    Y[idx] = y
    rho[idx] = 1.0 / torch.clamp(sy, min=1e-20)
    return (idx + 1) % m, min(count + 1, m)


def _convergence(ok, f_old, f_new, gnorm, g0norm, dphi0, tolerance, dtype):
    """Stop criteria: gradient tolerance, relative-f progress on ACCEPTED
    steps, and the precision-limited case (line search failed with the
    expected decrease below the f32 noise floor)."""
    grad_conv = gnorm <= tolerance * torch.clamp(g0norm, min=1.0)
    f_conv = ok & (torch.abs(f_old - f_new) <= tolerance * torch.clamp(
        torch.maximum(torch.abs(f_old), torch.abs(f_new)), min=1e-12))
    noise = 4.0 * torch.finfo(dtype).eps * torch.clamp(torch.abs(f_old),
                                                       min=1.0)
    precision_limited = ~ok & (torch.abs(dphi0) <= noise)
    return grad_conv | f_conv | precision_limited


def minimize_lbfgs(value_and_grad, w0: torch.Tensor, max_iters: int = 100,
                   tolerance: float = 1e-7, history: int = 10,
                   max_ls_evals: int = 12) -> OptResult:
    """L-BFGS over a ``value_and_grad`` closure, w -> (f, g), with the
    reference's history, line search and stop rules."""
    w = w0 if w0.is_floating_point() else w0.float()
    dtype, dev = w.dtype, w.device
    d, m = w.shape[0], history
    evals = 0

    def evaluate(v):
        nonlocal evals
        evals += 1
        return value_and_grad(v)

    f, g = evaluate(w)
    g0norm = torch.linalg.vector_norm(g)
    hist = torch.full((max_iters + 1,), float("nan"), dtype=dtype,
                      device=dev)
    ghist = hist.clone()
    hist[0] = f
    ghist[0] = g0norm
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    sy = yy = torch.zeros((), dtype=dtype, device=dev)
    idx = count = it = 0
    converged = g0norm <= 1e-14
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    done = bool(converged)  # sync

    while not done and it < max_iters:
        direction = -two_loop(g, S, Y, rho, idx, count, sy, yy)
        dphi0 = torch.dot(direction, g)
        bad_dir = dphi0 >= 0.0
        direction = torch.where(bad_dir, -g, direction)
        dphi0 = torch.where(bad_dir, -torch.dot(g, g), dphi0)

        def phi(a, w=w, direction=direction):
            fa, ga = evaluate(w + a * direction)
            return fa, torch.dot(ga, direction)

        a_init = (1.0 if count > 0 else
                  1.0 / torch.clamp(torch.linalg.vector_norm(direction),
                                    min=1.0))
        alpha, _, ok = wolfe_line_search(phi, f, dphi0, a_init, max_ls_evals,
                                         early_exit=True)

        w_try = w + alpha * direction
        f_try, g_try = evaluate(w_try)
        # a failed search keeps the iterate and stops the solve
        w_new = torch.where(ok, w_try, w)
        f_new = torch.where(ok, f_try, f)
        g_new = torch.where(ok, g_try, g)

        s, y = w_new - w, g_new - g
        sy_new, yy_new, keep = _curvature(s, y)
        gnorm = torch.linalg.vector_norm(g_new)
        converged = _convergence(ok, f, f_new, gnorm, g0norm, dphi0,
                                 tolerance, dtype)
        failed = failed | (~ok & ~converged)
        it += 1
        hist[it] = f_new
        ghist[it] = gnorm
        keep, done = torch.stack([keep, converged | ~ok]).tolist()  # sync
        if keep:
            idx, count = _push(S, Y, rho, idx, count, s, y, sy_new)
            sy, yy = sy_new, yy_new
        w, f, g = w_new, f_new, g_new

    return OptResult(
        w=w, value=f, grad_norm=torch.linalg.vector_norm(g), iterations=it,
        converged=converged, failed=failed, loss_history=hist,
        grad_norm_history=ghist, evaluations=evals)


def minimize_lbfgs_margin(obj, batch, w0: torch.Tensor, max_iters: int = 100,
                          tolerance: float = 1e-7, history: int = 10,
                          max_ls_evals: int = 12) -> OptResult:
    """L-BFGS over a GLM objective with a CACHED margin: along a direction
    p the Wolfe search runs on z + a·dz elementwise, so an iteration costs
    exactly two X passes (dz = Xp, and Xᵀr at the accepted point)."""
    w = w0 if w0.is_floating_point() else w0.float()
    dtype, dev = w.dtype, w.device
    d, m = w.shape[0], history
    z = obj.margin(w, batch)
    f, g = obj.value_and_grad_at_margin(w, z, batch)
    g0norm = torch.linalg.vector_norm(g)

    hist = torch.full((max_iters + 1,), float("nan"), dtype=dtype,
                      device=dev)
    ghist = hist.clone()
    hist[0] = f
    ghist[0] = g0norm
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    sy = yy = torch.zeros((), dtype=dtype, device=dev)
    idx = count = it = 0
    converged = g0norm <= 1e-14
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    tap = tap_enabled()
    if tap:  # the tap's values ride the start's one read-back
        conv0, f0v, g0v = torch.stack(
            [converged.to(dtype), f.to(dtype), g0norm]).tolist()  # sync
        done = bool(conv0)
        solver_tap("lbfgs_margin", 0, f0v, g0v)
    else:
        done = bool(converged)

    while not done and it < max_iters:
        direction = -two_loop(g, S, Y, rho, idx, count, sy, yy)
        dphi0 = torch.dot(direction, g)
        # steepest descent when this is not a descent direction
        bad_dir = dphi0 >= 0.0
        direction = torch.where(bad_dir, -g, direction)
        dphi0 = torch.where(bad_dir, -torch.dot(g, g), dphi0)

        dz = obj.direction_margin(direction, batch)  # X pass 1
        ray = obj.ray_reg_coeffs(w, direction)

        def phi(a):
            return obj.phi_at_ray(z, dz, a, ray, batch)

        a_init = (1.0 if count > 0 else
                  1.0 / torch.clamp(torch.linalg.vector_norm(direction),
                                    min=1.0))
        alpha, f_star, ok = wolfe_line_search(phi, f, dphi0, a_init,
                                              max_ls_evals)

        w_new = torch.where(ok, w + alpha * direction, w)
        z_new = torch.where(ok, z + alpha * dz, z)
        if max_iters >= _Z_REFRESH and (it + 1) % _Z_REFRESH == 0:
            z_new = obj.margin(w_new, batch)  # f32 drift of the chained z
        f_new = torch.where(ok, f_star, f)
        g_new = torch.where(ok, obj.grad_at_margin(w_new, z_new, batch),
                            g)  # X pass 2

        s, y = w_new - w, g_new - g
        sy_new, yy_new, keep = _curvature(s, y)
        gnorm = torch.linalg.vector_norm(g_new)
        converged = _convergence(ok, f, f_new, gnorm, g0norm, dphi0,
                                 tolerance, dtype)
        failed = failed | (~ok & ~converged)
        it += 1
        hist[it] = f_new
        ghist[it] = gnorm
        snapshot_tap("lbfgs_margin", it, w_new, f_new, gnorm)
        if tap:
            keep, done, fv, gv, av = torch.stack([
                keep.to(dtype), (converged | ~ok).to(dtype), f_new.to(dtype),
                gnorm, torch.where(ok, alpha, 0.0).to(dtype)]).tolist()  # sync
            keep, done = bool(keep), bool(done)
            solver_tap("lbfgs_margin", it, fv, gv, av)
        else:
            keep, done = torch.stack([keep, converged | ~ok]).tolist()  # sync
        if keep:
            idx, count = _push(S, Y, rho, idx, count, s, y, sy_new)
            sy, yy = sy_new, yy_new
        w, z, f, g = w_new, z_new, f_new, g_new

    return OptResult(
        w=w, value=f, grad_norm=torch.linalg.vector_norm(g), iterations=it,
        converged=converged, failed=failed, loss_history=hist,
        grad_norm_history=ghist)
