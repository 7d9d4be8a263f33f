"""Margin-cached L-BFGS over G regularization lanes in LANE-MINOR layout
(port of `photon_tpu/optim/lane_lbfgs.py`).

Reference parity: com.linkedin.photon.ml.optimization.LBFGS run once per
grid point by the reference's sweep; here the whole sweep is one
lock-step solver whose state carries a trailing lane axis — coefficients
(d, G), margins (n, G), history (m, d, G), per-lane scalars (G,). The
(d, G) tensors keep G contiguous, the layout the blocked-ELL kernels take.

Differences from the scalar solver (`optim/lbfgs.py`), all masked per lane:
- the Wolfe search runs lock-step with sticky per-lane ``done`` freezing;
- the (s, y) history uses a globally rotating slot and per-(slot, lane)
  validity masks (a lane that skips a push just leaves its slot invalid);
- converged or failed lanes freeze while the others run on.

The reference's `lax.while_loop`s become host loops that stop where the
reference's loops stop. The outer loop reads back one flag per iteration
(is every lane done); the line search evaluates φ for as many trials as
the reference's loop does, reading back one flag (is every lane done)
after each trial but the last — it does not run ``max_evals`` masked
trials. The history updates in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch.ops import lane_objective as lo
from photon_tpu_torch.optim.lbfgs import _convergence
from photon_tpu_torch.optim.linesearch import C1, C2, _cubic_min
from photon_tpu_torch.optim.tracker import OptResult

_Z_REFRESH = 64  # as optim.lbfgs: margin re-derivation period

_FIELDS = ("phase", "a", "a_prev", "f_prev", "d_prev", "a_lo", "f_lo",
           "d_lo", "a_hi", "f_hi", "d_hi", "a_star", "f_star")


def wolfe_line_search_lanes(phi: Callable, f0, dphi0, a_init,
                            max_evals: int = 12, done0=None):
    """Per-lane strong-Wolfe search, lock-step: every trial evaluates
    ``phi`` once for ALL lanes ((G,) alphas -> ((G,) f, (G,) dphi)); lanes
    that satisfy Wolfe freeze while the rest keep bracketing or zooming.
    Returns (alpha, f_alpha, ok), each (G,).

    ``done0``: lanes already finished in the outer solver, seeded as done
    so a converged lane's frozen state cannot drag the search to
    ``max_evals`` (its a_star stays 0, so ok is False and the solver's own
    done mask keeps it frozen). The search stops once every lane is done,
    after the first trial at the earliest: with every lane seeded done it
    evaluates one trial whose result it discards (the reference's loop
    none; the lane solvers never call it so)."""
    f0 = torch.as_tensor(f0)
    dtype, dev = f0.dtype, f0.device
    G = f0.shape[0]
    dphi0 = torch.as_tensor(dphi0, dtype=dtype, device=dev)
    zero = torch.zeros((G,), dtype=dtype, device=dev)
    inf = torch.full((G,), float("inf"), dtype=dtype, device=dev)
    done_init = (torch.zeros((G,), dtype=torch.bool, device=dev)
                 if done0 is None else torch.as_tensor(done0, device=dev))
    where = torch.where
    s = dict(phase=torch.zeros((G,), dtype=torch.bool, device=dev),
             a=torch.as_tensor(a_init, dtype=dtype, device=dev).expand(G),
             a_prev=zero, f_prev=f0, d_prev=dphi0, a_lo=zero, f_lo=f0,
             d_lo=dphi0, a_hi=inf, f_hi=inf, d_hi=inf, a_star=zero,
             f_star=f0)
    done = done_init
    curv_bound = -C2 * dphi0
    for i in range(max_evals):
        a = s["a"]
        f, d = phi(a)
        bad = torch.isnan(f) | torch.isinf(f)
        armijo = f <= f0 + C1 * a * dphi0

        # bracketing (Alg 3.5)
        to_zoom_hi = bad | ~armijo
        if i > 0:
            to_zoom_hi = to_zoom_hi | (f >= s["f_prev"])
        wolfe_ok = ~to_zoom_hi & (torch.abs(d) <= curv_bound)
        to_zoom_rev = ~to_zoom_hi & ~wolfe_ok & (d >= 0.0)
        expand = ~to_zoom_hi & ~wolfe_ok & ~to_zoom_rev
        br_lo = [where(to_zoom_hi, s[k + "_prev"], x)
                 for k, x in (("a", a), ("f", f), ("d", d))]
        br_hi = [where(to_zoom_hi, x, s[k + "_prev"])
                 for k, x in (("a", a), ("f", f), ("d", d))]

        # zoom (Alg 3.6)
        z_shrink_hi = bad | ~armijo | (f >= s["f_lo"])
        z_wolfe_ok = ~z_shrink_hi & (torch.abs(d) <= curv_bound)
        z_flip = ~z_shrink_hi & (d * (s["a_hi"] - s["a_lo"]) >= 0.0)
        z_lo = [where(z_shrink_hi, s[k + "_lo"], x)
                for k, x in (("a", a), ("f", f), ("d", d))]
        z_hi = [where(z_shrink_hi, x, where(z_flip, s[k + "_lo"],
                                            s[k + "_hi"]))
                for k, x in (("a", a), ("f", f), ("d", d))]

        in_zoom = s["phase"]
        newly_done = where(in_zoom, z_wolfe_ok, wolfe_ok)
        a_lo, f_lo, d_lo = (where(in_zoom, z, b) for z, b in zip(z_lo, br_lo))
        a_hi, f_hi, d_hi = (where(in_zoom, z, b) for z, b in zip(z_hi, br_hi))
        interp_a = _cubic_min(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi)
        interp_a = where(torch.isfinite(f_hi) & torch.isfinite(d_hi),
                         interp_a, 0.5 * (a_lo + a_hi))
        next_a = where(in_zoom | ~expand, interp_a, 2.0 * a)

        better = armijo & (f < s["f_star"]) & ~bad
        take = newly_done | better
        new = dict(phase=in_zoom | to_zoom_hi | to_zoom_rev, a=next_a,
                   a_prev=a, f_prev=f, d_prev=d, a_lo=a_lo, f_lo=f_lo,
                   d_lo=d_lo, a_hi=a_hi, f_hi=f_hi, d_hi=d_hi,
                   a_star=where(take, a, s["a_star"]),
                   f_star=where(take, f, s["f_star"]))
        # sticky freeze: lanes already done keep every field
        s = {k: where(done, s[k], new[k]) for k in _FIELDS}
        done = done | newly_done
        if i + 1 < max_evals and bool(done.all()):  # sync: one flag a trial
            break
    # seeded-done lanes stay ok=False (alpha 0, nothing accepted)
    ok = (done & ~done_init) | (s["a_star"] > 0.0)
    return s["a_star"], s["f_star"], ok


def two_loop_lanes(g, S, Y, rho, valid, idx: int, sy, yy,
                   slots: int | None = None):
    """H·g per lane over the rotating history. g: (d, G); S/Y: (m, d, G);
    rho/valid/sy/yy: (m, G); idx: the next write slot. Invalid (slot,
    lane) pairs are masked out, so a lane's history is its valid slots in
    recency order. ``sy``/``yy`` are the sᵀy / yᵀy cached at push time
    (f32, from the unrounded pair); gamma comes from each lane's newest
    valid pair. ``slots``: how many of the newest slots were ever written
    (default all m) — the others are invalid in every lane, and skipping
    them gives the same bits. A bf16 history promotes to f32 in each
    product (bf16 × f32), so every reduction is f32."""
    m = S.shape[0]
    order = [(idx - 1 - i) % m for i in range(m if slots is None
                                             else slots)]  # newest first
    q = g
    alphas = {}
    for slot in order:
        alpha = torch.where(valid[slot],
                            rho[slot] * torch.sum(S[slot] * q, dim=0), 0.0)
        q = q - alpha[None, :] * Y[slot]
        alphas[slot] = alpha
    gamma = torch.ones_like(g[0])
    found = torch.zeros_like(valid[0])
    for slot in order:
        v = valid[slot] & ~found
        gamma = torch.where(v, sy[slot] / torch.clamp(yy[slot], min=1e-20),
                            gamma)
        found = found | valid[slot]
    r = gamma[None, :] * q
    for slot in reversed(order):  # oldest first
        v = valid[slot]
        beta = torch.where(v, rho[slot] * torch.sum(Y[slot] * r, dim=0), 0.0)
        r = r + torch.where(v, alphas[slot] - beta, 0.0)[None, :] * S[slot]
    return r


def _push_lanes(S, Y, rho, valid, idx: int, s, y, accept, SY, YY) -> int:
    """Write (s, y) into the rotating slot ``idx`` (in place) for lanes
    where ``accept`` holds and the curvature condition passes; the other
    lanes' slot goes invalid. sᵀy and yᵀy are computed f32 from the
    unrounded pair and cached in ``SY``/``YY`` before the pair is cast to
    the history's storage dtype. Returns the next slot."""
    m = S.shape[0]
    sy = torch.sum(s * y, dim=0)
    yy = torch.sum(y * y, dim=0)
    acc = accept & (sy > 1e-10 * torch.clamp(yy, min=1e-20))
    S[idx] = torch.where(acc[None, :], s.to(S.dtype), S[idx])
    Y[idx] = torch.where(acc[None, :], y.to(Y.dtype), Y[idx])
    rho[idx] = torch.where(acc, 1.0 / torch.clamp(sy, min=1e-20), rho[idx])
    SY[idx] = torch.where(acc, sy, SY[idx])
    YY[idx] = torch.where(acc, yy, YY[idx])
    valid[idx] = acc
    return (idx + 1) % m


class LaneHistory:
    """The (m, d, G) rotating (s, y) history of the lane quasi-Newton
    solvers, with per-(slot, lane) validity and the cached f32 steering
    products; storage in ``dtype`` (f32 or bf16)."""

    def __init__(self, m: int, d: int, G: int, dtype, device):
        f32 = torch.float32
        self.S = torch.zeros((m, d, G), dtype=dtype, device=device)
        self.Y = torch.zeros((m, d, G), dtype=dtype, device=device)
        self.rho = torch.zeros((m, G), dtype=f32, device=device)
        self.sy = torch.zeros((m, G), dtype=f32, device=device)
        self.yy = torch.zeros((m, G), dtype=f32, device=device)
        self.valid = torch.zeros((m, G), dtype=torch.bool, device=device)
        self.idx = 0
        self.written = 0  # slots ever written (host count)

    def direction(self, g):
        """-H·g per lane."""
        return -two_loop_lanes(g, self.S, self.Y, self.rho, self.valid,
                               self.idx, self.sy, self.yy, self.written)

    def has_pairs(self):
        return torch.any(self.valid, dim=0)

    def push(self, s, y, accept) -> None:
        self.idx = _push_lanes(self.S, self.Y, self.rho, self.valid,
                               self.idx, s, y, accept, self.sy, self.yy)
        self.written = min(self.written + 1, self.S.shape[0])


def _colnorm(A):
    return torch.sqrt(torch.sum(A * A, dim=0))


def _history_buffers(f0, g0norm, max_iters: int):
    G = f0.shape[0]
    hist = torch.full((max_iters + 1, G), float("nan"), dtype=f0.dtype,
                      device=f0.device)
    ghist = hist.clone()
    hist[0] = f0
    ghist[0] = g0norm
    return hist, ghist


def minimize_lbfgs_margin_lanes(obj, l2s, batch, W0, max_iters: int = 100,
                                tolerance: float = 1e-7, history: int = 10,
                                max_ls_evals: int = 12,
                                history_dtype=None) -> OptResult:
    """Margin-cached L-BFGS over G lanes, lock-step, lane-minor: two
    shared X passes an iteration (dz = XD and the Xᵀ pass at the accepted
    point), the Wolfe trials elementwise on z + a·dz.

    ``l2s``: (G,) per-lane L2 weights (``obj.l2`` is unused). ``W0``: (d,
    G) per-lane starts. ``history_dtype``: the storage dtype of the (m,
    d, G) S/Y buffers (e.g. ``torch.bfloat16``; None = f32).

    Returns an OptResult whose tensors carry the lane axis LAST: w (d, G),
    value/grad_norm/iterations/converged/failed (G,), histories
    (max_iters + 1, G); ``trials`` counts the lock-step line-search
    trials (each one (n, G) elementwise pass)."""
    W = W0.to(torch.float32).contiguous()
    d, G = W.shape
    dtype, dev = W.dtype, W.device
    z = lo.margin_lanes(obj, W, batch)
    f, g = lo.value_and_grad_at_margin_lanes(obj, l2s, W, z, batch)
    g0norm = _colnorm(g)
    hist, ghist = _history_buffers(f, g0norm, max_iters)
    H = LaneHistory(history, d, G, history_dtype or dtype, dev)
    its = torch.zeros((G,), dtype=torch.int32, device=dev)
    done = g0norm <= 1e-14
    converged = done.clone()
    failed = torch.zeros((G,), dtype=torch.bool, device=dev)
    it = trials = 0

    while it < max_iters and not bool(done.all()):  # sync: one flag
        active = ~done
        D = H.direction(g)
        dphi0 = torch.sum(D * g, dim=0)
        bad_dir = dphi0 >= 0.0
        D = torch.where(bad_dir[None, :], -g, D)
        dphi0 = torch.where(bad_dir, -torch.sum(g * g, dim=0), dphi0)

        dz = lo.direction_margin_lanes(obj, D, batch)  # X pass 1
        ray = lo.ray_reg_coeffs_lanes(obj, l2s, W, D)
        n_phi = [0]

        def phi(a):
            n_phi[0] += 1
            return lo.phi_at_ray_lanes(obj, z, dz, a, ray, batch)

        a_init = torch.where(H.has_pairs(), 1.0,
                             1.0 / torch.clamp(_colnorm(D), min=1.0))
        alpha, f_star, ok = wolfe_line_search_lanes(phi, f, dphi0, a_init,
                                                    max_ls_evals, done0=done)
        trials += n_phi[0]

        step = active & ok
        W_new = torch.where(step[None, :], W + alpha[None, :] * D, W)
        z_new = torch.where(step[None, :], z + alpha[None, :] * dz, z)
        if (it + 1) % _Z_REFRESH == 0:
            z_new = lo.margin_lanes(obj, W_new, batch)  # f32 drift bound
        f_new = torch.where(step, f_star, f)
        g_new = torch.where(step[None, :],  # X pass 2
                            lo.grad_at_margin_lanes(obj, l2s, W_new, z_new,
                                                    batch), g)
        H.push(W_new - W, g_new - g, step)

        gnorm = _colnorm(g_new)
        conv = _convergence(ok, f, f_new, gnorm, g0norm, dphi0, tolerance,
                            dtype)
        it += 1
        its = torch.where(active, its + 1, its)
        done = done | (active & (conv | ~ok))
        converged = torch.where(active, conv, converged)
        failed = failed | (active & ~ok & ~conv)
        hist[it] = torch.where(active, f_new, hist[it])
        ghist[it] = torch.where(active, gnorm, ghist[it])
        W, z, f, g = W_new, z_new, f_new, g_new

    return OptResult(w=W, value=f, grad_norm=_colnorm(g), iterations=its,
                     converged=converged, failed=failed, loss_history=hist,
                     grad_norm_history=ghist, trials=trials)
