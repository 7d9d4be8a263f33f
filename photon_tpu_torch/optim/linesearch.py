"""Strong-Wolfe line search (Nocedal & Wright Alg. 3.5/3.6), port of
`photon_tpu/optim/linesearch.py`.

The reference runs the bracket + zoom state machine in a bounded
`lax.while_loop`. Here it is a Python loop over 0-d device tensors that
runs all ``max_evals`` steps and freezes the state once it is done, so the
search never reads a value back to the host (the solver syncs once per
outer iteration). The frozen steps evaluate φ at a trial point whose
result is discarded; the answer is the reference's. With ``early_exit``
the search reads its done flag back after each step and stops there
instead (the same answer): for a φ that costs a full evaluation of the
objective (the generic L-BFGS's closures), one read-back a trial is
cheaper than the frozen trials.
"""
from __future__ import annotations

from typing import Callable

import torch

C1 = 1e-4
C2 = 0.9

_FIELDS = ("in_zoom", "done", "a", "a_prev", "f_prev", "d_prev", "a_lo",
           "f_lo", "d_lo", "a_hi", "f_hi", "d_hi", "a_star", "f_star")


def _cubic_min(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi):
    """Minimizer of the cubic Hermite interpolant (Nocedal & Wright eq.
    3.59), safeguarded: bisection when the cubic is degenerate or its
    minimizer falls outside the bracket's interior (10% margin each end)."""
    one = torch.ones_like(a_lo)
    span = a_hi - a_lo
    d1 = d_lo + d_hi - 3.0 * (f_lo - f_hi) / torch.where(span == 0.0, one,
                                                         -span)
    disc = d1 * d1 - d_lo * d_hi
    d2 = torch.sign(span) * torch.sqrt(torch.clamp(disc, min=0.0))
    denom = d_hi - d_lo + 2.0 * d2
    a_c = a_hi - span * (d_hi + d2 - d1) / torch.where(denom == 0.0, one,
                                                       denom)
    lo_m = a_lo + 0.1 * span
    hi_m = a_hi - 0.1 * span
    inside = torch.where(span > 0.0, (a_c >= lo_m) & (a_c <= hi_m),
                         (a_c <= lo_m) & (a_c >= hi_m))
    ok = (disc >= 0.0) & (denom != 0.0) & torch.isfinite(a_c) & inside
    return torch.where(ok, a_c, 0.5 * (a_lo + a_hi))


def wolfe_line_search(phi: Callable, f0, dphi0, a_init=1.0,
                      max_evals: int = 12, early_exit: bool = False):
    """``phi``: alpha -> (f, dphi) along the ray. Returns (alpha, f_alpha,
    ok) as 0-d tensors; alpha = 0 and ok = False on failure."""
    f0 = torch.as_tensor(f0)
    dtype, dev = f0.dtype, f0.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    dphi0 = t(dphi0)
    zero, inf = t(0.0), t(float("inf"))
    s = dict(in_zoom=torch.zeros((), dtype=torch.bool, device=dev),
             done=torch.zeros((), dtype=torch.bool, device=dev),
             a=t(a_init), a_prev=zero, f_prev=f0, d_prev=dphi0,
             a_lo=zero, f_lo=f0, d_lo=dphi0, a_hi=inf, f_hi=inf, d_hi=inf,
             a_star=zero, f_star=f0)
    where = torch.where
    for i in range(max_evals):
        a = s["a"]
        f, d = phi(a)
        bad = torch.isnan(f) | torch.isinf(f)
        armijo = f <= f0 + C1 * a * dphi0
        curv = torch.abs(d) <= -C2 * dphi0

        # --- bracketing phase transitions (Alg 3.5)
        to_zoom_hi = bad | ~armijo
        if i > 0:
            to_zoom_hi = to_zoom_hi | (f >= s["f_prev"])
        wolfe_ok = ~to_zoom_hi & curv
        to_zoom_rev = ~to_zoom_hi & ~wolfe_ok & (d >= 0.0)
        expand = ~to_zoom_hi & ~wolfe_ok & ~to_zoom_rev
        br_lo = [where(to_zoom_hi, s[k + "_prev"], x)
                 for k, x in (("a", a), ("f", f), ("d", d))]
        br_hi = [where(to_zoom_hi, x, s[k + "_prev"])
                 for k, x in (("a", a), ("f", f), ("d", d))]

        # --- zoom phase update (Alg 3.6); a is the trial point in [lo, hi]
        z_shrink_hi = bad | ~armijo | (f >= s["f_lo"])
        z_wolfe_ok = ~z_shrink_hi & curv
        z_flip = ~z_shrink_hi & (d * (s["a_hi"] - s["a_lo"]) >= 0.0)
        z_lo = [where(z_shrink_hi, s[k + "_lo"], x)
                for k, x in (("a", a), ("f", f), ("d", d))]
        z_hi = [where(z_shrink_hi, x, where(z_flip, s[k + "_lo"],
                                            s[k + "_hi"]))
                for k, x in (("a", a), ("f", f), ("d", d))]

        in_zoom = s["in_zoom"]
        done = where(in_zoom, z_wolfe_ok, wolfe_ok)
        a_lo, f_lo, d_lo = (where(in_zoom, z, b) for z, b in zip(z_lo, br_lo))
        a_hi, f_hi, d_hi = (where(in_zoom, z, b) for z, b in zip(z_hi, br_hi))
        # trial point: the cubic minimizer over the bracket (bisection when
        # the hi endpoint is non-finite); bracketing keeps doubling
        interp_a = _cubic_min(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi)
        interp_a = where(torch.isfinite(f_hi) & torch.isfinite(d_hi),
                         interp_a, 0.5 * (a_lo + a_hi))
        next_a = where(in_zoom | ~expand, interp_a, 2.0 * a)

        # best Armijo-satisfying point seen so far (fallback on the cap)
        better = armijo & (f < s["f_star"]) & ~bad
        a_star = where(done | better, a, s["a_star"])
        f_star = where(done | better, f, s["f_star"])

        new = dict(in_zoom=in_zoom | to_zoom_hi | to_zoom_rev, done=done,
                   a=next_a, a_prev=a, f_prev=f, d_prev=d,
                   a_lo=a_lo, f_lo=f_lo, d_lo=d_lo, a_hi=a_hi, f_hi=f_hi,
                   d_hi=d_hi, a_star=a_star, f_star=f_star)
        live = ~s["done"]  # a finished search keeps its state
        s = {k: where(live, new[k], s[k]) for k in _FIELDS}
        if early_exit and bool(s["done"]):  # sync: one a trial
            break
    ok = s["done"] | (s["a_star"] > 0.0)
    return s["a_star"], s["f_star"], ok
