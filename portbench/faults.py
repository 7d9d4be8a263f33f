"""Faults planted under the timed path of the ``train_glm_grid`` entry:
what its judge must refuse. Used by `portbench.control` on the card and
by the tests on the CPU; the benchmark's own runs never plant one.

Each fault is a hook of the entry's `Session`: a fit hook takes the
program's call and returns its (result, variances); a batch hook takes
the batch and returns the batch the fits take.
"""
from __future__ import annotations

import torch


def unchanged(call):
    """A step that returns its state unchanged: the lane line search
    accepts a zero step."""
    from photon_tpu_torch.optim import lane_lbfgs

    orig = lane_lbfgs.wolfe_line_search_lanes

    def zero_step(phi, f0, dphi0, a_init, max_evals=12, done0=None):
        ok = torch.ones(f0.shape, dtype=torch.bool, device=f0.device)
        return torch.zeros_like(f0), f0, ok

    lane_lbfgs.wolfe_line_search_lanes = zero_step
    try:
        return call()
    finally:
        lane_lbfgs.wolfe_line_search_lanes = orig


def half_batch(batch):
    """Half of the batch left out, the mean taken over the rest: every
    other row weighs 0 and the others 2."""
    w = torch.zeros_like(batch.weights)
    w[0::2] = 2.0
    return batch._replace(weights=w * batch.weights)


def permuted(perm_cols):
    """An answer altered where it is produced: the coefficients returned in
    the solver's permuted column order, not read back into model order."""
    def hook(call):
        res, var = call()
        w = torch.index_select(res.w, 1, perm_cols)
        return res._replace(w=w), var
    return hook

