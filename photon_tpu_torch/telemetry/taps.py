"""The resident-solver iteration tap (port of
`photon_tpu/telemetry/taps.py`).

The resident solvers (`optim.lbfgs` / `owlqn` / `tron`) are host loops
over device tensors that read back one small tensor an iteration (the
done flag and the history's keep flag). `solver_tap(...)` emits a live
iteration event into the current run — but only while a
``Run(resident_tap=True)`` is attached. Armed, a solver puts its loss,
|g| and step into the SAME read-back it already makes (one
``torch.stack(...).tolist()``), so the tap adds no device→host sync;
disarmed, the solver reads back exactly what it read before the tap
existed, and its numerics do not change either way.

The solver reads `tap_enabled()` once at its start (the reference
decides at trace time, once per traced program). The reference's
`jax.clear_caches()` on arming has no eager counterpart: nothing is
cached that knows the flag, so arming is a plain flag flip.
"""
from __future__ import annotations

import contextlib

__all__ = ["solver_tap", "tap_enabled", "set_resident_tap",
           "tap_disabled"]

_TAP_ARMED = False


def tap_enabled() -> bool:
    """Is the resident iteration tap armed?"""
    return _TAP_ARMED


def set_resident_tap(on: bool) -> None:
    """Arm or disarm the tap."""
    global _TAP_ARMED
    _TAP_ARMED = bool(on)


@contextlib.contextmanager
def tap_disabled():
    """Force the tap off inside the block, whatever the attached run
    says (the off-is-free checks use it so an armed ambient run cannot
    change what they count)."""
    global _TAP_ARMED
    was = _TAP_ARMED
    _TAP_ARMED = False
    try:
        yield
    finally:
        _TAP_ARMED = was


def solver_tap(solver: str, it: int, loss: float, grad_norm=None,
               step=None) -> None:
    """One resident-solver iteration event from host values the solver
    already read back. No-op unless the tap is armed and a run is
    attached; ``grad_norm`` and ``step`` default to 0.0, as the
    reference's callback fills them."""
    if not _TAP_ARMED:
        return
    from photon_tpu_torch.telemetry import current_run

    run = current_run()
    if run is None:
        return
    run.iteration(solver, int(it), loss,
                  grad_norm=0.0 if grad_norm is None else grad_norm,
                  step=0.0 if step is None else step, tapped=True)


# ----------------------------------------------------------------- contracts
# The telemetry-off guarantee as law: the resident margin-cached L-BFGS
# solve with the tap forced off makes no collective, and exactly the host
# syncs of the bare solver (`minimize_lbfgs_margin`) on the same problem:
# the tap rides the read-back the solver already makes.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import TRANSFER_PRIMITIVES  # noqa: E402


@register_contract(
    name="telemetry_off_is_free",
    description="resident L-BFGS solve with telemetry's tap forced off: "
                "zero collectives, and its host syncs equal to the bare "
                "solver's on the same problem — off adds nothing",
    collectives={}, forbid=TRANSFER_PRIMITIVES,
    # the 5-iteration L-BFGS's read-backs (ROADMAP speed item 1), pinned
    # so they can only fall; the bare solve's count is the equality
    max_syncs={"cuda": 20, "cpu": 6},
    tags=("resident", "telemetry"))
def _contract_telemetry_off_is_free(device):
    from photon_tpu_torch.models.training import (_contract_resident_problem,
                                                  solve)
    from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin

    cfg, obj, batch, w0 = _contract_resident_problem(device, 48, 7, 0)

    def fn(b, w, o):
        with tap_disabled():
            return solve(o, b, w, cfg)

    def bare(b, w, o):
        return minimize_lbfgs_margin(o, b, w, max_iters=cfg.max_iters,
                                     tolerance=cfg.tolerance,
                                     history=cfg.history)

    return fn, (batch, w0, obj), bare
