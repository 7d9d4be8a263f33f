"""The resident solvers' last-iterate SNAPSHOT tap (port of
`photon_tpu/checkpoint/taps.py`).

A resident solve (`optim.lbfgs` / `owlqn` / `tron`) has no cut a resumed
run could replay bit for bit — its state lives in device buffers between
two host checks — so its elasticity is a last-iterate tap:
`snapshot_tap(solver, it, w, f, gnorm, aux)`, called at the end of each
solver iteration, records the iterate under ``resident/<solver>`` in the
current `CheckpointSession` when a ``CheckpointSession(
resident_tap=True)`` is armed. A restored iterate (`resident_restore`)
is a WARM START for the re-run; for TRON ``aux`` carries the trust
radius. Bit-identical mid-solve resume is the host-loop regimes'
guarantee (`optim/streamed.py`, `game/*`).

The port's resident solvers are host loops, so the tap is a plain call
behind one flag check: disarmed (the default) it copies nothing and reads
nothing back, and the solve's launches and device ops are the
session-less solve's. Armed, it clones the iterate on its device
(`state.CheckpointSession.update_absolute`); the scalars it is given are
the ones the solver already read back.
"""
from __future__ import annotations

import contextlib

__all__ = ["snapshot_tap", "snapshot_tap_enabled", "set_snapshot_tap",
           "snapshot_tap_disabled", "resident_restore",
           "resident_off_is_free"]

_TAP_ARMED = False


def snapshot_tap_enabled() -> bool:
    return _TAP_ARMED


def set_snapshot_tap(on: bool) -> None:
    """Arm or disarm the resident snapshot tap."""
    global _TAP_ARMED
    _TAP_ARMED = bool(on)


@contextlib.contextmanager
def snapshot_tap_disabled():
    """The tap off for a block, whatever the session says."""
    global _TAP_ARMED
    was = _TAP_ARMED
    _TAP_ARMED = False
    try:
        yield
    finally:
        _TAP_ARMED = was


def snapshot_tap(solver: str, it, w, f, gnorm, aux=None) -> None:
    """Per-iteration snapshot point of a resident solver body: record the
    latest iterate into the current session. One flag check when
    disarmed."""
    if not _TAP_ARMED:
        return
    from photon_tpu_torch import checkpoint

    sess = checkpoint.current()
    if sess is None:
        return
    sess.update_absolute(f"resident/{solver}", {
        "kind": "resident_iterate", "solver": solver,
        "it": it, "w": w, "f": f, "gnorm": gnorm,
        "aux": 0.0 if aux is None else aux})


def resident_restore(solver: str):
    """The last tapped iterate of ``solver`` from the current session's
    restore image (``{"it", "w", "f", "gnorm", "aux"}``), or None — the
    warm-start seed for a re-run after a mid-solve death."""
    from photon_tpu_torch import checkpoint

    sess = checkpoint.current()
    if sess is None:
        return None
    return sess.restore_absolute(f"resident/{solver}")


def resident_off_is_free(batch, obj, w0, max_iters: int = 5) -> dict:
    """The off-state of both resident taps, held on one problem: the
    margin-cached L-BFGS and TRON solves run under an armed session and a
    tap-armed telemetry run but inside `snapshot_tap_disabled` and
    `telemetry.taps.tap_disabled` (the reference's contract scoping),
    against the same solves with nothing attached. Per solver: the
    host↔device syncs of each (`utils.profiling.count_syncs`) and whether
    the two give the same bits."""
    import tempfile

    import torch

    from photon_tpu_torch import checkpoint, telemetry
    from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin
    from photon_tpu_torch.optim.tron import minimize_tron_margin
    from photon_tpu_torch.telemetry.taps import tap_disabled
    from photon_tpu_torch.utils.profiling import count_syncs

    solvers = {
        "lbfgs_margin": lambda: minimize_lbfgs_margin(
            obj, batch, w0, max_iters=max_iters, history=4),
        "tron_margin": lambda: minimize_tron_margin(
            obj, batch, w0, max_iters=max_iters)}
    dev = w0.device
    out = {}
    for name, solve in solvers.items():
        # the first solve under the sync debug mode makes a one-time sync
        # of its own on the card: one counted solve first, its count dropped
        with count_syncs(dev):
            solve()
        with count_syncs(dev) as plain_syncs:
            plain = solve()
        with tempfile.TemporaryDirectory() as tmp, \
                checkpoint.session(tmp, every_evals=None, every_s=None,
                                   async_writer=False, resident_tap=True), \
                telemetry.run("resident_off", resident_tap=True) as r:
            with tap_disabled(), snapshot_tap_disabled():
                with count_syncs(dev) as off_syncs:
                    off = solve()
            quiet = not r.iterations
        out[name] = {
            "syncs_plain": plain_syncs["n"], "syncs_off": off_syncs["n"],
            "recorded_nothing": quiet,
            "same_bits": bool(torch.equal(plain.w, off.w) and torch.equal(
                plain.loss_history.nan_to_num(),
                off.loss_history.nan_to_num()))}
    return out


# ----------------------------------------------------------------- contracts
# The checkpoint-off guarantee as law: with the snapshot tap (and the
# telemetry tap) disarmed, the resident solves make no collective, and
# exactly the host syncs of the bare solver on the same problem.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import TRANSFER_PRIMITIVES  # noqa: E402


@register_contract(
    name="checkpoint_off_is_free",
    description="resident margin-cached L-BFGS solve with the snapshot "
                "tap and the telemetry tap disarmed: zero collectives, "
                "host syncs equal to the bare solver's on the same problem",
    collectives={}, forbid=TRANSFER_PRIMITIVES,
    # the 5-iteration L-BFGS's read-backs (ROADMAP speed item 1), pinned
    # so they can only fall; the bare solve's count is the equality
    max_syncs={"cuda": 20, "cpu": 6}, tags=("resident", "checkpoint"))
def _contract_checkpoint_off_is_free(device):
    from photon_tpu_torch.models.training import _contract_resident_problem
    from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin
    from photon_tpu_torch.telemetry.taps import tap_disabled

    cfg, obj, batch, w0 = _contract_resident_problem(device)

    def bare(b, w, o):
        return minimize_lbfgs_margin(o, b, w, max_iters=cfg.max_iters,
                                     history=cfg.history)

    def fn(b, w, o):
        with tap_disabled(), snapshot_tap_disabled():
            return bare(b, w, o)

    return fn, (batch, w0, obj), bare


@register_contract(
    name="checkpoint_off_tron_free",
    description="resident TRON margin solve with the snapshot tap "
                "disarmed: zero collectives, host syncs equal to the bare "
                "solver's on the same problem (TRON's only checkpoint "
                "surface is this tap)",
    collectives={}, forbid=TRANSFER_PRIMITIVES,
    # the 5-iteration TRON's read-backs (ROADMAP speed item 1), pinned so
    # they can only fall: a CG step's stop flag (optim/tron.py:184, 16
    # here), the start (:217), an iteration's accept flag (:231) and done
    # flag (:254); the bare solve's count is the equality
    max_syncs={"cuda": 27, "cpu": 27}, tags=("resident", "checkpoint"))
def _contract_checkpoint_off_tron_free(device):
    from photon_tpu_torch.models.training import _contract_resident_problem
    from photon_tpu_torch.optim.tron import minimize_tron_margin
    from photon_tpu_torch.telemetry.taps import tap_disabled

    cfg, obj, batch, w0 = _contract_resident_problem(device)

    def bare(b, w, o):
        return minimize_tron_margin(o, b, w, max_iters=cfg.max_iters)

    def fn(b, w, o):
        with tap_disabled(), snapshot_tap_disabled():
            return bare(b, w, o)

    return fn, (batch, w0, obj), bare
