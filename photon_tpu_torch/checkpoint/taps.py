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
           "snapshot_tap_disabled", "resident_restore"]

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
