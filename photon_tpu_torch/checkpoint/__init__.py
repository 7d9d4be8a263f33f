"""Elastic runs: crash-consistent checkpoint/restore and fault injection
(port of `photon_tpu/checkpoint`).

The host-driven regimes (the streamed solvers, GAME's block loop and
coordinate descent) have no lineage to replay, so this package makes
long runs restartable explicitly:

- `state.py` — the process-wide :class:`CheckpointSession`: versioned,
  schema-tagged snapshots of full solver state (L-BFGS/OWL-QN curvature
  history, iterate, streamed margin caches; GAME coordinate and bucket
  progress; a resident solver's last iterate through the tap).
- `store.py` — crash-consistent storage: temp + fsync + rename commits,
  manifest-pointer snapshot directories with retention, an async writer
  thread. The layout is the reference's: either package loads the
  other's snapshot directories.
- `faults.py` — deterministic kill-point injection and retry with backoff
  for host IO.
- `taps.py` — the opt-in resident-solver last-iterate tap, one flag
  check when disarmed.

::

    from photon_tpu_torch import checkpoint

    with checkpoint.session("ckpt_dir", every_s=60):
        train_glm(chunked, task, cfg)        # snapshots ride the solve
    # ...process dies, restarts...
    with checkpoint.session("ckpt_dir"):     # resume=True by default
        train_glm(chunked, task, cfg)        # finishes bit for bit

THE OFF-STATE CONTRACT: every hot-path touch point starts with one
``checkpoint.current() is None`` branch (or the tap's flag check), so a
session-less run makes no copy, no read-back and no launch it would not
make anyway.

Bit-identical resume holds on the same card with the same chunking (the
same ``ChunkedBatch`` chunk height, the same GAME buckets). A mesh
solve's row caches snapshot per slot and restore on the same mesh at any
process count, bit for bit; several processes commit one snapshot
together (`store.py`: the begin and commit barriers, bounded by
``PHOTON_TPU_BARRIER_TIMEOUT_S``), and a session of several processes
snapshots by evaluation count.

CLI: ``python -m photon_tpu_torch.checkpoint --selftest [--json]`` runs
an in-process snapshot → kill → restore → bit-parity proof and exits 1 on
drift.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from photon_tpu_torch.checkpoint.faults import (  # noqa: F401
    FaultPlan,
    InjectedFault,
    TransientIOError,
    arm_faults,
    current_plan,
    disarm_faults,
    fault_plan,
    kill_point,
    record_sites,
    retry_io,
)
from photon_tpu_torch.checkpoint.state import (  # noqa: F401
    SCHEMA_VERSION,
    CheckpointSession,
    SnapshotSchemaError,
    SnapshotStateError,
    pack_row_slots,
    pack_rows,
    unpack_row_slots,
    unpack_rows,
)
from photon_tpu_torch.checkpoint.store import (  # noqa: F401
    AsyncSnapshotWriter,
    SnapshotStore,
    commit_bytes,
    replace_committed,
)
from photon_tpu_torch.checkpoint.taps import (  # noqa: F401
    resident_off_is_free,
    resident_restore,
    set_snapshot_tap,
    snapshot_tap,
    snapshot_tap_disabled,
    snapshot_tap_enabled,
)

__all__ = [
    "SCHEMA_VERSION", "CheckpointSession", "SnapshotStore",
    "SnapshotSchemaError", "SnapshotStateError", "AsyncSnapshotWriter",
    "commit_bytes", "replace_committed", "pack_rows", "unpack_rows",
    "pack_row_slots", "unpack_row_slots",
    "FaultPlan", "InjectedFault", "TransientIOError", "arm_faults",
    "disarm_faults", "fault_plan", "current_plan", "kill_point",
    "record_sites", "retry_io",
    "start_session", "finish_session", "session", "current", "enabled",
    "snapshot_tap", "snapshot_tap_enabled", "set_snapshot_tap",
    "snapshot_tap_disabled", "resident_restore", "resident_off_is_free",
]

_CURRENT: Optional[CheckpointSession] = None
_ATTACH_LOCK = threading.Lock()


def start_session(store, **kwargs) -> CheckpointSession:
    """Create a CheckpointSession (``store``: a SnapshotStore or a
    directory path) and attach it process-wide. One session at a time —
    starting a new one closes the old."""
    global _CURRENT
    with _ATTACH_LOCK:
        if _CURRENT is not None:
            _CURRENT.close()
        s = CheckpointSession(store, **kwargs)
        _CURRENT = s
        set_snapshot_tap(s.resident_tap)
    return s


def finish_session(final_snapshot: bool = False) -> None:
    """Close and detach the current session (draining the async writer)."""
    global _CURRENT
    with _ATTACH_LOCK:
        s, _CURRENT = _CURRENT, None
        set_snapshot_tap(False)
    if s is not None:
        s.close(final_snapshot=final_snapshot)


@contextlib.contextmanager
def session(store, **kwargs):
    """``with checkpoint.session(dir, every_s=60) as s:`` — scoped
    start_session/finish_session."""
    s = start_session(store, **kwargs)
    try:
        yield s
    finally:
        if _CURRENT is s:
            finish_session()
        else:
            s.close()


def current() -> Optional[CheckpointSession]:
    return _CURRENT


def enabled() -> bool:
    return _CURRENT is not None
