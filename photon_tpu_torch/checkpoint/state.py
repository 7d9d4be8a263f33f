"""Versioned solver-state snapshots: the process-wide checkpoint session
(port of `photon_tpu/checkpoint/state.py`).

One process-wide :class:`CheckpointSession` the instrumented host loops
report into, armed by the driver (``checkpoint.session(...)`` /
``start_session``), with every hot-path touch point guarded by a single
``checkpoint.current() is None`` branch: a session-less process pays one
global load per call site.

What a snapshot holds — the full solver state of every live scope, at the
last consistent cut each contributor reported:

- streamed L-BFGS / OWL-QN (`optim/streamed.py`): the iterate ``w``, the
  gradient, the circular (S, Y, rho) curvature history with its cursor,
  the per-chunk cached margins (``z``) with their refresh generation, the
  loss/grad histories, the convergence flags and the evaluation counts —
  the complete iteration-boundary state, so a resumed run replays the
  next iteration bit for bit.
- GAME (`game/coordinate_descent.py` + `game/random_effect.py`): the
  models, scores and objective history after each completed coordinate
  update, plus — inside a live random-effect update — the coefficient
  array, per-entity iteration counts and convergence, and the
  retired-bucket cursor (the in-flight buckets are not snapshotted:
  retire order equals dispatch order, so "buckets 0..k retired" is a
  consistent cut and the un-retired tail re-dispatches on resume).
- resident solvers (`checkpoint/taps.py`): a last-iterate (w, f, |g|,
  TRON's trust radius) through the opt-in tap — a warm start for the next
  attempt, not a mid-solve resume.

THE COPY AT ``update()``. A snapshot holds the values at the cut, and the
contributors go on mutating their buffers (the L-BFGS history is written
in place). The reference fetches every array to the host at each
update. Here a tensor is CLONED ON ITS OWN DEVICE at ``update()`` (a
device-to-device copy: ~0.3 ms for the ~490 MB of a streamed solve at
10M features), numpy arrays are copied, and the device-to-host fetch
happens only when a snapshot is taken — on the writer thread when the
session is asynchronous, else inside ``snapshot()``. An iteration whose
cadence does not fire pays the clones alone; the previous cut's clones
are freed as the next replaces them.

Snapshots are taken at iteration/bucket/update boundaries only, so
cadence (wall clock or evaluation count) never changes the numbers a
resumed run produces. Row caches pack in global row order
(`pack_rows`) or, the multi-process form, one entry per mesh slot keyed
``{prefix}@s{slot:04d}`` (`pack_row_slots`), so each process writes only
its own slots and a snapshot from any process count or mesh restores at
any other (`unpack_row_slots` re-slices the global rows to the resuming
layout's local slots). GAME's descent on a mesh needs no slot entries:
after each bucket's gather and each fixed effect's gathered score every
process holds the whole coefficient tables, score caches and counts in
global row and entity order, so they are replicated entries (process 0
writes them) and a snapshot from one mesh restores onto another or onto
one device. A session of several processes snapshots by evaluation
count: its ranks cut at the same iteration boundaries, which a
wall-clock cadence would not give them.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint.store import (AsyncSnapshotWriter,
                                               SnapshotSchemaError,
                                               SnapshotStore)

__all__ = ["SCHEMA_VERSION", "CheckpointSession", "SnapshotStateError",
           "SnapshotSchemaError", "pack_rows", "unpack_rows",
           "pack_row_slots", "unpack_row_slots"]

# Bump on ANY layout change to the per-scope payloads. Restore refuses
# schemas NEWER than this with a clear error (store.load_latest); v2
# row caches are per-device-slot entries (`pack_row_slots`), v1
# single-key payloads still restore.
SCHEMA_VERSION = 2


class SnapshotStateError(ValueError):
    """Restored state that does not fit the resuming program (wrong
    solver, problem shape, chunking, or iteration budget) — refused with
    the mismatch spelled out instead of resuming into silent drift."""


def _rows(local) -> np.ndarray:
    if isinstance(local, torch.Tensor):
        local = local.detach().cpu().numpy()
    return np.asarray(local)


# ----------------------------------------------------- row-cache layout
def pack_rows(local, mesh, n_rows: int) -> np.ndarray:
    """The global row vector of a per-row cache: its first ``n_rows``
    rows, copied, as f32. ``local`` is a flat ``(rows,)`` array or
    tensor, or under a mesh this process's ``(n_local_slots, s)`` stack
    (`parallel.mesh.fetch_local_rows`), placed at its slots' global rows
    (other processes' rows stay zero)."""
    if mesh is None:
        return np.array(_rows(local)[:n_rows], dtype=np.float32)
    local = _rows(local)
    s = local.shape[1]
    out = np.zeros((mesh.n_slots * s,), np.float32)
    for k, j in enumerate(mesh.local_slots):
        out[j * s:(j + 1) * s] = local[k]
    return np.array(out[:n_rows])


def unpack_rows(z_global, mesh, pad_rows: int) -> np.ndarray:
    """Inverse of :func:`pack_rows` onto a (possibly different) layout:
    the global rows zero-padded to ``pad_rows`` (pad rows carry weight 0
    in every batch, so their values never enter a reduction), re-sliced
    under a mesh into this process's ``(n_local_slots, s)`` stack."""
    z_global = np.asarray(z_global, np.float32)
    buf = np.zeros((int(pad_rows),), np.float32)
    buf[:z_global.shape[0]] = z_global
    if mesh is None:
        return buf
    stack = buf.reshape(mesh.n_slots, int(pad_rows) // mesh.n_slots)
    return np.array(stack[list(mesh.local_slots)])


def pack_row_slots(local, mesh, n_rows: int, prefix: str) -> dict:
    """The snapshot form of a per-row cache: one entry per device slot
    this process owns, keyed ``{prefix}@s{slot:04d}`` — unique across
    processes, so each ``meta_p<k>.json`` references only files its own
    process wrote and a restore unions the full slot set. Under a mesh
    ``local`` is the ``(n_local_slots, s)`` stack; on one device the one
    slot 0 carries the rows trimmed to ``n_rows``. A tensor stays a
    tensor (the session clones it at ``update()``)."""
    if mesh is not None:
        if isinstance(local, torch.Tensor):
            return {f"{prefix}@s{j:04d}": local[k]
                    for k, j in enumerate(mesh.local_slots)}
        local = np.asarray(local)
        return {f"{prefix}@s{j:04d}": np.array(local[k], dtype=np.float32)
                for k, j in enumerate(mesh.local_slots)}
    if isinstance(local, torch.Tensor):
        return {f"{prefix}@s0000": local.reshape(-1)[:n_rows]}
    return {f"{prefix}@s0000":
            np.array(np.asarray(local)[:n_rows], dtype=np.float32)}


def unpack_row_slots(payload: dict, prefix: str, mesh, pad_rows: int,
                     n_rows: int) -> np.ndarray:
    """Inverse of :func:`pack_row_slots` onto ANY layout (process count
    and mesh may both differ from the writing run's): slot entries (from
    every process of a multi-process run) concatenate slot-major into the
    global row order, trim to ``n_rows`` (the writing layout's pad rows
    drop), re-pad to ``pad_rows`` and re-slice to this layout
    (`unpack_rows`). Falls back to a v1 single-key ``prefix`` entry."""
    if prefix in payload:  # schema v1: one packed global vector
        return unpack_rows(_rows(payload[prefix])[:n_rows], mesh, pad_rows)
    tag = f"{prefix}@s"
    keys = sorted(k for k in payload if k.startswith(tag))
    if not keys:
        raise SnapshotStateError(
            f"snapshot payload has no {prefix!r} row-slot entries "
            f"(keys: {sorted(payload)[:8]}...)")
    z = np.concatenate([_rows(payload[k]).astype(np.float32).ravel()
                        for k in keys])
    return unpack_rows(z[:n_rows], mesh, pad_rows)


def _copy_value(v):
    """A payload value by VALUE at ``update()`` time: tensors are cloned
    on their own device (fetched to the host only when a snapshot is
    taken), numpy is copied, scalars and json-ables pass through."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, np.ndarray):
        return np.array(v, copy=True)
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


def _ready_event(state: dict):
    """A CUDA event recorded now on the current stream of the state's
    device tensors (the stream their clones were taken on), or None: the
    fetch of the clones waits for it and nothing else."""
    for payload in state.values():
        for v in payload.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                return torch.cuda.current_stream(v.device).record_event()
    return None


class CheckpointSession:
    """One run's crash-consistency state: live per-scope payloads, the
    restore image, cadence, and the (async) writer.

    - ``every_s`` / ``every_evals``: snapshot cadence by wall clock and/or
      evaluation count (whichever fires first; None disables that axis).
      ``maybe_snapshot()`` is called by contributors at their consistent
      cuts, so cadence only chooses WHICH boundary commits — never the
      numbers a resume produces.
    - ``resume=True`` loads the store's last committed snapshot (if any)
      as the restore image; contributors claim their piece via
      ``restore(leaf)`` exactly once each.
    - ``async_writer=True`` commits on a daemon thread (the clones at
      ``update()`` are the consistency point; the host fetch and the
      fsync/rename ride the thread).
    - ``resident_tap=True`` arms the resident solvers' last-iterate tap
      (`taps.snapshot_tap`), which is otherwise one flag check.

    Under several processes (`parallel.mesh.initialize_distributed`) the
    cadence must be by evaluations (``every_s=None``): every rank then
    snapshots at the same cut, and the store's barriers pair them up.
    """

    def __init__(self, store, *, every_s: Optional[float] = 30.0,
                 every_evals: Optional[int] = None, resume: bool = True,
                 async_writer: bool = True, keep: int = 2,
                 resident_tap: bool = False):
        from photon_tpu_torch.parallel.mesh import distributed_client

        dist = distributed_client()
        if dist is not None and dist["world"] > 1 and every_s is not None:
            raise ValueError(
                "a multi-process checkpoint session snapshots by evaluation "
                "count: pass every_s=None (with every_evals) — ranks "
                "deciding by their own clocks would cut at different "
                "iterations and split the store's commit barriers")
        if not isinstance(store, SnapshotStore):
            store = SnapshotStore(store, keep=keep)
        self.store = store
        self.every_s = every_s
        self.every_evals = every_evals
        self._lock = threading.Lock()
        self._state: dict = {}
        self._scope: list = []
        self._invocations: dict = {}
        self._restored: Optional[dict] = None
        self._restored_manifest: Optional[dict] = None
        self._closed = False
        self.resident_tap = bool(resident_tap)
        if resume:
            loaded = self.store.load_latest()
            if loaded is not None:
                self._restored, self._restored_manifest = loaded
                # seed the live state so an early snapshot after resume
                # still carries the outer scopes' progress
                self._state = {p: dict(v)
                               for p, v in self._restored.items()}
                telemetry.count("checkpoint.restores")
        self._seq = self.store.latest_seq() + 1
        self._writer = AsyncSnapshotWriter(self.store) if async_writer \
            else None
        self._last_snap_t = time.perf_counter()
        self._evals = 0

    # --------------------------------------------------------------- scoping
    @contextlib.contextmanager
    def scope(self, name: str):
        """Nest subsequent update/restore paths under ``name`` (the GAME
        descent scopes each coordinate update so state never collides
        across updates, sweeps, or grid points)."""
        self._scope.append(str(name))
        try:
            yield self
        finally:
            self._scope.pop()

    def path(self, leaf: str) -> str:
        return "/".join(self._scope + [str(leaf)])

    def invocation(self, tag: str) -> int:
        """Deterministic per-tag call counter (scoping repeated identical
        invocations, e.g. duplicate grid points)."""
        n = self._invocations.get(tag, 0)
        self._invocations[tag] = n + 1
        return n

    # ----------------------------------------------------------- state edits
    def update(self, leaf: str, payload: dict) -> None:
        """Report a scope's state at a consistent cut (copied by value)."""
        self.update_absolute(self.path(leaf), payload)

    def update_absolute(self, path: str, payload: dict) -> None:
        """`update` at an absolute path (the resident tap reports outside
        any scope stack)."""
        packed = {k: _copy_value(v) for k, v in payload.items()}
        with self._lock:
            self._state[str(path)] = packed

    def clear(self, leaf: Optional[str] = None, prefix: bool = False) -> None:
        """Drop a completed scope's state (``prefix=True`` drops every
        path under it) from live state AND the restore image — a finished
        unit must never be restored again."""
        base = self.path(leaf) if leaf is not None else "/".join(self._scope)
        with self._lock:
            for d in (self._state, self._restored):
                if d is None:
                    continue
                if prefix:
                    for k in [k for k in d
                              if k == base or k.startswith(base + "/")]:
                        del d[k]
                else:
                    d.pop(base, None)

    # -------------------------------------------------------------- restore
    def restore(self, leaf: str) -> Optional[dict]:
        """The restore image's payload for this scope path (or None).
        Consumed once: a second call returns None, so re-entered loops
        after completion start fresh."""
        return self.restore_absolute(self.path(leaf))

    def restore_absolute(self, path: str) -> Optional[dict]:
        """`restore` at an absolute path."""
        if self._restored is None:
            return None
        with self._lock:
            payload = self._restored.pop(str(path), None)
        if payload is not None:
            telemetry.count("checkpoint.scope_restores")
        return payload

    def restored_any(self) -> bool:
        return self._restored_manifest is not None

    # -------------------------------------------------------------- cadence
    def note_evaluations(self, n: int = 1) -> None:
        self._evals += int(n)

    def due(self) -> bool:
        if self.every_evals is not None and self._evals >= self.every_evals:
            return True
        if self.every_s is not None and \
                time.perf_counter() - self._last_snap_t >= self.every_s:
            return True
        return False

    def maybe_snapshot(self) -> bool:
        """Snapshot iff the cadence says so. Contributors call this at
        every consistent cut."""
        if not self.due():
            return False
        self.snapshot()
        return True

    def snapshot(self, block: bool = False) -> int:
        """Commit the current state as the next snapshot. The values are
        the clones ``update()`` took, which nothing mutates; the host
        fetch and the fsync/rename ride the writer thread unless
        ``block`` or the session is synchronous."""
        t0 = time.perf_counter()
        with self._lock:
            state = {p: dict(v) for p, v in self._state.items()}
            seq = self._seq
            self._seq += 1
        meta = {"created_unix": time.time()}
        ready = _ready_event(state)
        if self._writer is not None:
            self._writer.submit(state, seq, meta, ready=ready)
            if block:
                self._writer.drain()
        else:
            self.store.commit(state, seq, meta, ready=ready)
        telemetry.count("checkpoint.pack_seconds", time.perf_counter() - t0)
        self._last_snap_t = time.perf_counter()
        self._evals = 0
        return seq

    # ----------------------------------------------------------------- close
    def close(self, final_snapshot: bool = False) -> None:
        """Drain the writer (optionally committing one final snapshot).
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            if final_snapshot:
                self.snapshot(block=True)
            if self._writer is not None:
                self._writer.close()
        finally:
            self._writer = None
