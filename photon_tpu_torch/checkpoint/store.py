"""Crash-consistent snapshot storage: temp + fsync + rename commits, a
manifest-pointer snapshot layout, an async writer thread, retention, and
the multi-process commit (port of `photon_tpu/checkpoint/store.py`).

The durability protocol, smallest piece first:

- :func:`commit_bytes` — the one commit primitive of the package: write
  to a same-directory temp name, flush + fsync the file, ``os.replace``
  onto the final name, fsync the directory. Readers see the old bytes or
  the new bytes, never a torn write. `replace_committed` publishes a temp
  file its writer already wrote. Both hit `faults.kill_point("commit")`
  in the widest window, after the temp write and before the rename.
- :class:`SnapshotStore` — numbered snapshot directories
  (``snap_00000007/`` holding one ``.npy`` per state array and a
  ``meta_p0.json``) committed by atomically replacing the store-level
  ``MANIFEST.json`` pointer LAST. A kill anywhere before the manifest
  replace leaves the previous manifest intact, so restore falls back to
  the last fully committed snapshot; the ``snapshot_write`` fault site
  sits exactly in that window. Retention deletes old snapshot
  directories only after the new manifest commits (a crash between the
  two leaves unreferenced orphans, never a dangling pointer; orphans go
  on the next commit).
- :class:`AsyncSnapshotWriter` — a daemon thread draining a FIFO queue,
  so the fsync/rename latency (and the device-to-host copy of the
  session's device clones, `state.CheckpointSession`) overlaps the next
  iteration.

The layout is the reference's, byte for byte in its structure
(``SCHEMA_VERSION`` 2, ``p<process>_<idx>.npy`` payloads, the same
manifest format), so a snapshot directory written by either package
loads in the other.

Multi-process (a live `parallel.mesh` process group): every process
writes its payload under its own ``p<k>_`` prefix and ``meta_p<k>.json``
into the same snapshot directory (shared storage); rank 0 alone writes
the replicated entries (a process other than 0 writes only its
slot-keyed ``@s<slot>`` row caches). No payload is written until rank 0
has swept a dead attempt's leftovers (barrier ``photon_ckpt_begin_<seq>``),
and rank 0 replaces the manifest only after every rank's payloads are
durable (barrier ``photon_ckpt_commit_<seq>``). Both barriers are
bounded by ``PHOTON_TPU_BARRIER_TIMEOUT_S``: a rank that dies between
its payload and the commit barrier makes the survivors' commit fail
loudly, and the manifest still points at the last whole snapshot.
Restore merges every ``meta_p<k>.json`` it finds (first process wins for
an entry several wrote), so a snapshot written at one process count
loads at any other.

Snapshot reads and writes ride :func:`faults.retry_io` (site
``snapshot_io``): transient storage hiccups back off and retry.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint import faults

__all__ = ["commit_bytes", "fsync_dir", "replace_committed",
           "SnapshotStore", "AsyncSnapshotWriter", "SnapshotSchemaError"]

_MANIFEST = "MANIFEST.json"
_FORMAT = "photon_tpu-snapshot-store-v1"


class SnapshotSchemaError(ValueError):
    """A snapshot this build cannot read (e.g. written by a newer
    photon-tpu): a clear refusal, never a pickle or shape explosion."""


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (best-effort on filesystems without directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def commit_bytes(path: str, data: bytes) -> None:
    """Atomically commit ``data`` at ``path``: same-dir temp file, flush +
    fsync, rename, directory fsync. A kill at any point leaves either the
    old file or the new file — never a truncated one. (The ``commit``
    fault site sits in the widest window, after the temp write.)"""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    faults.kill_point("commit")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def replace_committed(tmp: str, path: str) -> None:
    """Commit an already-written temp FILE (fsync it first, then rename +
    dir fsync) — for writers that must stream to their own path (index
    maps, staged store payloads) before the atomic publish."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    faults.kill_point("commit")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


_FETCH_STREAMS: dict = {}
_FETCH_LOCK = threading.Lock()


def _fetch_cuda(t: torch.Tensor, ready=None) -> np.ndarray:
    """A device tensor's values on the host, copied on a side stream of
    its own into pinned memory, after ``ready`` (the CUDA event the
    session recorded when it took the snapshot; else the current
    stream): the copy engine overlaps whatever the solver enqueues
    meanwhile (the tensor is a session clone nothing mutates)."""
    dev = t.device
    with _FETCH_LOCK:
        side = _FETCH_STREAMS.get(dev)
        if side is None:
            side = _FETCH_STREAMS[dev] = torch.cuda.Stream(dev)
    if ready is not None:
        side.wait_event(ready)
    else:
        side.wait_stream(torch.cuda.current_stream(dev))
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        out.copy_(t, non_blocking=True)
    side.synchronize()
    return out.numpy()


def _host(v, ready=None):
    """A payload value as the store writes it: a tensor (a session's
    device or host clone) becomes its numpy values."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return _fetch_cuda(v, ready) if v.is_cuda else v.numpy()
    return v


def _process_count() -> int:
    from photon_tpu_torch.parallel.mesh import distributed_client

    c = distributed_client()
    return 1 if c is None else int(c["world"])


def _process_index() -> int:
    from photon_tpu_torch.parallel.mesh import distributed_client

    c = distributed_client()
    return 0 if c is None else int(c["rank"])


def _barrier(tag: str) -> None:
    """A commit barrier: a no-op for one process; else every rank waits
    for all, within ``PHOTON_TPU_BARRIER_TIMEOUT_S`` — a dead or late
    peer RAISES here (`parallel.mesh.cluster_barrier`), so a
    half-written snapshot fails the commit loudly and the previous
    manifest stays the restore point."""
    if _process_count() > 1:
        from photon_tpu_torch.parallel.mesh import cluster_barrier

        cluster_barrier(tag)


def _per_process(key: str) -> bool:
    """A slot-keyed row-cache entry (``<prefix>@s<slot>``), written by the
    process that owns the slot; every other entry is replicated and
    written by rank 0 alone."""
    return "@s" in key


def _write_fsync(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _write_npy(path: str, arr: np.ndarray) -> int:
    """``arr`` as a durable ``.npy`` file; its size in bytes."""
    with open(path, "wb") as f:
        np.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


class SnapshotStore:
    """Numbered, manifest-committed snapshots of a state dict.

    State shape: ``{path: {key: array | json-able scalar/list}}`` — the
    flat face of `state.CheckpointSession`'s live registry. Arrays (numpy,
    or tensors, fetched here) land one ``.npy`` per (path, key);
    everything else inlines into ``meta_p0.json``.
    """

    def __init__(self, root: str, keep: int = 2):
        self.root = os.fspath(root)
        self.keep = max(int(keep), 1)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.root, _MANIFEST)

    def read_manifest(self) -> Optional[dict]:
        path = self._manifest_path()
        if not os.path.exists(path):
            return None

        def _read():
            with open(path) as f:
                return json.load(f)

        return faults.retry_io(_read, site="snapshot_io")

    def latest_seq(self) -> int:
        """Sequence number of the last committed snapshot (-1 if none)."""
        m = self.read_manifest()
        return -1 if m is None else int(m["seq"])

    # -------------------------------------------------------------- commit
    def commit(self, state: dict, seq: int, meta: Optional[dict] = None,
               schema: Optional[int] = None, ready=None) -> str:
        """Write snapshot ``seq`` and commit it via the manifest pointer
        (multi-process: every rank its payloads, rank 0 the manifest after
        the barrier). ``ready``: a CUDA event after which the state's
        device tensors hold their values. Returns the snapshot
        directory's name."""
        from photon_tpu_torch.checkpoint.state import SCHEMA_VERSION

        schema = SCHEMA_VERSION if schema is None else int(schema)
        name = f"snap_{seq:08d}"
        snap_dir = os.path.join(self.root, name)
        proc = _process_index()
        if proc == 0 and os.path.isdir(snap_dir):
            # leftovers of a dead uncommitted attempt at this seq — other
            # ranks' payloads (of any process count) included
            shutil.rmtree(snap_dir, ignore_errors=True)
        # nobody writes until rank 0's sweep is done
        _barrier(f"photon_ckpt_begin_{seq}")
        os.makedirs(snap_dir, exist_ok=True)

        entries: dict = {}
        n_bytes = 0
        idx = 0
        t0 = time.perf_counter()
        with telemetry.span("checkpoint.write", seq=seq):
            for path in sorted(state):
                payload = state[path]
                entry: dict = {}
                for key in sorted(payload):
                    if proc and not _per_process(key):
                        continue  # replicated: rank 0 writes it
                    v = _host(payload[key], ready)
                    if isinstance(v, np.ndarray):
                        fname = f"p{proc}_{idx:05d}.npy"
                        idx += 1
                        fpath = os.path.join(snap_dir, fname)
                        n_bytes += faults.retry_io(
                            lambda a=v, p=fpath: _write_npy(p, a),
                            site="snapshot_io")
                        entry[key] = {"file": fname}
                    else:
                        entry[key] = {"json": v}
                entries[path] = entry
            meta_obj = {"format": _FORMAT, "schema": schema, "seq": seq,
                        "process": proc, "entries": entries}
            if meta:
                meta_obj["meta"] = meta
            meta_bytes = json.dumps(meta_obj).encode()
            n_bytes += len(meta_bytes)
            faults.retry_io(
                lambda: _write_fsync(
                    os.path.join(snap_dir, f"meta_p{proc}.json"),
                    meta_bytes),
                site="snapshot_io")
            fsync_dir(snap_dir)
            # THE mid-write kill window: payloads durable, pointer not yet
            # moved — a death here must restore from the PREVIOUS manifest.
            faults.kill_point("snapshot_write")
            _barrier(f"photon_ckpt_commit_{seq}")
            if proc == 0:
                manifest = {"format": _FORMAT, "schema": schema, "seq": seq,
                            "latest": name}
                faults.retry_io(
                    lambda: commit_bytes(self._manifest_path(),
                                         json.dumps(manifest).encode()),
                    site="snapshot_io")
                self._gc(keep_name=name)
        telemetry.count("checkpoint.snapshots")
        telemetry.count("checkpoint.bytes", n_bytes)
        telemetry.count("checkpoint.commit_seconds",
                        time.perf_counter() - t0)
        return name

    def _gc(self, keep_name: str) -> None:
        """Retention AFTER the manifest commit: keep the newest ``keep``
        snapshot dirs (by seq), delete the rest — including uncommitted
        orphans a previous death left behind."""
        dirs = sorted(d for d in os.listdir(self.root)
                      if d.startswith("snap_")
                      and os.path.isdir(os.path.join(self.root, d)))
        doomed = [d for d in dirs[:-self.keep] if d != keep_name] \
            if len(dirs) > self.keep else []
        for d in doomed:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
        if doomed:
            telemetry.count("checkpoint.gc_snapshots", len(doomed))

    # --------------------------------------------------------------- restore
    def load_latest(self) -> Optional[tuple]:
        """(state, manifest) of the last COMMITTED snapshot, or None.

        Merges every process prefix found in the snapshot dir. Raises
        :class:`SnapshotSchemaError` on a snapshot whose schema is newer
        than this build understands."""
        from photon_tpu_torch.checkpoint.state import SCHEMA_VERSION

        manifest = self.read_manifest()
        if manifest is None:
            return None
        if manifest.get("format") != _FORMAT:
            raise SnapshotSchemaError(
                f"{self.root}: manifest format "
                f"{manifest.get('format')!r} is not {_FORMAT!r}")
        if int(manifest.get("schema", 0)) > SCHEMA_VERSION:
            raise SnapshotSchemaError(
                f"snapshot schema v{manifest['schema']} is newer than this "
                f"build's v{SCHEMA_VERSION}: resume with a photon-tpu at "
                "least as new as the one that wrote the checkpoint (or "
                "start fresh with a new --checkpoint-dir)")
        snap_dir = os.path.join(self.root, manifest["latest"])
        state: dict = {}
        metas = sorted(f for f in os.listdir(snap_dir)
                       if f.startswith("meta_p") and f.endswith(".json"))
        if not metas:
            raise SnapshotSchemaError(
                f"{snap_dir}: committed snapshot has no meta files")
        for mf in metas:

            def _read(path=os.path.join(snap_dir, mf)):
                with open(path) as f:
                    return json.load(f)

            meta = faults.retry_io(_read, site="snapshot_io")
            if int(meta.get("schema", 0)) > SCHEMA_VERSION:
                raise SnapshotSchemaError(
                    f"snapshot schema v{meta['schema']} is newer than "
                    f"this build's v{SCHEMA_VERSION}")
            for path, entry in meta["entries"].items():
                payload = state.setdefault(path, {})
                for key, spec in entry.items():
                    if key in payload:
                        continue  # replicated entry: first process wins
                    if "file" in spec:
                        fpath = os.path.join(snap_dir, spec["file"])
                        payload[key] = faults.retry_io(
                            lambda p=fpath: np.load(p, allow_pickle=False),
                            site="snapshot_io")
                    else:
                        payload[key] = spec["json"]
        return state, manifest


class AsyncSnapshotWriter:
    """FIFO snapshot writer on a daemon thread: `submit` enqueues a state
    dict whose values the caller no longer mutates (the session's clones —
    the consistency point), the thread fetches device values to the host
    and pays the fsync/rename latency. An error on the thread is
    remembered and raised again at the next `submit`, `drain` or `close`,
    so a dying disk fails the run loudly instead of silently dropping
    snapshots."""

    def __init__(self, store: SnapshotStore):
        self.store = store
        self._q: queue.Queue = queue.Queue()
        # _err crosses the writer-thread/caller boundary: the writer
        # stores, callers read-and-clear, under the lock
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="photon-ckpt-writer")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            state, seq, meta, ready = item
            try:
                self.store.commit(state, seq, meta, ready=ready)
            except BaseException as e:  # noqa: BLE001 — raised at submit
                with self._err_lock:
                    self._err = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def submit(self, state: dict, seq: int, meta: Optional[dict] = None,
               ready=None) -> None:
        self._check()
        self._q.put((state, seq, meta, ready))

    def drain(self) -> None:
        """Block until every queued snapshot is committed."""
        self._q.join()
        self._check()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._q.put(None)
            self._thread.join(timeout=10.0)
