"""Crash-consistent file commits (the `commit_bytes` and
`replace_committed` part of `photon_tpu/checkpoint/store.py`, with its
``commit`` fault site; snapshots and sessions wait for ROADMAP queue A
item 11).

`commit_bytes` writes to a same-directory temp name, flushes and fsyncs
the file, ``os.replace``s it onto the final name and fsyncs the
directory: readers see the old bytes or the new bytes, never a torn
write. `replace_committed` publishes a temp file its writer already
wrote. Both hit `faults.kill_point("commit")` in the widest window,
after the temp write and before the rename.
"""
from __future__ import annotations

import os

from photon_tpu_torch.checkpoint import faults


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
