"""Crash-consistent file commits (the `commit_bytes` part of
`photon_tpu/checkpoint/store.py`; snapshots, sessions and the ``commit``
fault site wait for ROADMAP queue A item 11).

`commit_bytes` writes to a same-directory temp name, flushes and fsyncs
the file, ``os.replace``s it onto the final name and fsyncs the
directory: readers see the old bytes or the new bytes, never a torn
write.
"""
from __future__ import annotations

import os


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
    old file or the new file — never a truncated one."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
