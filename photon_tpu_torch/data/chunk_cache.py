"""Decode-once columnar chunk cache (the port's copy of
`photon_tpu/data/chunk_cache.py`; a ``game_chunks`` entry either package
writes has the same key, manifest and arrays).

Reference parity: the GLMix production pipeline (Zhang et al., KDD'16)
preprocesses its Avro training data ONCE into a reusable columnar form and
every subsequent run reads that, never the raw records. Here: the chunk stream a cold decode produces (`data.streaming.
iter_game_chunks` output — scalars, per-shard dense/SparseRows arrays,
entity-id columns, response masks) is committed to disk as one mmap-able
``.npy`` file per array plus a MANIFEST.json, and a second epoch or a
re-run opens the mmap'd chunks and never touches Avro again.

Durability:

- payload arrays are written + fsync'd FIRST, the manifest is committed
  LAST through :func:`checkpoint.store.commit_bytes` — a kill anywhere
  before the manifest commit leaves a manifest-less directory, which
  reads as a MISS (the ingest plane falls back to Avro decode), never as
  a torn cache serving a partial chunk. Both IO edges ride
  :func:`checkpoint.faults.retry_io` (sites ``cache_open`` /
  ``cache_commit``), so transient storage hiccups back off and the fault
  matrix can kill mid-commit deterministically.
- a manifest written by a NEWER build is refused with
  :class:`ChunkCacheSchemaError`, never mis-read.

Keys: :func:`cache_key` hashes the source files' fingerprints
(name/size/mtime), the full `GameDataConfig`, every frozen index map's
key order, and the chunk layout (chunk_rows / sparse_k / kind) — change
any of them and the cache misses, re-decodes, and commits a fresh entry
under a new key. Corrupted payloads are caught by a per-file CRC32
verified on first access (:class:`ChunkCacheCorrupt`).

Two entry kinds:

- ``game_chunks`` — the GameData chunk sequence (the general training /
  streaming read path);
- ``ladder`` — a finished blocked-ELL chunk ladder (`ChunkedBatch` from
  `data.dataset.chunk_blocked_ell`), so the EXPENSIVE global-permutation
  sparse layout build also happens once, off the training critical path.
  Its chunks are torch tensors: a bf16 one is stored as its int16 bits
  with the dtype in the manifest, and the column permutation the chunks
  share is stored once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import zlib
from typing import Optional

import numpy as np

import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint import faults
from photon_tpu_torch.checkpoint.store import commit_bytes

__all__ = [
    "CACHE_FORMAT", "CACHE_SCHEMA_VERSION", "ChunkCacheSchemaError",
    "ChunkCacheCorrupt", "cache_key", "index_map_digest", "ChunkCacheWriter",
    "CachedBag", "open_cache", "save_game_chunks_start", "save_ladder",
    "open_ladder", "iter_cached_chunks", "shard_chunk_range",
]


def shard_chunk_range(n_chunks: int, process: int,
                      n_processes: int) -> tuple[int, int]:
    """The canonical per-process chunk split of the distributed cache
    convention: contiguous ``[lo, hi)`` chunk-index ranges in process
    order (the first ``n_chunks % n_processes`` processes take one
    extra). Each process decodes + `add_array`s ONLY its range — chunk-
    indexed array names stay globally unique, and concatenating the
    per-process entries in process order recovers the serial chunk
    order exactly."""
    if not 0 <= process < n_processes:
        raise ValueError(f"process {process} out of range for "
                         f"{n_processes}")
    base, extra = divmod(int(n_chunks), int(n_processes))
    lo = process * base + min(process, extra)
    return lo, lo + base + (1 if process < extra else 0)

CACHE_FORMAT = "photon_tpu-chunk-cache-v1"
CACHE_SCHEMA_VERSION = 1
_MANIFEST = "MANIFEST.json"


class ChunkCacheSchemaError(ValueError):
    """A cache entry this build cannot read (written by a NEWER
    photon-tpu) — a clear refusal, mirroring the checkpoint store."""


class ChunkCacheCorrupt(ValueError):
    """A committed cache payload failed its CRC — the entry is damaged;
    delete the directory (or change cache_dir) and re-run to rebuild."""


# --------------------------------------------------------------------- keys


def index_map_digest(imap) -> str:
    """Stable digest of one frozen index map: the exact column order plus
    the intercept flag — any id reassignment changes the decoded chunks,
    so it must change the key."""
    h = hashlib.sha256()
    for k in imap.keys_in_order():
        h.update(k.encode("utf-8"))
        h.update(b"\x00")
    h.update(f"|intercept:{int(bool(imap.has_intercept))}".encode())
    return h.hexdigest()


def _config_canon(config) -> dict:
    return {
        "shards": {
            s: {"bags": list(cfg.bags),
                "has_intercept": bool(cfg.has_intercept),
                "dense_threshold": int(cfg.dense_threshold)}
            for s, cfg in config.shards.items()},
        "entity_fields": list(config.entity_fields),
        "response_field": config.response_field,
        "offset_field": config.offset_field,
        "weight_field": config.weight_field,
        "optional_entity_fields": list(config.optional_entity_fields),
        "allow_missing_response": bool(config.allow_missing_response),
    }


def _file_fingerprints(path) -> list:
    from photon_tpu_torch.data.avro_io import avro_paths

    out = []
    for p in avro_paths(path):
        st = os.stat(p)
        out.append([os.path.basename(str(p)), int(st.st_size),
                    int(st.st_mtime_ns)])
    return out


def cache_key(path, config, index_maps: dict, chunk_rows: int,
              sparse_k: Optional[int], kind: str = "game_chunks",
              extra: Optional[dict] = None) -> str:
    """The full cache key: source fingerprints + `GameDataConfig` +
    frozen index maps + chunk layout + entry kind (+ layout extras like
    the blocked-ELL ladder's d_dense/n_shards): a sha256 of plain JSON,
    so the reference computes the same key for the same inputs."""
    doc = {
        "schema": CACHE_SCHEMA_VERSION,
        "kind": kind,
        "files": _file_fingerprints(path),
        "config": _config_canon(config),
        "index_maps": {s: index_map_digest(index_maps[s])
                       for s in sorted(config.shards)},
        "chunk_rows": int(chunk_rows),
        "sparse_k": None if sparse_k is None else int(sparse_k),
        "extra": extra or {},
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


# ------------------------------------------------------------ the array bag


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _write_fsync(path: str, data: bytes) -> None:
    # a torn payload without its manifest-LAST commit reads as a MISS
    # photon: allow(durable_write, payload half of the two-phase cache commit)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class ChunkCacheWriter:
    """Accumulate named arrays under ``<root>/<key16>/``, then commit the
    manifest LAST (the crash-consistency point). Payload files land
    durable before the manifest ever exists; `commit` sweeps leftovers of
    a previous dead attempt out of the entries it publishes.

    MULTI-PROCESS RUNS (the distributed cache directory convention): pass ``process``/``n_processes`` and every process
    writes its own payloads under a ``p<k>_`` filename prefix into the
    SHARED entry directory (mirroring `checkpoint.store.SnapshotStore`'s
    per-process ``p<k>_`` snapshot payloads) — array NAMES must be
    globally unique across processes (each process caches its own
    disjoint chunk range, so chunk-indexed names already are. See
    `shard_chunk_range` for the canonical split). `commit` then differs
    by role: processes k > 0 publish a ``p<k>.entries.json`` sidecar
    (atomically, payloads already durable) and are done; process 0
    barriers (best-effort — `checkpoint.store` semantics), waits for
    every sidecar, merges all processes' entries and metas, and commits
    the ONE shared MANIFEST.json last (the reference first meets the
    others at a coordination-service barrier; the sidecar wait alone is
    the handshake here). A kill on any process before the
    process-0 commit leaves a manifest-less directory — a MISS on every
    host, never a torn cache. Readers (`open_cache`) are unchanged: the
    manifest is the single publication point regardless of how many
    processes wrote payloads."""

    def __init__(self, root, key: str, kind: str,
                 meta: Optional[dict] = None,
                 process: Optional[int] = None,
                 n_processes: Optional[int] = None):
        self.root = os.fspath(root)
        self.key = key
        self.kind = kind
        self.dir = entry_dir(root, key)
        self.meta = dict(meta or {})
        self.process = None if process is None else int(process)
        self.n_processes = (1 if n_processes is None else int(n_processes))
        if self.process is not None and not (
                0 <= self.process < self.n_processes):
            raise ValueError(
                f"process {self.process} out of range for "
                f"{self.n_processes} processes")
        self._prefix = ("" if self.process is None
                        else f"p{self.process}_")
        self._entries: list = []
        self._committed = False
        os.makedirs(self.dir, exist_ok=True)
        # a manifest from a PREVIOUS commit at this key must not survive
        # alongside fresh half-written payloads: remove it first so a
        # kill mid-rebuild reads as a miss, not as the stale entry over
        # torn files (multi-host: process 0 owns the manifest; every
        # process clears its OWN stale sidecar)
        if self.process is None or self.process == 0:
            stale = os.path.join(self.dir, _MANIFEST)
            if os.path.exists(stale):
                os.unlink(stale)
        if self.process is not None:
            sidecar = os.path.join(self.dir, self._sidecar(self.process))
            if os.path.exists(sidecar):
                os.unlink(sidecar)

    @staticmethod
    def _sidecar(k: int) -> str:
        return f"p{k}.entries.json"

    def add_array(self, name: str, arr) -> None:
        data = _npy_bytes(arr)
        fname = f"{self._prefix}{len(self._entries):05d}.npy"
        faults.retry_io(
            lambda: _write_fsync(os.path.join(self.dir, fname), data),
            site="cache_commit")
        self._entries.append({"name": name, "file": fname,
                              "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                              "nbytes": len(data)})
        telemetry.count("ingest.cache_bytes", len(data))

    def _wait_sidecars(self, timeout_s: float) -> list:
        """Process 0: every other process's committed sidecar, polled up
        to ``timeout_s`` (their payloads are durable once the sidecar —
        itself committed atomically — exists)."""
        import time

        docs = []
        deadline = time.monotonic() + timeout_s
        for k in range(1, self.n_processes):
            path = os.path.join(self.dir, self._sidecar(k))
            while not os.path.exists(path):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{path}: process {k}'s cache sidecar never "
                        f"appeared within {timeout_s:.0f}s — the shared "
                        "manifest cannot commit (the entry stays a MISS "
                        "everywhere)")
                time.sleep(0.05)
            with open(path) as f:
                docs.append(json.load(f))
        return docs

    @staticmethod
    def _merge_meta(base: dict, others: list) -> dict:
        """Deterministic meta merge for the shared manifest: ints/floats
        sum (chunk/row counts), lists concatenate in process order,
        dicts union; anything contradictory lands verbatim under
        ``meta["processes"][k]`` instead of being guessed at."""
        merged = dict(base)
        for k, m in others:
            for key, v in m.items():
                if key not in merged:
                    merged[key] = v
                elif isinstance(v, bool) and isinstance(merged[key], bool):
                    merged[key] = merged[key] or v
                elif isinstance(v, (int, float)) \
                        and isinstance(merged[key], (int, float)) \
                        and not isinstance(v, bool):
                    merged[key] = merged[key] + v
                elif isinstance(v, list) and isinstance(merged[key], list):
                    merged[key] = merged[key] + [x for x in v
                                                if x not in merged[key]]
                elif isinstance(v, dict) and isinstance(merged[key], dict):
                    merged[key] = {**merged[key], **v}
                elif merged[key] != v:
                    merged.setdefault("processes", {}).setdefault(
                        str(k), {})[key] = v
        return merged

    def commit(self, sidecar_timeout_s: float = 60.0) -> str:
        """Publish: MANIFEST.json last, via the repo-wide atomic commit
        primitive (``cache_commit`` retry/kill site wraps it — a kill here
        leaves NO manifest and the next open falls back to Avro).
        Multi-host: see the class docstring — k > 0 publishes its
        sidecar, process 0 merges and commits the shared manifest."""
        if self.process is not None and self.process != 0:
            doc = {"process": self.process, "meta": self.meta,
                   "entries": self._entries}
            faults.retry_io(
                lambda: commit_bytes(
                    os.path.join(self.dir, self._sidecar(self.process)),
                    json.dumps(doc).encode()),
                site="cache_commit")
            self._committed = True
            return self.dir
        entries = list(self._entries)
        meta = self.meta
        if self.process == 0 and self.n_processes > 1:
            docs = self._wait_sidecars(sidecar_timeout_s)
            for doc in docs:
                entries.extend(doc["entries"])
            meta = self._merge_meta(
                self.meta, [(doc["process"], doc["meta"]) for doc in docs])
        manifest = {"format": CACHE_FORMAT, "schema": CACHE_SCHEMA_VERSION,
                    "key": self.key, "kind": self.kind, "meta": meta,
                    "entries": entries}
        data = json.dumps(manifest).encode()
        faults.retry_io(
            lambda: commit_bytes(os.path.join(self.dir, _MANIFEST), data),
            site="cache_commit")
        self._committed = True
        telemetry.count("ingest.cache_commits")
        return self.dir


def entry_dir(root, key: str) -> str:
    return os.path.join(os.fspath(root), key[:24])


class CachedBag:
    """An open committed cache entry: named arrays, mmap'd on access,
    CRC-verified once per file on first touch."""

    def __init__(self, dir_: str, manifest: dict, mmap: bool = True,
                 verify: bool = True):
        self.dir = dir_
        self.manifest = manifest
        self.meta = manifest.get("meta", {})
        self.kind = manifest.get("kind")
        self.mmap = mmap
        self.verify = verify
        self._by_name = {e["name"]: e for e in manifest["entries"]}
        self._verified: set = set()

    def names(self) -> list:
        return [e["name"] for e in self.manifest["entries"]]

    def array(self, name: str) -> np.ndarray:
        e = self._by_name[name]
        path = os.path.join(self.dir, e["file"])
        if self.verify and e["file"] not in self._verified:
            def _check(p=path, want_crc=e["crc32"], want_n=e["nbytes"],
                       nm=name):
                with open(p, "rb") as f:
                    raw = f.read()
                if len(raw) != want_n or \
                        (zlib.crc32(raw) & 0xFFFFFFFF) != want_crc:
                    raise ChunkCacheCorrupt(
                        f"{p}: cached array {nm!r} failed its CRC/size "
                        "check — the entry is damaged; delete "
                        f"{self.dir} (or point cache_dir elsewhere) and "
                        "re-run to rebuild from Avro")

            faults.retry_io(_check, site="cache_open",
                            retry_on=(OSError,))
            self._verified.add(e["file"])

        def _load(p=path):
            return np.load(p, mmap_mode="r" if self.mmap else None,
                           allow_pickle=False)

        return faults.retry_io(_load, site="cache_open")


def open_cache(root, key: str, kind: str, mmap: bool = True,
               verify: bool = True) -> Optional[CachedBag]:
    """Open the committed entry for ``key``, or None on a miss — which a
    torn (manifest-less) directory, a stale key, or an unreadable
    manifest all read as. A manifest written by a NEWER build raises
    :class:`ChunkCacheSchemaError` (refusal, not silent re-decode of a
    cache this build merely fails to parse)."""
    d = entry_dir(root, key)
    mpath = os.path.join(d, _MANIFEST)
    if not os.path.exists(mpath):
        return None

    def _read():
        with open(mpath) as f:
            return json.load(f)

    try:
        manifest = faults.retry_io(_read, site="cache_open")
    except (json.JSONDecodeError, OSError):
        telemetry.count("ingest.cache_invalid")
        return None
    if manifest.get("format") != CACHE_FORMAT:
        telemetry.count("ingest.cache_invalid")
        return None
    if int(manifest.get("schema", 0)) > CACHE_SCHEMA_VERSION:
        raise ChunkCacheSchemaError(
            f"{d}: chunk-cache schema v{manifest['schema']} is newer than "
            f"this build's v{CACHE_SCHEMA_VERSION}: read it with a build "
            "at least as new as the one that wrote it, or point cache_dir "
            "at a fresh directory")
    if manifest.get("key") != key or manifest.get("kind") != kind:
        telemetry.count("ingest.cache_invalid")
        return None
    return CachedBag(d, manifest, mmap=mmap, verify=verify)


# ------------------------------------------------- kind: game chunk stream


def save_game_chunks_start(root, key: str, config) -> ChunkCacheWriter:
    """Writer for a ``game_chunks`` entry; the ingest plane adds each
    decoded chunk as it streams past (`add_game_chunk`) and commits at
    exhaustion."""
    w = ChunkCacheWriter(root, key, "game_chunks", meta={
        "n_chunks": 0, "n_rows": 0,
        "entity_fields": list(config.entity_fields),
        "shards": list(config.shards),
        "saw_missing_response": False,
    })
    return w


def add_game_chunk(w: ChunkCacheWriter, chunk, response_mask=None,
                   entity_presence=None) -> None:
    """Append one GameData chunk (plus the stream handle's per-chunk
    response mask / optional-entity presence, when present) to a
    ``game_chunks`` writer."""
    from photon_tpu_torch.data.matrix import SparseRows

    i = w.meta["n_chunks"]
    pre = f"c{i:05d}."
    w.add_array(pre + "y", chunk.y)
    w.add_array(pre + "weights", chunk.weights)
    w.add_array(pre + "offsets", chunk.offsets)
    kinds = w.meta.setdefault("shard_kinds", {})
    for s, X in chunk.shards.items():
        if isinstance(X, SparseRows):
            kinds[s] = "sparse"
            w.add_array(pre + f"shard.{s}.indices", X.indices)
            w.add_array(pre + f"shard.{s}.values", X.values)
            w.meta.setdefault("shard_features", {})[s] = int(X.n_features)
        else:
            kinds[s] = "dense"
            w.add_array(pre + f"shard.{s}", X)
    for e, col in chunk.entity_ids.items():
        w.add_array(pre + f"ent.{e}", np.asarray(col, dtype=np.str_))
    if response_mask is not None:
        w.add_array(pre + "rmask", np.asarray(response_mask, bool))
    for e, pres in (entity_presence or {}).items():
        w.add_array(pre + f"pres.{e}", np.asarray(pres, bool))
    w.meta["n_chunks"] = i + 1
    w.meta["n_rows"] += int(chunk.n)
    telemetry.count("ingest.cache_chunks")


def iter_cached_chunks(bag: CachedBag, stream=None):
    """Yield the cached GameData chunks in order — bit-identical to the
    cold decode that committed them. With a ChunkStream handle, the
    per-chunk response mask / entity presence / saw_missing flags are
    restored onto it exactly as a live decode would set them."""
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData

    meta = bag.meta
    kinds = meta.get("shard_kinds", {})
    feats = meta.get("shard_features", {})
    names = set(bag.names())
    if stream is not None:
        stream.saw_missing_response = bool(
            meta.get("saw_missing_response", False))
    for i in range(int(meta["n_chunks"])):
        pre = f"c{i:05d}."
        shards = {}
        for s in meta["shards"]:
            if kinds.get(s) == "sparse":
                shards[s] = SparseRows(
                    np.asarray(bag.array(pre + f"shard.{s}.indices")),
                    np.asarray(bag.array(pre + f"shard.{s}.values")),
                    int(feats[s]))
            else:
                shards[s] = np.asarray(bag.array(pre + f"shard.{s}"))
        ids = {e: np.asarray(bag.array(pre + f"ent.{e}"))
               for e in meta["entity_fields"]}
        if stream is not None:
            if (pre + "rmask") in names:
                stream.last_response_mask = np.asarray(
                    bag.array(pre + "rmask"))
            stream.last_entity_presence = {
                e: np.asarray(bag.array(pre + f"pres.{e}"))
                for e in meta["entity_fields"]
                if (pre + f"pres.{e}") in names}
        yield GameData(np.asarray(bag.array(pre + "y")),
                       np.asarray(bag.array(pre + "weights")),
                       np.asarray(bag.array(pre + "offsets")),
                       shards, ids)


# ------------------------------------------------ kind: blocked-ELL ladder


def _np_of(v) -> tuple:
    """(numpy array, dtype name or None) of a host array or tensor: a
    tensor numpy cannot hold (bf16) goes as its int16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    return np.asarray(v), None


def _tensor_of(arr, dtype) -> torch.Tensor:
    """The tensor `_np_of` stored, in pinned host memory when a GPU is
    present (the ladder's chunks upload asynchronously)."""
    from photon_tpu_torch.data.dataset import _pin

    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return _pin(t)


# chunk fields every chunk of a ladder shares (stored once, at the top)
_SHARED = ("perm_cols", "inv_perm")


def _split_dataclass(obj) -> tuple[dict, dict]:
    """(arrays, meta) of a layout dataclass: tensor fields and tuples of
    tensors go to .npy files, plain ints stay in the manifest."""
    arrays: dict = {}
    meta: dict = {}
    for f in dataclasses.fields(obj):
        if not f.init or f.name in _SHARED:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, tuple):
            dts = []
            for j, x in enumerate(v):
                arrays[f"{f.name}.{j}"], dt = _np_of(x)
                dts.append(dt)
            meta[f.name] = {"tuple": len(v), "dtypes": dts}
        elif hasattr(v, "shape"):
            arrays[f.name], dt = _np_of(v)
            meta[f.name] = {"array": True, "dtype": dt}
        else:
            meta[f.name] = {"value": v}
    return arrays, meta


def _join_dataclass(cls, bag: CachedBag, prefix: str, meta: dict,
                    shared: dict):
    kwargs: dict = dict(shared)
    for name, spec in meta.items():
        if "tuple" in spec:
            kwargs[name] = tuple(
                _tensor_of(bag.array(f"{prefix}{name}.{j}"), dt)
                for j, dt in enumerate(spec["dtypes"]))
        elif spec.get("array"):
            kwargs[name] = _tensor_of(bag.array(f"{prefix}{name}"),
                                      spec["dtype"])
        else:
            kwargs[name] = spec["value"]
    return cls(**kwargs)


def save_ladder(root, key: str, cb) -> str:
    """Commit a finished blocked-ELL ChunkedBatch (the
    `data.dataset.chunk_blocked_ell` output) as a ``ladder`` entry —
    layout construction happens once, every later run mmap-opens it."""
    from photon_tpu_torch.data.matrix import (BlockedEllRows,
                                              ShardedBlockedEllRows)

    X = cb.X
    w = ChunkCacheWriter(root, key, "ladder", meta={
        "n_real": int(X.n_real), "n_features": int(X.n_features),
        "last_col_pos": (None if X.last_col_pos is None
                         else int(X.last_col_pos)),
        "n_chunks": X.n_chunks,
    })
    w.add_array("y", cb.y)
    w.add_array("weights", cb.weights)
    w.add_array("offsets", cb.offsets)
    if X.perm_cols is not None:
        w.add_array("perm_cols", _np_of(X.perm_cols)[0])
        w.add_array("inv_perm", _np_of(X.inv_perm)[0])
    chunk_meta = []
    for i, c in enumerate(X.chunks):
        if not isinstance(c, (BlockedEllRows, ShardedBlockedEllRows)):
            raise TypeError(
                "save_ladder expects blocked-ELL chunks (build them with "
                "data.dataset.chunk_blocked_ell)")
        arrays, meta = _split_dataclass(c)
        for name, arr in arrays.items():
            w.add_array(f"c{i:05d}.{name}", arr)
        chunk_meta.append({"cls": type(c).__name__, "fields": meta})
    w.meta["chunks"] = chunk_meta
    return w.commit()


def open_ladder(root, key: str, mmap: bool = True,
                verify: bool = True):
    """Reopen a committed ``ladder`` entry as a ChunkedBatch (chunks as
    pinned host tensors when a GPU is present), or None on a miss."""
    from photon_tpu_torch.data.dataset import ChunkedBatch, ChunkedMatrix
    from photon_tpu_torch.data.matrix import (BlockedEllRows,
                                              ShardedBlockedEllRows)

    bag = open_cache(root, key, "ladder", mmap=mmap, verify=verify)
    if bag is None:
        return None
    names = set(bag.names())
    shared = {}
    if "perm_cols" in names:
        shared = {n: torch.from_numpy(np.array(bag.array(n)))
                  for n in _SHARED}
    classes = {"BlockedEllRows": BlockedEllRows,
               "ShardedBlockedEllRows": ShardedBlockedEllRows}
    chunks = tuple(
        _join_dataclass(classes[cm["cls"]], bag, f"c{i:05d}.",
                        cm["fields"], shared)
        for i, cm in enumerate(bag.meta["chunks"]))
    X = ChunkedMatrix(
        chunks, int(bag.meta["n_real"]), int(bag.meta["n_features"]),
        perm_cols=shared.get("perm_cols"), inv_perm=shared.get("inv_perm"),
        last_col_pos=bag.meta.get("last_col_pos"))
    return ChunkedBatch(X, np.array(bag.array("y")),
                        np.array(bag.array("weights")),
                        np.array(bag.array("offsets")))
