"""Streaming ingestion: block-streamed Avro → bounded-memory GameData (the
port's copy of `photon_tpu/data/streaming.py`).

Reference parity: com.linkedin.photon.ml.data.avro.AvroDataReader reads
partitioned HDFS data through Spark — the dataset never materializes on one
host. Here:

- `iter_game_chunks`: an iterator of GameData CHUNKS, assembled container
  block by container block (the native C++ decoder when it applies, pure
  Python otherwise); the host arena stays bounded by ~2 chunks regardless
  of dataset size, and multi-file inputs stream file after file;
- `build_index_maps_streaming` / `scan_ingest`: the training path's first
  pass — feature-key → id maps built over the same block stream (native
  build mode), recording the block index the ingest plane reuses;
- `stream_to_device`: chunks land STRAIGHT in preallocated device tensors
  — each chunk is copied into a pinned staging buffer and from there, on
  a side stream, into its rows of the device tensors; a staging buffer is
  refilled only after its copy's event — so the host holds a few
  chunk-sized staging buffers and one decoded chunk, never the dataset;
- `stream_to_host`: the streamed-objective read — shards used only by
  fixed effects as uniform host `ChunkedMatrix` chunks (pinned), the rest
  as host numpy.

Chunks are container-block-aligned: a chunk closes at the first block
boundary at or after `chunk_rows`, so concatenating the chunks reproduces
the one-shot `read_game_data` result exactly. With a mesh,
`stream_to_device` fills each local slot's rows on its device, and
``local_only=True`` decodes only the chunk tasks that overlap this
process's slots.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from photon_tpu_torch import native, telemetry
from photon_tpu_torch.checkpoint.faults import retry_io
from photon_tpu_torch.data.avro_io import AvroContainerReader, avro_paths
from photon_tpu_torch.data.feature_bags import coo_to_matrix
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, \
    feature_key
from photon_tpu_torch.data.ingest import (
    GameDataConfig,
    entity_id_or_none,
    native_fallback,
    normalize_bag,
    numeric_or_none,
    records_to_game_data,
)
from photon_tpu_torch.data.matrix import SparseRows, next_pow2
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.dataset import GameData


def _open_reader(p) -> AvroContainerReader:
    """Open one Avro container with transient-IO retry/backoff
    (`checkpoint.faults.retry_io`, site ``avro_open``): a shared-filesystem
    hiccup at ingest backs off and retries instead of killing the run.
    Mid-stream read errors still propagate — a container cannot be safely
    resumed mid-block, so the recovery unit is the ingest pass."""
    return retry_io(lambda: AvroContainerReader(p), site="avro_open")


def feature_torch_dtype(feature_dtype) -> torch.dtype:
    """A storage dtype given as a torch dtype, a name (``"bfloat16"``) or
    None (float32)."""
    if feature_dtype is None:
        return torch.float32
    if isinstance(feature_dtype, torch.dtype):
        return feature_dtype
    return getattr(torch, str(feature_dtype))


def _tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor (a copy only when the array is not a
    writable C-contiguous buffer, e.g. a cache hit's read-only mmap)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


def scan_row_counts(path, block_index: Optional[dict] = None) -> list:
    """Per-file record counts from the container block HEADERS only — no
    payload decompression, no record decode. Cheap enough to run before
    streaming so device buffers can be preallocated exactly.

    ``block_index`` (path -> [(offset, count, size)], the shape
    `scan_ingest` returns) answers from the already-scanned index without
    touching the files again."""
    if block_index is not None:
        return [sum(c for _, c, _ in block_index[str(p)])
                for p in avro_paths(path)]
    counts = []
    for p in avro_paths(path):
        rd = _open_reader(p)
        counts.append(sum(c for c, _ in rd.blocks(skip_payload=True)))
    return counts


@dataclasses.dataclass
class IngestScan:
    """Everything one cold-start pass over the containers learns: the
    frozen per-shard index maps AND the per-file block index (offsets /
    record counts / compressed sizes). `scan_ingest` folds row counting
    into the map-building scan, so preallocating device buffers and
    planning the ingest plane's decode tasks costs no extra pass."""

    index_maps: dict
    block_index: dict  # path -> [(offset, count, size)]

    @property
    def row_counts(self) -> list:
        return [sum(c for _, c, _ in blocks)
                for blocks in self.block_index.values()]

    @property
    def n_rows(self) -> int:
        return sum(self.row_counts)


def scan_ingest(path, config: GameDataConfig,
                index_maps: Optional[dict] = None) -> IngestScan:
    """ONE pass over the containers: build whatever frozen index maps are
    missing (exactly `build_index_maps_streaming` semantics) while
    recording the block index as a side effect of the same walk. When
    every map is prebuilt the pass degrades to the header-only scan (no
    payload decompress)."""
    index_maps = dict(index_maps or {})
    todo = {s: cfg for s, cfg in config.shards.items() if s not in index_maps}
    index_out: dict = {}
    if todo:
        index_maps = _build_index_maps_streaming(path, config, index_maps,
                                                 todo, index_out=index_out)
    else:
        for p in avro_paths(path):
            index_out[str(p)] = _open_reader(p).block_index()
    return IngestScan(index_maps, index_out)


def _frozen_maps_or_raise(config: GameDataConfig, index_maps,
                          sparse_k=None, uniform_sparse_k=True) -> dict:
    index_maps = dict(index_maps or {})
    missing = [s for s in config.shards if s not in index_maps]
    if missing:
        raise ValueError(
            f"streaming ingestion needs frozen index maps for every shard "
            f"(missing {missing}); run build_index_maps_streaming (or the "
            "indexing driver) first — ids cannot be assigned "
            "on-the-fly once early chunks have already been emitted")
    unfrozen = [s for s in config.shards if not index_maps[s].frozen]
    if unfrozen:
        raise ValueError(
            f"streaming ingestion needs FROZEN index maps; {unfrozen} are "
            "mutable — fresh ids assigned mid-stream would shift column "
            "meanings between chunks")
    if uniform_sparse_k:
        for s, cfg in config.shards.items():
            if (index_maps[s].n_features > cfg.dense_threshold
                    and sparse_k is None):
                raise ValueError(
                    f"shard {s!r} is sparse (d={index_maps[s].n_features} > "
                    f"dense_threshold={cfg.dense_threshold}): streaming "
                    "needs a fixed sparse_k so every chunk's SparseRows "
                    "share one nnz width (per-chunk max widths would make "
                    "chunks non-concatenable)")
    return index_maps


def build_index_maps_streaming(
    path,
    config: GameDataConfig,
    index_maps: Optional[dict] = None,
    use_native: Optional[bool] = None,
) -> dict:
    """One bounded-memory pass assigning feature ids (first-seen order,
    bags in shard-config order — identical to `read_game_data`'s maps).
    Existing maps in `index_maps` are kept as-is. Runs through the native
    block decoder when it applies (``use_native`` as in `read_game_data`)."""
    index_maps = dict(index_maps or {})
    todo = {s: cfg for s, cfg in config.shards.items() if s not in index_maps}
    if not todo:
        return index_maps
    return _build_index_maps_streaming(path, config, index_maps, todo,
                                       use_native=use_native)


def _build_index_maps_streaming(path, config: GameDataConfig, index_maps,
                                todo, index_out: Optional[dict] = None,
                                use_native: Optional[bool] = None) -> dict:
    # Native pass over EXACTLY the shards being built: a sub-config keeps
    # only their bags and consumes nothing else — every other field
    # (the response/entity columns and prebuilt shards' bags) skips
    # inside the C++ decoder.
    if use_native is not False:
        sub = dataclasses.replace(config, shards=todo, entity_fields=(),
                                  response_field="\x00unconsumed",
                                  offset_field="\x00unconsumed",
                                  weight_field="\x00unconsumed")
        nat = _build_maps_native(path, sub, index_out=index_out)
        if nat is not None:
            index_maps.update(nat)
            return index_maps
        native_fallback(path, use_native)
    building = {s: IndexMap() for s in todo}
    bag_names = sorted({b for cfg in todo.values() for b in cfg.bags})
    for p in avro_paths(path):
        rd = _open_reader(p)
        entries = []
        for off, count, size, payload in rd.walk_blocks():
            entries.append((off, count, size))
            for rec in rd.records(count, payload):
                norm = {b: normalize_bag(rec.get(b)) for b in bag_names}
                for s, cfg in todo.items():
                    imap = building[s]
                    for bag in cfg.bags:
                        for ntv in norm[bag]:
                            imap.index_of(feature_key(ntv.name, ntv.term))
        if index_out is not None:
            index_out[str(p)] = entries
    for s, cfg in todo.items():
        if cfg.has_intercept:
            building[s].index_of(INTERCEPT_KEY)
        index_maps[s] = building[s].freeze()
    return index_maps


def _plan_readers(readers, config: GameDataConfig):
    """The compiled schema plan shared by every reader, or None (not
    plannable, or the files' schemas differ)."""
    from photon_tpu_torch.data.native_ingest import compile_plan

    plan0 = compile_plan(readers[0].schema, config)
    if plan0 is None:
        return None
    for rd in readers[1:]:
        if compile_plan(rd.schema, config) != plan0:
            return None
    return plan0


def _build_maps_native(path, config: GameDataConfig,
                       index_out: Optional[dict] = None) -> Optional[dict]:
    """Native block-decode pass in BUILD mode, per-block arrays discarded —
    id assignment mirrors `read_game_data_native` exactly (same stores,
    same first-seen order). None when the native path doesn't apply.
    ``index_out`` collects the block index of the same walk."""
    from photon_tpu_torch.data.native_ingest import build_decode_plan

    if not native.available():
        return None
    paths = avro_paths(path)
    if not paths:
        return None
    readers = [_open_reader(p) for p in paths]
    plan0 = _plan_readers(readers, config)
    if plan0 is None:
        return None
    shard_names = list(config.shards)
    stores = [native.NativeIndexStore(capacity_hint=1024)
              for _ in shard_names]
    plan = build_decode_plan(plan0, config, shard_names)
    for rd in readers:
        entries = []
        for off, count, size, payload in rd.walk_blocks():
            entries.append((off, count, size))
            dec = native.decode_block(payload, count, 0, plan, stores, True)
            if not dec.ok:
                raise ValueError(f"{rd.path}: malformed Avro block")
            dec.free()
        if index_out is not None:
            index_out[str(rd.path)] = entries
    out = {}
    for si, s in enumerate(shard_names):
        cfg = config.shards[s]
        imap = IndexMap({k: i for i, k in
                         enumerate(stores[si].keys_in_order())},
                        frozen=True, has_intercept=cfg.has_intercept)
        if cfg.has_intercept:
            imap.index_of(INTERCEPT_KEY)  # no-op id; records metadata
        out[s] = imap
    return out


@dataclasses.dataclass
class ChunkStream:
    """Iterator state + arena accounting for one streaming read.

    `peak_arena_bytes` tracks the maximum bytes of numpy buffers the
    assembler held live at any point — the test contract is that it stays
    ≤ ~2 chunks regardless of how many files/rows stream through.
    """

    config: GameDataConfig
    index_maps: dict
    chunk_rows: int
    sparse_k: Optional[int]
    peak_arena_bytes: int = 0
    # With config.allow_missing_response: True once ANY streamed record
    # lacked a response (evaluator gating), and the per-row presence mask
    # of the MOST RECENTLY YIELDED chunk (the scoring driver reads it
    # right after next() to null out labels row by row).
    saw_missing_response: bool = False
    last_response_mask: Optional[np.ndarray] = None
    # Per-row presence of each OPTIONAL entity field in the most recently
    # yielded chunk ({field: (n,) bool}): chunk assembly folds a missing id
    # to "" for the column arrays, which conflates it with a legitimate
    # empty-string id — consumers that must tell the two apart (the
    # scoring driver's nullable ScoredItemAvro.uid) read this instead.
    last_entity_presence: Optional[dict] = None
    # uniform_sparse_k=False only: quantize each chunk's own SparseRows
    # nnz width up to a power of two, so chunks come in a handful of
    # shapes instead of one per distinct raggedness.
    quantize_k: bool = False

    def _note(self, live_bytes: int) -> None:
        if live_bytes > self.peak_arena_bytes:
            self.peak_arena_bytes = live_bytes


def _chunk_nbytes(data: GameData) -> int:
    """Numeric-buffer bytes of one assembled chunk (entity-id object arrays
    are host pointers either way and excluded)."""
    total = data.y.nbytes + data.weights.nbytes + data.offsets.nbytes
    for X in data.shards.values():
        if isinstance(X, SparseRows):
            total += X.indices.nbytes + X.values.nbytes
        else:
            total += X.nbytes
    return int(total)


def iter_game_chunks(
    path,
    config: GameDataConfig,
    index_maps: dict,
    chunk_rows: int = 65536,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
    uniform_sparse_k: bool = True,
) -> tuple[ChunkStream, Iterator[GameData]]:
    """(stream handle, iterator of GameData chunks) over one file or a
    directory of .avro files. Needs frozen index maps for EVERY shard
    (training: build them with `build_index_maps_streaming` first;
    scoring: reuse the training maps — reference behavior).

    Chunks close at container-block boundaries, so sizes are
    ≥ `chunk_rows` (except the last) and concatenation equals the one-shot
    read. `use_native` as in `ingest.read_game_data`: True forces the C++
    decoder (raising when it cannot apply), None tries it and falls back
    to Python logged and counted, False reads in Python.

    `uniform_sparse_k=False` lifts the fixed-`sparse_k` requirement for
    sparse shards: each chunk gets its own max-nnz width. Only for
    consumers that process chunks INDEPENDENTLY (the scoring driver) —
    ragged widths make chunks non-concatenable.
    """
    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k,
                                       uniform_sparse_k)
    stream = ChunkStream(config, index_maps, chunk_rows, sparse_k,
                         quantize_k=(not uniform_sparse_k
                                     and sparse_k is None))
    if use_native is not False:
        # Availability / plannability checked EAGERLY (before the first
        # next()), so a forced use_native=True fails at the call site.
        it = _native_chunks(path, stream)
        if it is not None:
            return stream, it
        native_fallback(path, use_native)
    return stream, _python_chunks(path, stream)


def _quantize_widths(stream: ChunkStream, data: GameData) -> GameData:
    """Pad each SparseRows shard's nnz width up to the next power of two
    (stream.quantize_k; padding slots are (index 0, value 0) no-ops)."""
    if not stream.quantize_k:
        return data
    shards = {}
    changed = False
    for s, X in data.shards.items():
        if isinstance(X, SparseRows):
            k = X.indices.shape[1]
            kq = next_pow2(max(k, 1))
            if kq != k:
                pad = ((0, 0), (0, kq - k))
                X = SparseRows(np.pad(np.asarray(X.indices), pad),
                               np.pad(np.asarray(X.values), pad),
                               X.n_features)
                changed = True
        shards[s] = X
    if not changed:
        return data
    return GameData(data.y, data.weights, data.offsets, shards,
                    data.entity_ids)


def _python_chunks(path, stream: ChunkStream) -> Iterator[GameData]:
    """Records buffered per chunk, then the standard records→GameData
    assembly with the frozen maps. Chunks close at container-BLOCK
    boundaries, exactly like the native path, so chunking is the same
    whichever decoder runs."""
    return _python_chunks_from_readers(
        [_open_reader(p) for p in avro_paths(path)], stream)


def _python_chunks_from_readers(readers, stream: ChunkStream
                                ) -> Iterator[GameData]:
    """The reader-level body of `_python_chunks`: any AvroContainerReader-
    shaped sources (including the ingest plane's per-worker block slices)
    stream through the SAME record buffering and assembly, so a worker's
    chunk is bit-identical to the serial stream's by construction."""
    buf: list = []

    def flush():
        if stream.config.allow_missing_response:
            f = stream.config.response_field
            # numeric_or_none, not a bare None check: a populated
            # NON-numeric union branch reads as absent on both decoders —
            # the mask must agree or such rows would enter the metric
            # accumulators as labeled y=0 examples on this path only
            mask = np.asarray(
                [numeric_or_none(r.get(f)) is not None for r in buf])
            stream.last_response_mask = mask
            if not mask.all():
                stream.saw_missing_response = True
        stream.last_entity_presence = {
            e: np.asarray([entity_id_or_none(r.get(e)) is not None
                           for r in buf])
            for e in stream.config.optional_entity_fields}
        data, _ = records_to_game_data(buf, stream.config, stream.index_maps,
                                       stream.sparse_k)
        data = _quantize_widths(stream, data)
        # the record buffer and the assembled chunk coexist briefly
        stream._note(2 * _chunk_nbytes(data))
        buf.clear()
        return data

    for rd in readers:
        for count, payload in rd.blocks():
            buf.extend(rd.records(count, payload))
            if len(buf) >= stream.chunk_rows:
                yield flush()
    if buf:
        yield flush()


def _native_chunks(path, stream: ChunkStream):
    """C++ block decoder path; None when unavailable/unplannable."""
    if not native.available():
        return None
    paths = avro_paths(path)
    if not paths:
        return None
    return _native_chunks_from_readers(
        [_open_reader(p) for p in paths], stream)


def _native_chunks_from_readers(readers, stream: ChunkStream,
                                stores: Optional[list] = None):
    """The reader-level body of `_native_chunks` (shared with the ingest
    plane's per-worker block slices); None when the schema is not
    native-plannable. ``stores`` are the frozen native stores of the
    stream's maps when the caller holds them already (a decode worker
    builds them once, not per task)."""
    from photon_tpu_torch.data.native_ingest import (build_decode_plan,
                                                     entity_ids_of,
                                                     frozen_stores)

    if not native.available() or not readers:
        return None
    config = stream.config
    plan0 = _plan_readers(readers, config)
    if plan0 is None:
        return None
    shard_names = list(config.shards)
    if stores is None:
        stores = frozen_stores(stream.index_maps, shard_names)
    plan = build_decode_plan(plan0, config, shard_names)

    optional_ents = set(config.optional_entity_fields)

    def generator():
        ys, offs, wts, ysets = [], [], [], []
        coos = [[] for _ in shard_names]
        ents = [[] for _ in config.entity_fields]
        rows_in_chunk = 0
        live = 0

        def assemble() -> GameData:
            nonlocal rows_in_chunk, live
            n = rows_in_chunk
            if config.allow_missing_response:
                stream.last_response_mask = np.concatenate(ysets)
                ysets.clear()
            y = np.concatenate(ys).astype(np.float32)
            offsets = np.concatenate(offs).astype(np.float32)
            weights = np.concatenate(wts).astype(np.float32)
            shards = {}
            for si, s in enumerate(shard_names):
                cfg = config.shards[s]
                imap = stream.index_maps[s]
                rows = np.concatenate([c[0] for c in coos[si]])
                cols = np.concatenate([c[1] for c in coos[si]]).astype(
                    np.int64)
                vals = np.concatenate([c[2] for c in coos[si]])
                if cfg.has_intercept:
                    rows = np.concatenate(
                        [rows, np.arange(n, dtype=np.int64)])
                    cols = np.concatenate(
                        [cols, np.full(n, imap.intercept_id, np.int64)])
                    vals = np.concatenate([vals, np.ones(n, np.float32)])
                shards[s] = coo_to_matrix(rows, cols, vals, n,
                                          imap.n_features,
                                          cfg.dense_threshold,
                                          k=stream.sparse_k)
            ids = {}
            presence: dict = {}
            for e_i, e in enumerate(config.entity_fields):
                col, null = entity_ids_of(ents[e_i])
                if e in optional_ents:
                    presence[e] = ~null
                elif null.any():
                    raise ValueError(f"records missing entity id {e!r}")
                ids[e] = col
            stream.last_entity_presence = presence
            out = _quantize_widths(
                stream, GameData(y, weights, offsets, shards, ids))
            # block pieces + the assembled chunk coexist briefly
            stream._note(live + _chunk_nbytes(out))
            ys.clear()
            offs.clear()
            wts.clear()
            for c in coos:
                c.clear()
            for e in ents:
                e.clear()
            rows_in_chunk = 0
            live = 0
            return out

        for rd in readers:
            for count, payload in rd.blocks():
                dec = native.decode_block(payload, count, rows_in_chunk,
                                          plan, stores, False)
                if not dec.ok:
                    raise ValueError(f"{rd.path}: malformed Avro block")
                y, y_set = dec.scalars(0)
                if not y_set.all():
                    if not config.allow_missing_response:
                        raise ValueError(
                            f"{rd.path}: record missing response")
                    stream.saw_missing_response = True
                    y = np.where(y_set, y, 0.0)
                if config.allow_missing_response:
                    ysets.append(y_set)
                off, off_set = dec.scalars(1)
                wt, wt_set = dec.scalars(2)
                ys.append(y)
                offs.append(np.where(off_set, off, 0.0))
                wts.append(np.where(wt_set, wt, 1.0))
                live += y.nbytes * 3
                for si in range(len(shard_names)):
                    c = dec.coo(si)
                    coos[si].append(c)
                    live += sum(a.nbytes for a in c)
                for e in range(len(config.entity_fields)):
                    ents[e].append(dec.entity_column(e))
                dec.free()
                rows_in_chunk += count
                if rows_in_chunk >= stream.chunk_rows:
                    yield assemble()
        if rows_in_chunk:
            yield assemble()

    return generator()


def _dense_shard_flags(config: GameDataConfig, index_maps: dict) -> dict:
    return {s: index_maps[s].n_features <= cfg.dense_threshold
            for s, cfg in config.shards.items()}


def _round_to(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Host f32 values rounded through the storage dtype (the values a
    ``dtype`` tensor holds, kept as f32 numpy for the host consumers)."""
    if dtype == torch.float32:
        return np.asarray(a, np.float32)
    return _tensor(np.asarray(a, np.float32)).to(dtype).to(
        torch.float32).numpy()


def stream_to_host(
    path,
    config: GameDataConfig,
    index_maps: dict,
    chunked_shards=(),
    chunk_rows: int = 65536,
    objective_chunk_rows: int = 1 << 20,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
    feature_dtype=None,
    chunk_hook=None,
    n_rows: Optional[int] = None,
    workers: int = 0,
    cache_dir=None,
    block_index: Optional[dict] = None,
    mode: str = "process",
    pool=None,
) -> tuple[GameData, int]:
    """Stream a dataset into HOST-RESIDENT form for the out-of-device-
    memory streamed-objective solve (the training driver trips here when
    the device-resident estimate exceeds the device's budget).

    ``workers``/``cache_dir``/``block_index``/``mode`` engage the ingest
    plane (`data.ingest_plane.open_chunk_source`): ``workers > 0``
    decodes container blocks in a worker pool (chunk order preserved bit
    for bit; a dead worker degrades that chunk to in-process decode),
    ``cache_dir`` opens/commits the decode-once chunk cache,
    ``block_index`` reuses `scan_ingest`'s block offsets, and ``pool`` (a
    `data.ingest_plane.DecodePool`) lends process workers that outlive
    the stream.

    Shards named in `chunked_shards` are assembled as
    `data.dataset.ChunkedMatrix` — uniform `objective_chunk_rows`-row host
    chunks (CPU tensors, pinned when a GPU is present) the streamed
    solvers re-upload pass by pass, so the device holds O(chunk + solver
    state) instead of O(dataset). Every other shard and the scalar
    columns assemble as full host numpy (the GAME layer moves what it
    needs: random-effect buckets must be resident).

    `feature_dtype` (a torch dtype or its name) is the storage dtype of
    the feature values: chunked shards store it, resident shards hold
    their values rounded through it (as f32 numpy, which the host-side
    entity bucketing reads). `chunk_hook(chunk)` runs on every decoded
    chunk first (validation, mergeable statistics).

    Returns (GameData, n_real); GameData.n == n_real (only the
    ChunkedMatrix pads internally, weight-0-masked by the solve batches).
    """
    from photon_tpu_torch.data.dataset import ChunkedMatrix, _pin
    from photon_tpu_torch.data.ingest_plane import open_chunk_source

    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k)
    chunked_shards = set(chunked_shards)
    unknown = chunked_shards - set(config.shards)
    if unknown:
        raise ValueError(f"chunked_shards not in config: {sorted(unknown)}")
    if n_rows is not None:
        n_real = int(n_rows)
    else:
        n_real = sum(scan_row_counts(path, block_index=block_index))
    c_rows = max(int(objective_chunk_rows), 1)

    dense_shards = _dense_shard_flags(config, index_maps)
    f_dtype = feature_torch_dtype(feature_dtype)
    for s in chunked_shards:
        if not dense_shards[s] and sparse_k is None:
            raise ValueError(
                f"chunked shard {s!r} is sparse: pass a fixed sparse_k so "
                "every chunk shares one nnz width")

    def alloc(s):
        d = index_maps[s].n_features
        if dense_shards[s]:
            return torch.zeros((c_rows, d), dtype=f_dtype)
        return (torch.zeros((c_rows, sparse_k), dtype=torch.int32),
                torch.zeros((c_rows, sparse_k), dtype=f_dtype))

    bufs = {s: alloc(s) for s in chunked_shards}
    done_chunks: dict = {s: [] for s in chunked_shards}
    filled = 0  # rows filled in the current uniform chunk buffers

    scal_parts: dict = {k: [] for k in ("y", "weights", "offsets")}
    res_parts: dict = {s: [] for s in config.shards if s not in chunked_shards}
    entity_cols: dict = {e: [] for e in config.entity_fields}

    def flush():
        nonlocal bufs, filled
        for s in chunked_shards:
            b = bufs[s]
            done_chunks[s].append(tuple(map(_pin, b)) if isinstance(b, tuple)
                                  else _pin(b))
        bufs = {s: alloc(s) for s in chunked_shards}
        filled = 0

    _, chunks = open_chunk_source(path, config, index_maps,
                                  chunk_rows=chunk_rows, sparse_k=sparse_k,
                                  use_native=use_native, workers=workers,
                                  cache_dir=cache_dir,
                                  block_index=block_index, mode=mode,
                                  pool=pool)
    for chunk in chunks:
        telemetry.count("ingest.chunks")
        telemetry.count("ingest.rows", chunk.n)
        if chunk_hook is not None:
            chunk_hook(chunk)
        scal_parts["y"].append(np.asarray(chunk.y))
        scal_parts["weights"].append(np.asarray(chunk.weights))
        scal_parts["offsets"].append(np.asarray(chunk.offsets))
        for e in config.entity_fields:
            entity_cols[e].append(np.asarray(chunk.entity_ids[e]))
        for s in res_parts:
            X = chunk.shards[s]
            if isinstance(X, SparseRows):
                res_parts[s].append((np.asarray(X.indices),
                                     _round_to(X.values, f_dtype)))
            else:
                res_parts[s].append(_round_to(X, f_dtype))
        host_mat = {}
        for s in chunked_shards:
            X = chunk.shards[s]
            host_mat[s] = (_tensor(X) if dense_shards[s]
                           else (_tensor(X.indices), _tensor(X.values)))
        c0, n_c = 0, chunk.n
        while c0 < n_c:
            take = min(n_c - c0, c_rows - filled)
            sl = slice(c0, c0 + take)
            dst = slice(filled, filled + take)
            for s in chunked_shards:
                if dense_shards[s]:
                    bufs[s][dst] = host_mat[s][sl]
                else:
                    ind, val = bufs[s]
                    h_ind, h_val = host_mat[s]
                    k_c = h_ind.shape[1]
                    ind[dst, :k_c] = h_ind[sl]
                    val[dst, :k_c] = h_val[sl]
            filled += take
            c0 += take
            if filled == c_rows:
                flush()
    if filled or (chunked_shards and not done_chunks[next(iter(
            chunked_shards))]):
        flush()  # partial tail chunk (pad rows are all-zero → weight 0)

    def concat(parts, width=None, dtype=np.float32):
        if parts:
            return np.concatenate(parts)
        shape = (0,) if width is None else (0, width)
        return np.zeros(shape, dtype)

    shards: dict = {}
    for s in config.shards:
        d = index_maps[s].n_features
        if s in chunked_shards:
            cs = tuple(c if dense_shards[s] else SparseRows(c[0], c[1], d)
                       for c in done_chunks[s])
            shards[s] = ChunkedMatrix(cs, n_real, d)
        elif dense_shards[s]:
            shards[s] = concat(res_parts[s], width=d)
        else:
            k = sparse_k if sparse_k is not None else 1
            ind = concat([p[0] for p in res_parts[s]], width=k,
                         dtype=np.int32)
            val = concat([p[1] for p in res_parts[s]], width=k)
            shards[s] = SparseRows(ind, val, d)

    ids = {e: (np.concatenate([np.asarray(c, dtype=np.str_) for c in cols])
               if cols else np.zeros(0, dtype="U1"))
           for e, cols in entity_cols.items()}
    data = GameData(concat(scal_parts["y"]), concat(scal_parts["weights"]),
                    concat(scal_parts["offsets"]), shards, ids)
    return data, n_real


class _StagingRing:
    """Pinned host staging buffers for `stream_to_device`'s uploads: a
    chunk is copied into a free buffer, the buffer's columns are copied
    into their device rows on a side stream (``non_blocking``), and an
    event recorded after those copies guards the buffer — it is refilled
    only once the event has passed. ``depth`` buffers (an int, or an
    `AdaptivePrefetch` whose depth widens while the waits block, within
    its byte budget); each grows to the largest chunk it has held."""

    def __init__(self, device: torch.device, prefetch):
        self.device = device
        self.ctl = prefetch if hasattr(prefetch, "observe_wait") else None
        self.static = 2 if self.ctl is not None else max(int(prefetch), 1)
        self.side = torch.cuda.Stream(device)
        # the device tensors' zero fills run on the compute stream first
        self.side.wait_stream(torch.cuda.current_stream(device))
        self.slots: list = []   # [{name: pinned tensor}]
        self.events: list = []  # per slot: the event of its last upload
        self.turn = 0
        self.item_bytes = 0

    @property
    def depth(self) -> int:
        return (max(int(self.ctl.depth), 1) if self.ctl is not None
                else self.static)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for slot in self.slots for t in slot.values())

    def acquire(self, need: dict) -> dict:
        """A staging buffer with a pinned tensor of at least ``need[name]``
        = (shape, dtype) per column, free for the host to fill."""
        if len(self.slots) < self.depth:
            self.slots.append({})
            self.events.append(None)
            s = len(self.slots) - 1
        else:
            s = self.turn % len(self.slots)
            self.turn += 1
            ev = self.events[s]
            if ev is not None:
                t0 = time.perf_counter()
                ev.synchronize()
                waited = time.perf_counter() - t0
                telemetry.count("ingest.staging_wait_seconds", waited)
                if self.ctl is not None:
                    self.ctl.observe_wait(waited, self.item_bytes)
        slot = self.slots[s]
        for name, (shape, dtype) in need.items():
            t = slot.get(name)
            if (t is None or t.dtype != dtype or t.shape[1:] != shape[1:]
                    or t.shape[0] < shape[0]):
                slot[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
        self._current = s
        return slot

    def upload(self, pairs) -> None:
        """Issue ``dst.copy_(src)`` for each (device view, pinned view) on
        the side stream and guard the current buffer with an event."""
        with torch.cuda.stream(self.side):
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.events[self._current] = ev
        self.item_bytes = max(self.item_bytes,
                              sum(src.numel() * src.element_size()
                                  for _, src in pairs))

    def finish(self) -> None:
        """The compute stream waits for every upload; the ring's size goes
        to the peak gauges ``ingest.staging_peak_depth`` /
        ``ingest.staging_peak_bytes`` (the largest ring since the reset)."""
        torch.cuda.current_stream(self.device).wait_stream(self.side)
        telemetry.gauge_max("ingest.staging_peak_depth", len(self.slots))
        telemetry.gauge_max("ingest.staging_peak_bytes", self.nbytes())


def stream_to_device(
    path,
    config: GameDataConfig,
    index_maps: dict,
    mesh=None,
    chunk_rows: int = 65536,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
    feature_dtype=None,
    chunk_hook=None,
    n_rows: Optional[int] = None,
    prefetch=2,
    _local_mask=None,
    workers: int = 0,
    cache_dir=None,
    block_index: Optional[dict] = None,
    local_only: bool = False,
    device=None,
    mode: str = "process",
    pool=None,
) -> tuple[GameData, int]:
    """Stream a dataset STRAIGHT into its device placement on ``device``
    (default ``cuda``).

    The row count comes first (`n_rows`, or the block headers — the
    block index of `scan_ingest` when given), so every device tensor is
    allocated once at its full size: the scalar columns (n,) f32, a dense
    shard (n, d) and a sparse one (n, sparse_k) int32 indices + values in
    the storage dtype `feature_dtype` (a torch dtype or its name; f32 by
    default). Each decoded chunk is copied into a pinned staging buffer
    and from it, ``non_blocking`` on a side stream, into its rows; a
    staging buffer is refilled only after the event of its previous
    upload (`_StagingRing`). ``prefetch`` is the number of staging buffers
    (an int, default 2, or a `data.ingest_plane.AdaptivePrefetch` that
    widens while those waits block, within its byte budget). Host memory:
    the staging buffers and the decoded chunk in hand — one shard (the
    whole dataset on one device) never materializes on the host. On the
    CPU the chunk is copied into its rows directly.

    ``workers``/``cache_dir``/``block_index``/``mode``/``pool`` as in
    `stream_to_host`; `chunk_hook(chunk)` runs on every decoded chunk
    before its upload — the bounded-memory seam for per-chunk validation
    and mergeable statistics.

    Returns (GameData with device-resident y/weights/offsets/shards,
    n_real); entity ids stay host numpy (they factorize on the host).

    With ``mesh`` (a `parallel.mesh.Mesh`) the rows shard contiguously
    over its slots (padded with weight 0 to a multiple of the slot
    count): each of THIS process's slots gets its rows, on its device,
    as `SlotRows` columns and shards, while other processes' rows stream
    past without materializing; entity ids stay host numpy and global.
    ``local_only=True`` (the per-process ingest split) goes further:
    chunk tasks (`ingest_plane.plan_chunk_tasks`, the serial stream's
    boundaries) whose rows fall entirely in other processes' slots are
    never decoded — their container blocks are never read — and
    ``ingest.chunks_skipped`` counts them; a boundary task decodes whole.
    Their entity ids fill with "", and ``cache_dir`` is refused (a
    partial decode must never commit a global cache entry).
    ``_local_mask`` (S booleans) narrows the slots this process fills —
    the one-process test seam for the multi-process slot arithmetic.
    """
    from photon_tpu_torch.data.ingest_plane import open_chunk_source

    if mesh is not None:
        return _stream_to_mesh(
            path, config, index_maps, mesh, chunk_rows, sparse_k,
            use_native, feature_dtype, chunk_hook, n_rows, _local_mask,
            workers, cache_dir, block_index, local_only, mode, pool)
    if local_only or _local_mask is not None:
        raise ValueError("local_only and _local_mask split a mesh's rows "
                         "over its processes: pass the mesh")
    dev = resolve_device(device)
    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k)
    if n_rows is not None:
        n_real = int(n_rows)
    else:
        n_real = sum(scan_row_counts(path, block_index=block_index))
    dense_shards = _dense_shard_flags(config, index_maps)
    f_dtype = feature_torch_dtype(feature_dtype)
    scalars = {k: torch.zeros(n_real, dtype=torch.float32, device=dev)
               for k in ("y", "weights", "offsets")}
    mats: dict = {}
    for s in config.shards:
        d = index_maps[s].n_features
        if dense_shards[s]:
            mats[s] = torch.zeros((n_real, d), dtype=f_dtype, device=dev)
        else:
            mats[s] = (torch.zeros((n_real, sparse_k), dtype=torch.int32,
                                   device=dev),
                       torch.zeros((n_real, sparse_k), dtype=f_dtype,
                                   device=dev))
    entity_cols: dict = {e: [] for e in config.entity_fields}
    ring = _StagingRing(dev, prefetch) if dev.type == "cuda" else None

    _, chunks = open_chunk_source(path, config, index_maps,
                                  chunk_rows=chunk_rows, sparse_k=sparse_k,
                                  use_native=use_native, workers=workers,
                                  cache_dir=cache_dir,
                                  block_index=block_index, mode=mode,
                                  pool=pool)
    row = 0
    for chunk in chunks:
        telemetry.count("ingest.chunks")
        telemetry.count("ingest.rows", chunk.n)
        if chunk_hook is not None:
            chunk_hook(chunk)
        n_c = chunk.n
        if row + n_c > n_real:
            raise ValueError(
                f"{path}: the stream yielded more than the {n_real} rows "
                "its row count promised (the files changed?)")
        for e in config.entity_fields:
            entity_cols[e].append(np.asarray(chunk.entity_ids[e]))
        # (name, host array, device view of this chunk's rows)
        cols = [(k, np.asarray(getattr(chunk, k), np.float32),
                 scalars[k][row:row + n_c]) for k in scalars]
        for s in config.shards:
            X = chunk.shards[s]
            if dense_shards[s]:
                cols.append((s, np.asarray(X), mats[s][row:row + n_c]))
            else:
                h_ind = np.asarray(X.indices)
                k_c = h_ind.shape[1]
                ind, val = mats[s]
                cols.append((s + ".indices", h_ind,
                             ind[row:row + n_c, :k_c]))
                cols.append((s + ".values", np.asarray(X.values),
                             val[row:row + n_c, :k_c]))
        if ring is None:
            for _, a, dst in cols:
                dst.copy_(_tensor(a))
        else:
            slot = ring.acquire({name: (tuple(dst.shape), dst.dtype)
                                 for name, _, dst in cols})
            pairs = []
            for name, a, dst in cols:
                stage = slot[name][:n_c]
                stage.copy_(_tensor(a))
                pairs.append((dst, stage))
            ring.upload(pairs)
        telemetry.count("ingest.device_chunks")
        row += n_c
    if row != n_real:
        raise ValueError(f"{path}: streamed {row} rows, the row count "
                         f"promised {n_real} (the files changed?)")
    if ring is not None:
        ring.finish()

    shards = {}
    for s in config.shards:
        if dense_shards[s]:
            shards[s] = mats[s]
        else:
            shards[s] = SparseRows(mats[s][0], mats[s][1],
                                   index_maps[s].n_features)
    ids = {}
    for e in config.entity_fields:
        # chunk producers already emit str ndarrays; concatenate promotes
        # to the widest str dtype, no per-row Python loop
        cols = entity_cols[e] or [np.zeros(0, dtype="U1")]
        ids[e] = np.concatenate([np.asarray(c, dtype=np.str_) for c in cols])
    data = GameData(scalars["y"], scalars["weights"], scalars["offsets"],
                    shards, ids)
    return data, n_real


def _local_task_chunks(tasks, config, index_maps, sparse_k, use_native,
                       local_rows):
    """The ``local_only`` chunk source: ``(chunk, n_rows)`` for tasks whose
    global row range overlaps one of the ``[lo, hi)`` intervals of
    ``local_rows`` (decoded in-process through the serial assembly path,
    bit-identical to the serial chunk at that position) and ``(None,
    n_rows)`` for the rest, whose container blocks are never read."""
    from photon_tpu_torch.data.ingest_plane import _decode_task, _DecodeState

    state = _DecodeState(config, index_maps, sparse_k, use_native)
    r0 = 0
    for task in tasks:
        r1 = r0 + task.n_rows
        if any(r0 < hi and r1 > lo for lo, hi in local_rows):
            chunk = _decode_task(state, task)[0]
            yield chunk, chunk.n
        else:
            yield None, task.n_rows
        r0 = r1


def _stream_to_mesh(path, config, index_maps, mesh, chunk_rows, sparse_k,
                    use_native, feature_dtype, chunk_hook, n_rows,
                    _local_mask, workers, cache_dir, block_index, local_only,
                    mode, pool) -> tuple:
    """`stream_to_device(mesh=...)`: each local slot's rows filled from
    the chunk stream straight into tensors on its device."""
    from photon_tpu_torch.data.ingest_plane import (open_chunk_source,
                                                    plan_chunk_tasks,
                                                    scan_or_reuse_block_index)
    from photon_tpu_torch.parallel.mesh import SlotRows, pad_to_multiple

    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k)
    S = mesh.n_slots
    mask = ([j in mesh.local_slots for j in range(S)] if _local_mask is None
            else [bool(m) and j in mesh.local_slots
                  for j, m in enumerate(_local_mask)])
    if len(mask) != S:
        raise ValueError(f"_local_mask has {len(mask)} entries for {S} "
                         "slots")
    local_tasks = None
    if local_only:
        if cache_dir is not None:
            raise ValueError(
                "stream_to_device(local_only=True) cannot tee the chunk "
                "cache: this process decodes only its own block ranges, and "
                "a partial decode must never commit a global cache entry — "
                "pre-build the cache with a full decode, or drop local_only")
        block_index = scan_or_reuse_block_index(path, block_index)
        local_tasks = plan_chunk_tasks(block_index, chunk_rows)
    if n_rows is not None:
        n_real = int(n_rows)
    elif local_tasks is not None:
        n_real = sum(t.n_rows for t in local_tasks)
    else:
        n_real = sum(scan_row_counts(path, block_index=block_index))
    s = pad_to_multiple(max(n_real, 1), S) // S
    dense_shards = _dense_shard_flags(config, index_maps)
    f_dtype = feature_torch_dtype(feature_dtype)
    # per local slot k (global slot j): its columns and shards, on its
    # device; slots the mask leaves out stay zero (weight 0)
    scal, mats = [], []
    for dev in mesh.slot_devices:
        scal.append({c: torch.zeros(s, dtype=torch.float32, device=dev)
                     for c in ("y", "weights", "offsets")})
        m = {}
        for sh in config.shards:
            d = index_maps[sh].n_features
            m[sh] = (torch.zeros((s, d), dtype=f_dtype, device=dev)
                     if dense_shards[sh] else
                     (torch.zeros((s, sparse_k), dtype=torch.int32,
                                  device=dev),
                      torch.zeros((s, sparse_k), dtype=f_dtype, device=dev)))
        mats.append(m)
    lo_slot = mesh.local_slots[0]
    entity_cols: dict = {e: [] for e in config.entity_fields}
    if local_tasks is not None:
        local_rows = [(j * s, (j + 1) * s) for j in range(S) if mask[j]]
        chunk_iter = _local_task_chunks(local_tasks, config, index_maps,
                                        sparse_k, use_native, local_rows)
    else:
        _, chunks = open_chunk_source(path, config, index_maps,
                                      chunk_rows=chunk_rows,
                                      sparse_k=sparse_k,
                                      use_native=use_native, workers=workers,
                                      cache_dir=cache_dir,
                                      block_index=block_index, mode=mode,
                                      pool=pool)
        chunk_iter = ((c, c.n) for c in chunks)
    row = 0
    for chunk, n_c in chunk_iter:
        if row + n_c > n_real:
            raise ValueError(
                f"{path}: the stream yielded more than the {n_real} rows "
                "its row count promised (the files changed?)")
        if chunk is None:
            telemetry.count("ingest.chunks_skipped")
            for e in config.entity_fields:
                entity_cols[e].append(np.full(n_c, "", dtype="U1"))
            row += n_c
            continue
        telemetry.count("ingest.chunks")
        telemetry.count("ingest.rows", chunk.n)
        if chunk_hook is not None:
            chunk_hook(chunk)
        for e in config.entity_fields:
            entity_cols[e].append(np.asarray(chunk.entity_ids[e]))
        host = {c: _tensor(np.asarray(getattr(chunk, c), np.float32))
                for c in ("y", "weights", "offsets")}
        for sh in config.shards:
            X = chunk.shards[sh]
            host[sh] = (_tensor(np.asarray(X)) if dense_shards[sh] else
                        (_tensor(np.asarray(X.indices)),
                         _tensor(np.asarray(X.values))))
        # the chunk's rows [row, row + n_c) cut at slot boundaries
        for j in range(row // s, min((row + n_c - 1) // s, S - 1) + 1):
            if not mask[j]:
                continue
            a, b = max(row, j * s), min(row + n_c, (j + 1) * s)
            src, dst = slice(a - row, b - row), slice(a - j * s, b - j * s)
            k = j - lo_slot
            for c in ("y", "weights", "offsets"):
                scal[k][c][dst].copy_(host[c][src])
            for sh in config.shards:
                if dense_shards[sh]:
                    mats[k][sh][dst].copy_(host[sh][src])
                else:
                    ind, val = mats[k][sh]
                    h_ind, h_val = host[sh]
                    k_c = h_ind.shape[1]
                    ind[dst, :k_c].copy_(h_ind[src])
                    val[dst, :k_c].copy_(h_val[src])
        telemetry.count("ingest.device_chunks")
        row += n_c
    if row != n_real:
        raise ValueError(f"{path}: streamed {row} rows, the row count "
                         f"promised {n_real} (the files changed?)")

    def rows(parts):
        return SlotRows(mesh, tuple(parts), s)

    shards = {}
    for sh in config.shards:
        if dense_shards[sh]:
            shards[sh] = rows(m[sh] for m in mats)
        else:
            shards[sh] = rows(SparseRows(m[sh][0], m[sh][1],
                                         index_maps[sh].n_features)
                              for m in mats)
    ids = {}
    for e in config.entity_fields:
        cols = entity_cols[e] or [np.zeros(0, dtype="U1")]
        if S * s > n_real:
            cols = cols + [np.full(S * s - n_real, "", dtype="U1")]
        ids[e] = np.concatenate([np.asarray(c, dtype=np.str_) for c in cols])
    data = GameData(rows(sc["y"] for sc in scal),
                    rows(sc["weights"] for sc in scal),
                    rows(sc["offsets"] for sc in scal), shards, ids)
    return data, n_real
