"""Chunked Avro ingestion: block-streamed Avro → GameData chunks, on the
pure-Python decode path (the part of `photon_tpu/data/streaming.py` the
in-memory drivers use; `stream_to_device`, `stream_to_host` and the
native chunk decoder wait for ROADMAP queue A item 8b).

Reference parity: com.linkedin.photon.ml.data.avro.AvroDataReader reads
partitioned HDFS data through Spark — the dataset never materializes on one
host. Here:

- `iter_game_chunks`: an iterator of GameData CHUNKS, assembled container
  block by container block; the host arena stays bounded by ~2 chunks
  regardless of dataset size, and multi-file inputs stream file after
  file (the scoring driver's reader);
- `scan_ingest`: one pass over the containers that builds any missing
  frozen index maps and records the block index (a header-only scan when
  every map is given — the training driver's auto-streaming check).

Chunks are container-block-aligned: a chunk closes at the first block
boundary at or after `chunk_rows`, so concatenating the chunks reproduces
the one-shot `read_game_data` result exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from photon_tpu_torch.data.avro_io import AvroContainerReader, avro_paths
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, \
    feature_key
from photon_tpu_torch.data.ingest import (
    GameDataConfig,
    entity_id_or_none,
    normalize_bag,
    numeric_or_none,
    records_to_game_data,
)
from photon_tpu_torch.data.matrix import SparseRows, next_pow2
from photon_tpu_torch.game.dataset import GameData


def _open_reader(p) -> AvroContainerReader:
    """One Avro container (the reference's retry with backoff on open,
    `checkpoint.faults.retry_io`, waits for ROADMAP queue A item 8b)."""
    return AvroContainerReader(p)


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
    into the map-building scan, so preallocating device buffers
    costs no extra pass."""

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
    missing (first-seen order, bags in shard-config order — the ids
    `read_game_data` assigns) while recording the block index as a side
    effect of the same walk. When every map is prebuilt the pass degrades
    to the header-only scan (no payload decompress)."""
    index_maps = dict(index_maps or {})
    todo = {s: cfg for s, cfg in config.shards.items() if s not in index_maps}
    index_out: dict = {}
    if todo:
        index_maps = _build_index_maps_streaming(path, index_maps, todo,
                                                 index_out)
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
            f"(missing {missing}); run scan_ingest (or the indexing "
            "driver) first — ids cannot be assigned "
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


def _build_index_maps_streaming(path, index_maps: dict, todo: dict,
                                index_out: dict) -> dict:
    """The map-building walk: each record's bags of the shards in ``todo``
    assign ids; every block's (offset, count, size) goes to
    ``index_out``."""
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
        index_out[str(p)] = entries
    for s, cfg in todo.items():
        if cfg.has_intercept:
            building[s].index_of(INTERCEPT_KEY)
        index_maps[s] = building[s].freeze()
    return index_maps


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
    read. `use_native` as in ingest.read_game_data: True raises (the
    native chunk decoder is ROADMAP queue A item 8b).

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
    if use_native:
        raise NotImplementedError(
            "the native chunk decoder (photon_tpu/native) is not ported yet "
            "(ROADMAP queue A item 8b); use_native=None or False streams "
            "through the pure-Python decoder")
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
    boundaries, as the reference's native path does, so chunking is the
    same whichever decoder runs."""
    return _python_chunks_from_readers(
        [_open_reader(p) for p in avro_paths(path)], stream)


def _python_chunks_from_readers(readers, stream: ChunkStream
                                ) -> Iterator[GameData]:
    """The reader-level body of `_python_chunks`: any AvroContainerReader-
    shaped sources stream through the SAME record buffering and assembly."""
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
