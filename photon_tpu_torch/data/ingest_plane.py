"""Parallel ingest data plane: sharded Avro decode workers, a decode-once
chunk cache, and stall-driven prefetch (the port's copy of
`photon_tpu/data/ingest_plane.py`).

Every streamed regime bottoms out in ONE single-process Avro container
reader feeding host chunks (`data.streaming`); at scale the device starves
on decode long before its memory or the blocked-ELL kernels matter
(`stream.stalled_passes` measures exactly that). Three coordinated
pieces:

- **Sharded parallel decode** (`iter_game_chunks_parallel`): the
  container's block index is partitioned into CHUNK TASKS at exactly the
  block boundaries the serial stream closes chunks on, and a pool of
  worker processes decodes them concurrently — each worker reads only
  its blocks (`AvroContainerReader.blocks_at`), runs the SAME
  record→GameData assembly as the serial path
  (`streaming._python_chunks_from_readers` /
  `_native_chunks_from_readers`, so chunks are bit-identical by
  construction), and results flow back through a bounded ORDERED window
  that preserves today's chunk order bit-for-bit. A dead worker (real
  crash, broken pool, or the deterministic ``ingest_worker`` fault site)
  degrades that chunk to in-process decode — never a hung run.
- **Decode-once chunk cache** (`data.chunk_cache`, wired through
  `open_chunk_source`): decoded chunks commit to a versioned on-disk
  entry (mmap-able ``.npy`` blocks, manifest committed LAST via
  `checkpoint.store.commit_bytes`), keyed by source fingerprint +
  `GameDataConfig` + frozen index maps + chunk layout — a second epoch
  or a re-run opens mmap'd chunks and never touches Avro again.
- **Stall-driven prefetch** (:class:`AdaptivePrefetch`): the chunk
  stream's prefetch depth WIDENS while measured upload stall is nonzero,
  up to a byte budget, with every decision recorded (its ``decisions``
  list, ``stream.prefetch_widened`` / ``stream.prefetch_narrowed``).

The phases' wall seconds are `telemetry` counters: ``ingest.decode_seconds``
(in-process decode, and the wait for a worker's chunk),
``ingest.cache_open_seconds``, ``ingest.cache_read_seconds``,
``ingest.cache_commit_seconds`` and ``ingest.layout_seconds``.

Worker-pool execution modes: ``process`` (the real plane — spawn-context
workers, decode fully off the consumer; a worker never initializes CUDA:
decode is host work), ``thread`` (same task planning /
ordering / fault machinery on threads — IO-bound decoders and tests), and
``inline`` (task machinery without concurrency — debugging). Direct
blocked-ELL construction (`chunk_blocked_ell_from_avro`) builds the
sparse chunk ladder straight from Avro — decode-parallel, cacheable as a
finished layout — so layout construction also leaves the training
critical path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np

from photon_tpu_torch import native, telemetry
from photon_tpu_torch.checkpoint import faults
from photon_tpu_torch.data.avro_io import AvroContainerReader, avro_paths
from photon_tpu_torch.data.ingest import GameDataConfig, native_fallback
from photon_tpu_torch.data import streaming as _streaming
from photon_tpu_torch.data.streaming import (
    ChunkStream,
    _chunk_nbytes,
    _frozen_maps_or_raise,
    _native_chunks_from_readers,
    _open_reader,
    _python_chunks_from_readers,
)
from photon_tpu_torch.utils.logging import photon_logger

__all__ = [
    "AdaptivePrefetch", "ChunkTask", "DecodePool", "plan_chunk_tasks",
    "iter_game_chunks_parallel", "open_chunk_source",
    "chunk_blocked_ell_from_avro", "scan_or_reuse_block_index",
]


# ------------------------------------------------------------ stall-driven
# prefetch: the controller `ChunkedBatch.iter_device` / `stream_to_device`
# consult instead of a fixed int. Depth only ever changes BETWEEN awaits,
# so results are bit-identical at any depth — this is purely an overlap
# knob.


@dataclasses.dataclass
class AdaptivePrefetch:
    """Stall-driven prefetch depth, bounded by a byte budget.

    `observe` (once per streaming pass, from `iter_device`) widens the
    window while the pass's measured transfer stall exceeds
    ``widen_frac`` of its compute — one step normally, two when stall
    dominates compute outright — and narrows one step after an entirely
    stall-free pass above the floor. `observe_wait` (per await, from
    `stream_to_device`'s single ingest pass) widens as soon as an await
    actually blocked. The byte budget caps depth at
    ``byte_budget // item_bytes`` so a deep window can never hold more
    than ~``byte_budget`` of in-flight chunk uploads.

    Every decision lands in ``decisions`` (inputs and verdict) and in
    telemetry: a ``prefetch_decision`` event, ``stream.prefetch_widened``
    / ``stream.prefetch_narrowed`` counters and the ``stream.prefetch_depth``
    gauge the ring sets.
    """

    depth: int = 2
    min_depth: int = 2
    max_depth: int = 16
    byte_budget: int = 1 << 30
    widen_frac: float = 0.05
    decisions: list = dataclasses.field(default_factory=list)

    def _cap(self, item_bytes: int) -> int:
        cap = self.max_depth
        if item_bytes and item_bytes > 0:
            cap = min(cap, max(int(self.byte_budget // item_bytes), 1))
        return max(cap, 1)

    def _decide(self, new_depth: int, why: str, **fields) -> None:
        old, self.depth = self.depth, new_depth
        if new_depth > old:
            telemetry.count("stream.prefetch_widened")
        elif new_depth < old:
            telemetry.count("stream.prefetch_narrowed")
        record = {"prev_depth": old, "depth": new_depth, "why": why,
                  **fields}
        self.decisions.append(record)
        telemetry.event("prefetch_decision", **record)

    def observe(self, stall_s: float, compute_s: float, n_items: int,
                item_bytes: int) -> None:
        """One streaming pass's verdict (iter_device calls this at
        exhaustion with its measured totals)."""
        cap = self._cap(item_bytes)
        target = min(self.depth, cap)
        why = "steady"
        if stall_s > self.widen_frac * max(compute_s, 1e-9):
            step = 2 if stall_s > compute_s else 1
            target, why = min(self.depth + step, cap), "stalled"
        elif stall_s <= 0.0 and self.depth > self.min_depth:
            target, why = self.depth - 1, "stall-free"
        self._decide(target, why, stall_s=round(stall_s, 6),
                     compute_s=round(compute_s, 6), n_items=n_items,
                     item_bytes=int(item_bytes), cap=cap)

    def observe_wait(self, waited_s: float, item_bytes: int) -> None:
        """One actually-blocking await inside a single ingest pass
        (stream_to_device): widen immediately while under the budget."""
        if waited_s <= 1e-4:
            return
        cap = self._cap(item_bytes)
        if self.depth < cap:
            self._decide(self.depth + 1, "upload-wait",
                         waited_s=round(waited_s, 6),
                         item_bytes=int(item_bytes), cap=cap)


# --------------------------------------------------------------- task plan


@dataclasses.dataclass(frozen=True)
class ChunkTask:
    """One chunk's worth of container blocks: ordered (path, entries)
    segments where entries are [(offset, count, size)] block-index rows.
    Tasks partition the stream at EXACTLY the block boundaries the serial
    chunker closes chunks on, so task i's decode == serial chunk i."""

    chunk_id: int
    segments: tuple  # ((path, ((offset, count, size), ...)), ...)
    n_rows: int


def scan_or_reuse_block_index(path, block_index: Optional[dict] = None
                              ) -> dict:
    """path -> [(offset, count, size)] for every container of ``path`` —
    reusing `streaming.scan_ingest`'s index when the caller already has
    it (cold start touches each file's headers once)."""
    if block_index is not None:
        return block_index
    return {str(p): _open_reader(p).block_index() for p in avro_paths(path)}


def plan_chunk_tasks(block_index: dict, chunk_rows: int) -> list:
    """Split the block index into ChunkTasks: accumulate blocks (across
    file boundaries, exactly like the serial record buffer) until a task
    reaches ``chunk_rows`` rows, close it at that block boundary."""
    tasks: list = []
    segs: list = []  # [(path, [entry, ...])]
    rows = 0

    def close():
        nonlocal segs, rows
        tasks.append(ChunkTask(
            len(tasks),
            tuple((p, tuple(entries)) for p, entries in segs),
            rows))
        segs, rows = [], 0

    for p, entries in block_index.items():
        for entry in entries:
            if not segs or segs[-1][0] != p:
                segs.append((p, []))
            segs[-1][1].append(entry)
            rows += int(entry[1])
            if rows >= chunk_rows:
                close()
    if rows or (segs and not tasks):
        close()
    return tasks


class _BlockSliceReader(AvroContainerReader):
    """An AvroContainerReader restricted to a block-index slice: `blocks`
    random-accesses exactly those entries — a decode worker's view of the
    container."""

    def __init__(self, path, entries):
        super().__init__(path)  # header parse: schema / codec / sync
        self._entries = tuple(entries)

    def blocks(self, skip_payload: bool = False):
        if skip_payload:
            for _, count, _ in self._entries:
                yield count, b""
            return
        yield from self.blocks_at(self._entries)


# ------------------------------------------------------------ worker pool


@dataclasses.dataclass
class _DecodeState:
    """Everything a worker needs to decode one task — pickled ONCE per
    worker at pool start (initializer), not per task."""

    config: GameDataConfig
    index_maps: dict
    sparse_k: Optional[int]
    use_native: Optional[bool]
    # the frozen native stores, built once per state (per worker process;
    # shared read-only by a thread pool's tasks) — never pickled
    _stores: Optional[list] = dataclasses.field(default=None, repr=False)
    _lock: object = dataclasses.field(default=None, repr=False)

    def __getstate__(self):
        return {**self.__dict__, "_stores": None, "_lock": None}

    def stores(self) -> list:
        from photon_tpu_torch.data.native_ingest import frozen_stores

        if self._lock is None:
            self._lock = threading.Lock()
        with self._lock:
            if self._stores is None:
                self._stores = frozen_stores(self.index_maps,
                                             list(self.config.shards))
            return self._stores


_WORKER_STATE: Optional[_DecodeState] = None


def _worker_init(state: _DecodeState) -> None:
    global _WORKER_STATE
    _WORKER_STATE = state


def _decode_task(state: _DecodeState, task: ChunkTask) -> tuple:
    """Decode ONE chunk task through the exact serial assembly path: the
    task's block slices stream through `_native_chunks_from_readers` /
    `_python_chunks_from_readers` with an unreachable chunk_rows, so
    exactly one chunk comes out — bit-identical to the serial stream's
    chunk at this position by construction."""
    readers = [_BlockSliceReader(p, entries) for p, entries in task.segments]
    stream = ChunkStream(state.config, state.index_maps,
                         chunk_rows=1 << 62, sparse_k=state.sparse_k)
    gen = None
    if state.use_native is not False:
        gen = (_native_chunks_from_readers(readers, stream,
                                           stores=state.stores())
               if native.available() else None)
        if gen is None:
            native_fallback(f"chunk task {task.chunk_id}", state.use_native)
    if gen is None:
        gen = _python_chunks_from_readers(readers, stream)
    chunks = list(gen)
    if len(chunks) != 1:
        raise AssertionError(
            f"chunk task {task.chunk_id} decoded to {len(chunks)} chunks")
    return (chunks[0], stream.last_response_mask,
            stream.last_entity_presence, stream.saw_missing_response)


def _pool_decode(task: ChunkTask) -> tuple:
    """A process worker's task: the decode, plus the ``ingest.*`` counts
    it made in this process (a fallback, say), which the consumer adds to
    its own registry."""
    before = telemetry.snapshot()["counters"]
    out = _decode_task(_WORKER_STATE, task)
    after = telemetry.snapshot()["counters"]
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()
             if k.startswith("ingest.") and v != before.get(k, 0.0)}
    return out + (delta,)


def _pool_key(workers: int, state: _DecodeState) -> tuple:
    from photon_tpu_torch.data.chunk_cache import index_map_digest

    return (workers, repr(state.config), state.sparse_k, state.use_native,
            tuple(sorted((s, index_map_digest(m))
                         for s, m in state.index_maps.items())))


def _spawn_pool(workers: int, state: _DecodeState):
    """A spawn-context process pool whose workers hold ``state``: they
    carry no forked CUDA or runtime state; each imports the decode stack
    fresh."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init, initargs=(state,))
    telemetry.count("ingest.pool_starts")
    return pool


class DecodePool:
    """Process decode workers that their owner keeps across several
    streams (the training driver's training and validation reads): a
    spawn worker's start (a fresh interpreter importing the decode stack,
    torch with it) costs seconds. The workers start at the first stream
    that needs them, and again when a stream's decode state (config,
    sparse_k, use_native, the index maps by digest) or worker count
    differs from theirs. A stream given no pool starts its own and stops
    it at its end, as the reference does. Close it, or use it as a
    context manager."""

    def __init__(self):
        self._key = None
        self._executor = None

    def executor(self, workers: int, state: _DecodeState):
        key = _pool_key(workers, state)
        if self._executor is None or self._key != key:
            self.close()
            self._executor = _spawn_pool(workers, state)
            self._key = key
        return self._executor

    def discard(self, executor) -> None:
        """Stop a broken executor (the next stream starts another)."""
        if executor is self._executor:
            self._executor = self._key = None
        executor.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = self._key = None

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _make_pool(mode: str, workers: int, state: _DecodeState,
               owner: Optional[DecodePool]):
    """(executor, submit) or (None, None) for inline decode. A process
    pool is ``owner``'s when one is given, else the stream's own; a
    thread pool lives for one stream. A pool that cannot start (e.g. an
    unpicklable index map) degrades to inline decode with a warning."""
    if mode == "inline" or workers <= 0:
        return None, None
    try:
        if mode == "thread":
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="photon-ingest")
            return pool, lambda t: pool.submit(_decode_task, state, t)
        pool = (owner.executor(workers, state) if owner is not None
                else _spawn_pool(workers, state))
        return pool, lambda t: pool.submit(_pool_decode, t)
    except Exception as e:  # noqa: BLE001 — degrade, never hang the run
        photon_logger("photon_tpu_torch.ingest").warning(
            "ingest worker pool failed to start (%s); decoding in-process",
            e)
        telemetry.count("ingest.worker_deaths")
        return None, None


def iter_game_chunks_parallel(
    path,
    config: GameDataConfig,
    index_maps: dict,
    chunk_rows: int = 65536,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
    workers: int = 2,
    mode: str = "process",
    queue_depth: Optional[int] = None,
    block_index: Optional[dict] = None,
    pool: Optional[DecodePool] = None,
) -> tuple[ChunkStream, Iterator]:
    """(stream handle, chunk iterator) like `streaming.iter_game_chunks`,
    decoded by a sharded worker pool. Chunk ORDER and CONTENT are
    bit-identical to the serial stream: tasks are planned at the serial
    chunk boundaries and retired strictly in order through a bounded
    window (``queue_depth``, default workers+2 — bounds both host memory
    and how far the pool runs ahead).

    Fault story: the ``ingest_worker`` site fires once per retired task;
    an injected kill there — or any real worker/pool failure — degrades
    THAT chunk to in-process decode (counted on ``ingest.worker_deaths``,
    logged once per incident) and a broken pool downgrades the rest of
    the stream to in-process decode. Genuine data errors (malformed
    blocks) re-raise from the in-process retry, so corruption still
    fails loudly rather than hiding behind the degrade path.

    ``mode="process"`` decodes on ``pool``'s workers when one is given
    (it outlives the stream), else on workers of the stream's own.
    """
    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k)
    stream = ChunkStream(config, index_maps, chunk_rows, sparse_k)
    bidx = scan_or_reuse_block_index(path, block_index)
    tasks = plan_chunk_tasks(bidx, chunk_rows)
    state = _DecodeState(config, index_maps, sparse_k, use_native)
    depth = max(int(queue_depth) if queue_depth else workers + 2, 1)

    owner = pool if mode == "process" else None

    def generator():
        pool, submit = _make_pool(mode, workers, state, owner)
        telemetry.gauge("ingest.workers", workers if pool is not None else 0)
        futs: dict = {}
        submitted = 0
        logged_death = False
        try:
            for i, task in enumerate(tasks):
                while (submit is not None and submitted < len(tasks)
                       and submitted - i < depth):
                    futs[submitted] = submit(tasks[submitted])
                    submitted += 1
                result = None
                if submit is not None:
                    fut = futs.pop(i)
                    t0 = time.perf_counter()
                    try:
                        # the deterministic worker-death site: one hit per
                        # retired task, so a kill matrix can kill the
                        # first / middle / last worker result exactly
                        faults.kill_point("ingest_worker")
                        result = fut.result()
                        telemetry.count("ingest.decode_seconds",
                                        time.perf_counter() - t0)
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:  # noqa: BLE001
                        telemetry.count("ingest.worker_deaths")
                        if not logged_death:
                            logged_death = True
                            photon_logger("photon_tpu_torch.ingest").warning(
                                "ingest worker died on chunk %d (%s: %s); "
                                "decoding in-process", i, type(e).__name__,
                                e)
                        from concurrent.futures.process import \
                            BrokenProcessPool
                        if isinstance(e, BrokenProcessPool):
                            if owner is not None:
                                owner.discard(pool)
                            else:
                                pool.shutdown(wait=False, cancel_futures=True)
                            pool, submit = None, None
                            futs.clear()
                if result is None:
                    t0 = time.perf_counter()
                    result = _decode_task(state, task)
                    telemetry.count("ingest.decode_seconds",
                                    time.perf_counter() - t0)
                else:
                    telemetry.count("ingest.worker_chunks")
                for k, v in (result[4] if len(result) > 4 else {}).items():
                    telemetry.count(k, v)
                chunk, mask, presence, saw = result[:4]
                stream.last_response_mask = mask
                stream.last_entity_presence = presence
                stream.saw_missing_response |= bool(saw)
                # the in-flight window + the retired chunk is the arena
                stream._note((1 + len(futs)) * _chunk_nbytes(chunk))
                yield chunk
        finally:
            for fut in futs.values():  # an abandoned stream's leftovers
                fut.cancel()
            if pool is not None and owner is None:
                pool.shutdown(wait=False, cancel_futures=True)

    return stream, generator()


# --------------------------------------------------------- chunk source


def open_chunk_source(
    path,
    config: GameDataConfig,
    index_maps: dict,
    chunk_rows: int = 65536,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
    workers: int = 0,
    cache_dir=None,
    block_index: Optional[dict] = None,
    mode: str = "process",
    pool: Optional[DecodePool] = None,
) -> tuple[ChunkStream, Iterator]:
    """THE chunk-source seam `stream_to_host` / `stream_to_device` read
    through: cache hit → mmap'd cached chunks (Avro untouched); miss →
    serial or worker-pool decode, teed into the cache when ``cache_dir``
    is set (manifest committed at exhaustion — a kill mid-build leaves a
    miss, never a torn entry). Decode / cache wall-seconds are telemetry
    counters (``ingest.decode_seconds``, ``ingest.cache_*_seconds``)."""
    from photon_tpu_torch.data import chunk_cache as cc

    key = None
    if cache_dir is not None:
        key = cc.cache_key(path, config, index_maps, chunk_rows, sparse_k,
                           kind="game_chunks")
        t0 = time.perf_counter()
        bag = cc.open_cache(cache_dir, key, "game_chunks")
        telemetry.count("ingest.cache_open_seconds",
                        time.perf_counter() - t0)
        if bag is not None:
            telemetry.count("ingest.cache_hits")
            stream = ChunkStream(config, dict(index_maps), chunk_rows,
                                 sparse_k)
            return stream, _cached_chunks(bag, stream)
        telemetry.count("ingest.cache_misses")

    if workers and workers > 0:
        stream, chunks = iter_game_chunks_parallel(
            path, config, index_maps, chunk_rows=chunk_rows,
            sparse_k=sparse_k, use_native=use_native, workers=workers,
            mode=mode, block_index=block_index, pool=pool)
    else:
        # module-attribute lookup, not a from-import: test spies replace
        # streaming.iter_game_chunks and must see this call
        stream, chunks = _streaming.iter_game_chunks(
            path, config, index_maps, chunk_rows=chunk_rows,
            sparse_k=sparse_k, use_native=use_native)
        chunks = _attributed_decode(chunks)
    if cache_dir is not None:
        chunks = _caching_chunks(chunks, cache_dir, key, config, stream)
    return stream, chunks


def _attributed_decode(chunks):
    """The serial decode path's wall seconds per chunk, counted on
    ``ingest.decode_seconds``."""
    def gen():
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                return
            telemetry.count("ingest.decode_seconds",
                            time.perf_counter() - t0)
            yield chunk

    return gen()


def _cached_chunks(bag, stream: ChunkStream):
    """Iterate a cache hit: mmap'd chunk loads count on
    ``ingest.cache_read_seconds``; the stream handle's arena accounting
    and mask/presence fields behave exactly as a live decode."""
    from photon_tpu_torch.data.chunk_cache import iter_cached_chunks

    def gen():
        it = iter_cached_chunks(bag, stream)
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                return
            telemetry.count("ingest.cache_read_seconds",
                            time.perf_counter() - t0)
            stream._note(_chunk_nbytes(chunk))
            yield chunk

    return gen()


def _caching_chunks(chunks, cache_dir, key: str, config, stream):
    """Tee a cold decode into the cache: every chunk's arrays land as
    durable payloads while the consumer streams on; the manifest commits
    LAST at exhaustion. A death anywhere in between (including the
    ``cache_commit`` kill site) leaves a manifest-less directory — the
    next open misses and falls back to Avro."""
    from photon_tpu_torch.data import chunk_cache as cc

    def gen():
        w = cc.save_game_chunks_start(cache_dir, key, config)
        for chunk in chunks:
            cc.add_game_chunk(w, chunk,
                              response_mask=stream.last_response_mask,
                              entity_presence=stream.last_entity_presence)
            yield chunk
        w.meta["saw_missing_response"] = bool(stream.saw_missing_response)
        t0 = time.perf_counter()
        w.commit()
        telemetry.count("ingest.cache_commit_seconds",
                        time.perf_counter() - t0)
        telemetry.count("ingest.cache_builds")

    return gen()


# ------------------------------------------- direct-to-blocked-ELL ladder


def chunk_blocked_ell_from_avro(
    path,
    config: GameDataConfig,
    index_maps: dict,
    shard: str,
    objective_chunk_rows: int,
    d_dense: int = 1024,
    n_shards: int = 1,
    feature_dtype=None,
    sparse_k: Optional[int] = None,
    chunk_rows: int = 65536,
    workers: int = 0,
    cache_dir=None,
    block_index: Optional[dict] = None,
    mode: str = "process",
    use_native: Optional[bool] = None,
):
    """Avro → finished blocked-ELL chunk ladder (a ChunkedBatch), with
    decode parallelized across the worker pool and the COMPLETED layout
    cached: sparse layout construction (the global column permutation +
    per-chunk ELL/occurrence bucketing of `data.dataset.chunk_blocked_ell`)
    runs once, off the training critical path — a cache hit mmap-opens
    the ladder and touches neither Avro nor the builder. ``feature_dtype``
    is a torch dtype or its name; ``n_shards > 1`` lays the ladder for a
    mesh of that many slots (`data.dataset.chunk_blocked_ell`)."""
    from photon_tpu_torch.data import chunk_cache as cc
    from photon_tpu_torch.data.dataset import GLMBatch, chunk_blocked_ell
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.data.streaming import feature_torch_dtype

    index_maps = _frozen_maps_or_raise(config, index_maps, sparse_k)
    f_dtype = (None if feature_dtype is None
               else feature_torch_dtype(feature_dtype))
    extra = {"shard": shard, "d_dense": int(d_dense),
             "n_shards": int(n_shards), "decode_chunk_rows": int(chunk_rows),
             "feature_dtype": None if f_dtype is None
             else str(f_dtype).replace("torch.", "")}
    key = None
    if cache_dir is not None:
        key = cc.cache_key(path, config, index_maps, objective_chunk_rows,
                           sparse_k, kind="ladder", extra=extra)
        t0 = time.perf_counter()
        cb = cc.open_ladder(cache_dir, key)
        telemetry.count("ingest.cache_open_seconds",
                        time.perf_counter() - t0)
        if cb is not None:
            telemetry.count("ingest.cache_hits")
            return cb
        telemetry.count("ingest.cache_misses")

    _, chunks = open_chunk_source(
        path, config, index_maps, chunk_rows=chunk_rows, sparse_k=sparse_k,
        use_native=use_native, workers=workers, block_index=block_index,
        mode=mode)
    ys, wts, offs, inds, vals = [], [], [], [], []
    d = index_maps[shard].n_features
    for chunk in chunks:
        X = chunk.shards[shard]
        if not isinstance(X, SparseRows):
            raise TypeError(
                f"shard {shard!r} decoded dense (d={d} <= its "
                "dense_threshold); the blocked-ELL ladder is for sparse "
                "shards — raise dense_threshold only if you mean it")
        ys.append(np.asarray(chunk.y))
        wts.append(np.asarray(chunk.weights))
        offs.append(np.asarray(chunk.offsets))
        inds.append(np.asarray(X.indices))
        vals.append(np.asarray(X.values))
    batch = GLMBatch(
        SparseRows(np.concatenate(inds), np.concatenate(vals), d),
        np.concatenate(ys), np.concatenate(wts), np.concatenate(offs))
    t0 = time.perf_counter()
    cb = chunk_blocked_ell(batch, objective_chunk_rows, d_dense=d_dense,
                           feature_dtype=f_dtype, n_shards=n_shards)
    telemetry.count("ingest.layout_seconds", time.perf_counter() - t0)
    if cache_dir is not None:
        t0 = time.perf_counter()
        cc.save_ladder(cache_dir, key, cb)
        telemetry.count("ingest.cache_commit_seconds",
                        time.perf_counter() - t0)
        telemetry.count("ingest.cache_builds")
    return cb
