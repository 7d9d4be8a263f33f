"""The ingest data plane, as one importable face (the port's copy of
`photon_tpu/ingest/__init__.py`).

The implementation lives beside the rest of the data layer —
`photon_tpu_torch.data.ingest_plane` (sharded decode workers, the
chunk-source seam, stall-driven prefetch) and
`photon_tpu_torch.data.chunk_cache` (the decode-once columnar chunk
cache); this package re-exports the public API. Selftest: ``python -m
photon_tpu_torch.ingest --selftest [--device cpu]``.
"""
from photon_tpu_torch.data.chunk_cache import (  # noqa: F401
    CACHE_SCHEMA_VERSION,
    ChunkCacheCorrupt,
    ChunkCacheSchemaError,
    cache_key,
    open_cache,
    open_ladder,
    save_ladder,
)
from photon_tpu_torch.data.ingest_plane import (  # noqa: F401
    AdaptivePrefetch,
    ChunkTask,
    chunk_blocked_ell_from_avro,
    iter_game_chunks_parallel,
    open_chunk_source,
    plan_chunk_tasks,
    scan_or_reuse_block_index,
)
from photon_tpu_torch.data.streaming import (  # noqa: F401
    IngestScan,
    scan_ingest,
)

__all__ = [
    "AdaptivePrefetch", "ChunkTask", "IngestScan", "CACHE_SCHEMA_VERSION",
    "ChunkCacheCorrupt", "ChunkCacheSchemaError", "cache_key",
    "chunk_blocked_ell_from_avro", "iter_game_chunks_parallel",
    "open_cache", "open_chunk_source", "open_ladder", "plan_chunk_tasks",
    "save_ladder", "scan_ingest", "scan_or_reuse_block_index",
]
