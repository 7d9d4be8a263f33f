"""Feature-indexing driver: Avro data in → per-shard feature index maps out.

Reference parity: com.linkedin.photon.ml.index.FeatureIndexingDriver /
FeatureIndexingJob — the offline job that scans training data once and
builds one PalDB index map per feature-shard configuration, so training and
scoring runs can share a frozen name⇒id mapping instead of rebuilding it
per job. Here the maps are data.index_map.IndexMap files (the TSV format
IndexMap.save writes); consume them via
``TrainingParams(index_map_dir=...)`` or directly with
``read_game_data(..., index_maps=load_index_maps(...))``. Same
intercept-last convention as data.feature_bags.

``min_count`` drops features seen fewer than that many times — the
high-cardinality pruning knob (rare features cost index space and learn
nothing at minimum support).

The port's copy of `photon_tpu/drivers/index.py`: the same files, ids and
order (``python -m photon_tpu_torch.drivers.index --config job.json``).
The count runs through the native block decoder in build mode (its
stores assign ids in first-seen order, and a bincount of each block's
column ids is the occurrence count) unless ``use_native=False``; the
reference counts every record in Python, which the port keeps as the
fallback (`ingest.native_fallback`: logged and counted).
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import Counter
from typing import Optional

import numpy as np

from photon_tpu_torch.data.avro_io import read_avro
from photon_tpu_torch.data.feature_bags import FeatureShardConfig
from photon_tpu_torch.data.index_map import IndexMap, feature_key
from photon_tpu_torch.data.ingest import (GameDataConfig, native_fallback,
                                          normalize_bag)
from photon_tpu_torch.utils.logging import photon_logger
from photon_tpu_torch.utils.timing import PhaseTimers


@dataclasses.dataclass
class IndexingParams:
    """Reference: FeatureIndexingDriver's parameter set."""

    data_path: str
    output_dir: str
    feature_shards: dict  # shard name -> FeatureShardConfig or dict form
    min_count: int = 1
    # True forces the native decoder, False pure Python, None tries native
    # and falls back (as `read_game_data`'s use_native)
    use_native: Optional[bool] = None

    def __post_init__(self):
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")
        self.feature_shards = {
            k: FeatureShardConfig.coerce(v)
            for k, v in self.feature_shards.items()
        }


@dataclasses.dataclass
class IndexingOutput:
    map_paths: dict  # shard name -> saved IndexMap path
    sizes: dict  # shard name -> feature count (incl. intercept)
    n_records: int


def run_indexing(params: IndexingParams) -> IndexingOutput:
    """Scan the data once, build + save one frozen IndexMap per shard."""
    log = photon_logger("photon_tpu_torch.index", params.output_dir)
    timers = PhaseTimers()
    counts = None
    if params.use_native is not False:
        with timers("count"):
            native = _count_native(params.data_path, params.feature_shards)
        if native is None:
            native_fallback(params.data_path, params.use_native)
        else:
            counts, n_records = native
    if counts is None:
        with timers("read"):
            records = read_avro(params.data_path)
        n_records = len(records)
        with timers("count"):
            counts = {s: Counter() for s in params.feature_shards}
            for r in records:
                for shard, cfg in params.feature_shards.items():
                    c = counts[shard]
                    for bag in cfg.bags:
                        # same normalization as ingestion, so the prebuilt
                        # map's keys/order match an implicitly built one
                        for ntv in normalize_bag(r.get(bag)):
                            c[feature_key(ntv.name, ntv.term)] += 1

    os.makedirs(params.output_dir, exist_ok=True)
    map_paths, sizes = {}, {}
    with timers("build"):
        for shard, cfg in params.feature_shards.items():
            # first-seen order is what ingestion would produce; Counter
            # preserves insertion order, so ids line up with a map built
            # implicitly by read_game_data on the same data.
            keys = [k for k, n in counts[shard].items()
                    if n >= params.min_count]
            imap = IndexMap(has_intercept=cfg.has_intercept).build(keys)
            imap = imap.freeze()
            path = os.path.join(params.output_dir, f"{shard}.index.tsv")
            imap.save(path)
            map_paths[shard] = path
            sizes[shard] = imap.n_features
            log.info("shard %s: %d features (min_count=%d) -> %s",
                     shard, imap.n_features, params.min_count, path)
    log.info("timings: %s", timers.summary())
    return IndexingOutput(map_paths, sizes, n_records)


def _count_native(path, shards: dict) -> Optional[tuple[dict, int]]:
    """({shard: {key: count}} in first-seen order, records) through the
    native decoder in build mode, or None when it does not apply (no
    library, an unplannable schema). Each shard's store consumes its bags
    in config order, record by record — the order of the Python count —
    and every entry (duplicates included) is one COO entry, so a
    bincount of the column ids is the Counter's count."""
    from photon_tpu_torch import native
    from photon_tpu_torch.data.avro_io import avro_paths
    from photon_tpu_torch.data.native_ingest import build_decode_plan
    from photon_tpu_torch.data.streaming import _open_reader, _plan_readers

    if not native.available():
        return None
    paths = avro_paths(path)
    if not paths:
        return None
    # consume the bags only: every other field skips inside the decoder
    config = GameDataConfig(shards=shards, response_field="\x00unconsumed",
                            offset_field="\x00unconsumed",
                            weight_field="\x00unconsumed")
    readers = [_open_reader(p) for p in paths]
    plan0 = _plan_readers(readers, config)
    if plan0 is None:
        return None
    names = list(shards)
    stores = [native.NativeIndexStore(capacity_hint=1024) for _ in names]
    plan = build_decode_plan(plan0, config, names)
    tallies = [np.zeros(0, np.int64) for _ in names]
    n_records = 0
    for rd in readers:
        for count, payload in rd.blocks():
            dec = native.decode_block(payload, count, 0, plan, stores, True)
            if not dec.ok:
                raise ValueError(f"{rd.path}: malformed Avro block")
            for si in range(len(names)):
                cols = dec.coo(si)[1]
                if cols.size:
                    b = np.bincount(cols, minlength=len(stores[si]))
                    b[:tallies[si].size] += tallies[si]
                    tallies[si] = b
            dec.free()
            n_records += count
    counts = {}
    for si, s in enumerate(names):
        keys = stores[si].keys_in_order()
        t = np.zeros(len(keys), np.int64)
        t[:tallies[si].size] = tallies[si]
        counts[s] = dict(zip(keys, t.tolist()))
    return counts, n_records


def load_index_maps(map_paths: dict) -> dict:
    """{shard: path} → {shard: frozen IndexMap} for read_game_data."""
    return {s: IndexMap.load(p) for s, p in map_paths.items()}


def load_index_map_dir(dir_path: str, shard_names) -> dict:
    """Load a run_indexing output directory for the given shards
    (the TrainingParams.index_map_dir consumer). Missing shard files raise
    so a mis-pointed directory fails loudly rather than silently
    rebuilding maps."""
    maps = {}
    for shard in shard_names:
        path = os.path.join(dir_path, f"{shard}.index.tsv")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"index_map_dir {dir_path!r} has no map for shard "
                f"{shard!r} (expected {path}); run the indexing driver "
                "with the same feature_shards first")
        maps[shard] = IndexMap.load(path)
    return maps


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="photon-tpu feature indexing driver (PyTorch port)")
    p.add_argument("--config", required=True, help="JSON IndexingParams file")
    args = p.parse_args(argv)
    with open(args.config) as f:
        params = IndexingParams(**json.load(f))
    out = run_indexing(params)
    print(json.dumps({"map_paths": out.map_paths, "sizes": out.sizes,
                      "n_records": out.n_records}))


if __name__ == "__main__":
    main()
