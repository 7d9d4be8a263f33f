"""Avro training records → GameData (host arrays) — the port's copy of
`photon_tpu/data/ingest.py`.

Reference parity: com.linkedin.photon.ml.data.avro.AvroDataReader — reads
TrainingExampleAvro-shaped records (response/offset/weight + feature-bag
arrays of NameTermValue + entity-id columns) and materializes one design
matrix per configured feature shard. The reference produces per-partition
RDDs; here the output is host numpy arrays (and numpy-backed
`SparseRows`), moved to the device once by `GameData.to_device`.
`read_game_data` decodes through the C++ block decoder
(`data.native_ingest`) unless asked not to, with this module's
pure-Python assembly as its fallback.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np

from photon_tpu_torch.data.avro_io import read_avro
from photon_tpu_torch.data.feature_bags import (FeatureShardConfig,
                                                NameTermValue, coo_to_matrix)
from photon_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap
from photon_tpu_torch.game.dataset import GameData

# The TrainingExampleAvro shape (reference:
# photon-ml avro schemas TrainingExampleAvro.avsc), trimmed to the fields the
# trainer consumes. Used by tests/drivers to write fixtures.
NAME_TERM_VALUE_SCHEMA = {
    "type": "record",
    "name": "NameTermValueAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}


def numeric_or_none(v):
    """The wide-union scalar semantic, shared by both decoders (pinned in
    tests/test_native.py): a value from a non-numeric union branch — a
    string, a container, a boolean — reads as ABSENT (the field default
    applies), exactly like the null branch. The native decoder's branch
    tables skip such branches; this is the Python twin."""
    return v if isinstance(v, (int, float)) and not isinstance(v, bool) \
        else None


def entity_id_or_none(v):
    """The entity-id semantic shared by both decoders: strings pass,
    NUMBERS stringify (plain int/long id columns are long-standing Python
    -path behavior — the native planner refuses to consume such shapes so
    the Python path always owns them), and container/bool values — only
    reachable through a wide union's non-string branch — read as ABSENT
    like the null branch (the native planner likewise only consumes
    entity unions whose other branches are containers)."""
    if isinstance(v, str):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return str(v)
    return None


def training_example_schema(
    feature_bags: Sequence[str] = ("features",),
    entity_fields: Sequence[str] = (),
) -> dict:
    """Schema for GAME training records with the given bag/id columns."""
    fields = [
        {"name": "response", "type": "double"},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "uid", "type": ["null", "string"], "default": None},
    ]
    for e in entity_fields:
        fields.append({"name": e, "type": ["null", "string"], "default": None})
    for i, bag in enumerate(feature_bags):
        fields.append({
            "name": bag,
            "type": {"type": "array",
                     "items": NAME_TERM_VALUE_SCHEMA if i == 0
                     else "NameTermValueAvro"},
        })
    return {"type": "record", "name": "TrainingExampleAvro", "fields": fields}


@dataclasses.dataclass(frozen=True)
class GameDataConfig:
    """What to extract from records (reference: GameTrainingDriver's
    input-data-format + feature-shard configurations).

    `optional_entity_fields`: entity columns where a null is legal and
    becomes "" instead of an error — the scoring driver reads the uid
    column this way (reference: ScoredItemAvro.uid is nullable).
    `allow_missing_response`: missing/null responses become 0.0 instead of
    an error (scoring data may be unlabeled); the chunk stream records
    whether any were missing so callers can gate evaluators.
    """

    shards: dict  # shard name -> FeatureShardConfig
    entity_fields: Sequence[str] = ()
    response_field: str = "response"
    offset_field: str = "offset"
    weight_field: str = "weight"
    optional_entity_fields: Sequence[str] = ()
    allow_missing_response: bool = False


def _entry_fields(e) -> tuple:
    """(name, term, value) of one raw bag entry (dict or NameTermValue) —
    THE canonical interpretation of a feature entry. Everything that
    derives feature keys (normalize_bag, the bulk flattening in
    records_to_game_data, the indexing driver's counters) goes through
    here so prebuilt and implicit index maps can never diverge."""
    if isinstance(e, NameTermValue):
        return e.name, e.term, e.value
    return e["name"], e.get("term", ""), float(e["value"])


def iter_bag_entries(bag):
    """(name, term, value) triples of one raw bag value — the canonical
    iteration for BOTH bag shapes: a list of NameTermValue/dict entries
    (array<NameTermValue>) or a str→number mapping (map-typed bags, where
    the map key is the feature name and the term is empty — reference:
    AvroDataReader's makeFeatures handles both field shapes)."""
    if not bag:
        return
    if isinstance(bag, dict):
        for k, v in bag.items():
            yield k, "", float(v)
    else:
        for e in bag:
            yield _entry_fields(e)


def normalize_bag(bag_entries) -> list:
    """Raw Avro bag entries → NameTermValue list (see iter_bag_entries)."""
    return [NameTermValue(*t) for t in iter_bag_entries(bag_entries)]


_to_ntv = normalize_bag  # internal alias (pre-existing call sites)


def records_to_game_data(
    records: Sequence[dict],
    config: GameDataConfig,
    index_maps: Optional[dict] = None,
    sparse_k: Optional[int] = None,
) -> tuple[GameData, dict]:
    """Decoded Avro records → (GameData, per-shard IndexMaps).

    index_maps: shard name -> frozen IndexMap to reuse (scoring path);
    missing maps are built from the records (training path).

    Assembly is BULK, not per-record: one flattening pass per bag into
    flat (row, key, value) columns, then id lookup + COO build in numpy —
    the per-record interpreter loop this replaced ran ~2.5× slower and was
    the fallback path's bottleneck after record decode. Semantics are
    identical (same first-seen id order, NULL_ID features dropped,
    duplicates summed, intercept appended last).
    """
    n = len(records)
    _num = numeric_or_none
    f = config.response_field
    if config.allow_missing_response:
        y = np.fromiter(
            (0.0 if (v := _num(r.get(f))) is None else v for r in records),
            np.float32, count=n)
    else:
        y = np.fromiter((r[f] for r in records), np.float32, count=n)
    f = config.offset_field
    offsets = np.fromiter(
        (0.0 if (v := _num(r.get(f))) is None else v for r in records),
        np.float32, count=n)
    f = config.weight_field
    weights = np.fromiter(
        (1.0 if (v := _num(r.get(f))) is None else v for r in records),
        np.float32, count=n)
    ids: dict = {}
    optional = set(config.optional_entity_fields)
    for e in config.entity_fields:
        col = [entity_id_or_none(r.get(e)) for r in records]
        if any(v is None for v in col):
            if e not in optional:
                i = col.index(None)
                raise ValueError(f"record {i} missing entity id {e!r}")
            col = ["" if v is None else v for v in col]
        ids[e] = np.asarray([str(v) for v in col])

    # One flattening pass per bag: per-record entry counts + flat
    # feature-key/value columns (record-major, so first-seen order is
    # preserved for id assignment below).
    bag_names = sorted({b for cfg in config.shards.values() for b in cfg.bags})
    counts: dict = {}
    keys: dict = {}
    vals: dict = {}
    for b in bag_names:
        cnt: list = []
        ks: list = []
        vs: list = []
        for rec in records:
            es = rec.get(b) or ()
            cnt.append(len(es))
            if isinstance(es, dict):
                entries = iter_bag_entries(es)
            else:  # decoded records: dicts, read inline (`_entry_fields`)
                entries = ((e["name"], e.get("term", ""), float(e["value"]))
                           if type(e) is dict else _entry_fields(e)
                           for e in es)
            for name, term, value in entries:
                ks.append(f"{name}{DELIMITER}{term}" if term else name)
                vs.append(value)
        counts[b] = np.asarray(cnt, np.int64).reshape(n)
        keys[b] = ks
        vals[b] = np.asarray(vs, np.float32)

    index_maps = dict(index_maps or {})
    shards = {}
    for shard_name, shard_cfg in config.shards.items():
        imap = index_maps.get(shard_name)
        if imap is None:
            imap = IndexMap()
            if len(shard_cfg.bags) == 1:
                # single bag: the flat column IS record-major order
                imap.build(keys[shard_cfg.bags[0]])
            else:
                # multi-bag shards interleave bags per record (the
                # build_index_map assignment order)
                bounds = {b: np.concatenate([[0], np.cumsum(counts[b])])
                          for b in shard_cfg.bags}
                for i in range(n):
                    for b in shard_cfg.bags:
                        for k in keys[b][bounds[b][i]:bounds[b][i + 1]]:
                            imap.index_of(k)
            if shard_cfg.has_intercept:
                imap.index_of(INTERCEPT_KEY)
            index_maps[shard_name] = imap.freeze()
        get = imap.get
        rows_parts, cols_parts, vals_parts = [], [], []
        for b in shard_cfg.bags:
            m = len(keys[b])
            rows_parts.append(np.repeat(np.arange(n, dtype=np.int64),
                                        counts[b]))
            cols_parts.append(np.fromiter(map(get, keys[b]), np.int64,
                                          count=m))
            vals_parts.append(vals[b])
        rows = np.concatenate(rows_parts) if rows_parts else \
            np.zeros(0, np.int64)
        cols = np.concatenate(cols_parts) if cols_parts else \
            np.zeros(0, np.int64)
        vv = np.concatenate(vals_parts) if vals_parts else \
            np.zeros(0, np.float32)
        keep = cols != IndexMap.NULL_ID  # unindexed features are dropped
        rows, cols, vv = rows[keep], cols[keep], vv[keep]
        if shard_cfg.has_intercept:
            rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
            cols = np.concatenate(
                [cols, np.full(n, imap.intercept_id, np.int64)])
            vv = np.concatenate([vv, np.ones(n, np.float32)])
        shards[shard_name] = coo_to_matrix(rows, cols, vv, n,
                                           imap.n_features,
                                           shard_cfg.dense_threshold,
                                           k=sparse_k)

    return GameData(y, weights, offsets, shards, ids), index_maps


def native_fallback(what, force: Optional[bool]) -> None:
    """The one decision point for a native read that did not apply.

    ``force=True`` (``use_native=True``) raises: with the library's build
    error (the compiler's stderr) when it is unavailable, else naming the
    unplannable schema. ``force=None`` falls back to the pure-Python
    decoder LOUDLY: a warning naming the reason, and the counters
    ``ingest.python_fallback`` (every fallback) and
    ``ingest.native_unavailable`` (the library could not be built or
    loaded)."""
    from photon_tpu_torch import native, telemetry

    missing = not native.available()
    if force:
        if missing:
            native.require_lib()  # raises with the build error
        raise RuntimeError(
            f"native ingestion requested for {what} but the schema is not "
            "native-plannable (see native_ingest.compile_plan), the files' "
            "schemas differ, or per-shard maps mix build/frozen modes")
    telemetry.count("ingest.python_fallback")
    if missing:
        telemetry.count("ingest.native_unavailable")
        reason = f"the C++ library is unavailable ({native.build_error()})"
    else:
        reason = ("the schema shape is not native-plannable (see "
                  "native_ingest.compile_plan), the files' schemas differ, "
                  "or per-shard maps mix build/frozen modes")
    logging.getLogger("photon_tpu_torch.ingest").warning(
        "native ingestion unavailable for %s: %s — falling back to the "
        "pure-Python reader", what, reason)


def read_game_data(
    path,
    config: GameDataConfig,
    index_maps: Optional[dict] = None,
    sparse_k: Optional[int] = None,
    use_native: Optional[bool] = None,
) -> tuple[GameData, dict]:
    """Avro file/dir → GameData (reference: AvroDataReader.readMerged).

    use_native: True forces the C++ block decoder (an error if the
    library does not build or the schema is not plannable), False forces
    pure Python, None (default) tries native and falls back — logged and
    counted (`native_fallback`) — when the toolchain or the schema shape
    isn't supported. Both decoders give the same GameData and maps.
    """
    if use_native is not False:
        from photon_tpu_torch.data.native_ingest import read_game_data_native

        out = read_game_data_native(path, config, index_maps, sparse_k)
        if out is not None:
            return out
        native_fallback(path, use_native)
    return records_to_game_data(read_avro(path), config, index_maps, sparse_k)
