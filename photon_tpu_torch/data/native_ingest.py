"""Native (C++) Avro → GameData ingestion fast path (the port's copy of
`photon_tpu/data/native_ingest.py`).

Reference parity: the JVM Avro decode inside
com.linkedin.photon.ml.data.avro.AvroDataReader, re-done as a columnar C++
block decoder (`photon_tpu_torch/native`, host code built by g++). The schema is compiled once into a flat
field PLAN; the C++ VM then turns each decompressed container block into
(y/offset/weight arrays, per-shard COO triples, entity-id string columns)
with zero per-record Python. Feature-key → column-id lookups run inside the
decoder against the native hash store (the PalDBIndexMap analog), in build
mode (assign on first sight) for training or frozen mode for scoring.

`read_game_data_native` mirrors `ingest.read_game_data` exactly — same
GameData, same IndexMaps, same first-seen id order — and returns None when
the schema has a shape the plan compiler doesn't cover (callers then fall
back to the pure-Python path).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from photon_tpu_torch import native
from photon_tpu_torch.data.avro_io import (AvroContainerReader, _schema_type,
                                           avro_paths)
from photon_tpu_torch.data.feature_bags import coo_to_matrix
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap
from photon_tpu_torch.data.ingest import GameDataConfig
from photon_tpu_torch.game.dataset import GameData

# ops understood by the C++ decoder (see photon_native.cc). Slots 2/5/6
# are RETIRED single-shape skips superseded by the generic skip (op 7);
# the numbers stay reserved so op ids are stable across versions.
_OP_DOUBLE, _OP_OPT_DOUBLE, _OP_RETIRED_2, _OP_ENTITY, _OP_BAG, \
    _OP_RETIRED_5, _OP_RETIRED_6, _OP_GENERIC_SKIP, _OP_SCALAR_GEN, \
    _OP_ENTITY_GEN, _OP_BAG_MAP, _OP_SCALAR_UNION, _OP_ENTITY_UNION = \
    range(13)

# skip-program bytecodes (photon_native.cc::skip_value)
_SK_NULL, _SK_BOOL, _SK_VARINT, _SK_FLOAT, _SK_DOUBLE, _SK_BYTES, \
    _SK_FIXED, _SK_UNION, _SK_RECORD, _SK_ARRAY, _SK_MAP = range(11)

_SK_PRIMITIVE = {"null": _SK_NULL, "boolean": _SK_BOOL, "int": _SK_VARINT,
                 "long": _SK_VARINT, "enum": _SK_VARINT, "float": _SK_FLOAT,
                 "double": _SK_DOUBLE, "bytes": _SK_BYTES,
                 "string": _SK_BYTES}

# numeric kinds for the generalized scalar op (aux byte 1)
_NUM_KIND = {"double": 0, "float": 1, "long": 2, "int": 2}


class _SkipTable:
    """Accumulates skip programs, one program id per DISTINCT value shape
    (memoized, so a record of 20 longs shares one varint program)."""

    # mirror of photon_native.cc skip_value's recursion guard: deeper
    # schemas must refuse at PLAN time so the reader falls back to Python
    # instead of hard-failing mid-decode on valid data
    MAX_DEPTH = 64

    def __init__(self):
        self.progs: list = []
        self._memo: dict = {}

    def add(self, schema, depth: int = 0) -> Optional[int]:
        """Compile `schema` to a skip program id; None if unskippable."""
        if depth > self.MAX_DEPTH:
            return None
        ts = _schema_type(schema)
        if ts in _SK_PRIMITIVE:
            prog = [_SK_PRIMITIVE[ts]]
        elif ts == "fixed":
            prog = [_SK_FIXED, int(schema["size"])]
        elif ts == "union":
            branches = schema if isinstance(schema, list) else schema["type"]
            pids = [self.add(b, depth + 1) for b in branches]
            if any(p is None for p in pids):
                return None
            prog = [_SK_UNION, len(pids)] + pids
        elif ts == "record":
            pids = [self.add(f["type"], depth + 1)
                    for f in schema["fields"]]
            if any(p is None for p in pids):
                return None
            prog = [_SK_RECORD, len(pids)] + pids
        elif ts == "array":
            pid = self.add(schema["items"], depth + 1)
            if pid is None:
                return None
            prog = [_SK_ARRAY, pid]
        elif ts == "map":
            pid = self.add(schema["values"], depth + 1)
            if pid is None:
                return None
            prog = [_SK_MAP, pid]
        else:
            return None
        key = tuple(prog)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        # photon: unguarded(each decode task compiles its own per-schema _SkipTable instance — tables are built and consumed inside one task, never shared across threads)
        self.progs.append(prog)
        # photon: unguarded(each decode task compiles its own per-schema _SkipTable instance — tables are built and consumed inside one task, never shared across threads)
        self._memo[key] = len(self.progs) - 1
        return self._memo[key]

    def tables(self) -> tuple[list, list]:
        """(flat program array, per-program start offsets)."""
        flat, off = [], []
        for p in self.progs:
            off.append(len(flat))
            flat.extend(p)
        return flat or [0], off or [0]


def _is_opt(schema, inner: str) -> bool:
    """union [null, inner] with null as branch 0 (what the decoder assumes)."""
    return (isinstance(schema, list) and len(schema) == 2
            and _schema_type(schema[0]) == "null"
            and _schema_type(schema[1]) == inner)


def _two_branch_mode(schema, kinds) -> Optional[tuple]:
    """(mode, inner_type_name) for plain-or-2-branch-nullable shapes:
    mode 0 = plain, 1 = [null, X], 2 = [X, null]; X's type name must be in
    `kinds`. None when the shape doesn't match."""
    ts = _schema_type(schema)
    if ts in kinds:
        return 0, ts
    if isinstance(schema, list) and len(schema) == 2:
        t0, t1 = _schema_type(schema[0]), _schema_type(schema[1])
        if t0 == "null" and t1 in kinds:
            return 1, t1
        if t1 == "null" and t0 in kinds:
            return 2, t0
    return None


# bag value wire kinds (aux array `vkinds`): 0=double, 1=float, 2=varint
# (long/int — zigzag on the wire either way)
_BAG_VALUE_KIND = {"double": 0, "float": 1, "long": 2, "int": 2}


def _ntv_value_kind(items) -> Optional[int]:
    """Bag value kind when items is a NameTermValue-shaped record."""
    if _schema_type(items) != "record":
        return None
    fields = items.get("fields", [])
    if len(fields) != 3:
        return None
    names = [f["name"] for f in fields]
    types = [_schema_type(f["type"]) for f in fields]
    if names != ["name", "term", "value"] or types[:2] != ["string", "string"]:
        return None
    return _BAG_VALUE_KIND.get(types[2])


def _bag_mode(schema) -> Optional[tuple]:
    """(mode, bag_schema_dict) for plain or 2-branch-nullable bag fields:
    mode 0 = plain array/map, 1 = [null, bag], 2 = [bag, null]."""
    ts = _schema_type(schema)
    if ts in ("array", "map"):
        return 0, schema
    if isinstance(schema, list) and len(schema) == 2:
        t0, t1 = _schema_type(schema[0]), _schema_type(schema[1])
        if t0 == "null" and t1 in ("array", "map"):
            return 1, schema[1]
        if t1 == "null" and t0 in ("array", "map"):
            return 2, schema[0]
    return None


# Union branch types the ENTITY path may natively skip: values of these
# shapes fold to absent on the Python path too (ingest.entity_id_or_none).
# Numeric/enum/bool branches are excluded — Python STRINGIFIES numbers and
# decodes enums to str, so consuming the string branch natively while such
# a branch is populated would diverge; those schemas stay on Python.
_ENTITY_SKIPPABLE = frozenset(
    {"array", "map", "record", "bytes", "fixed"})


def _union_branch_table(schema, consumed_types, skips: "_SkipTable",
                        skippable_types=None) -> Optional[tuple]:
    """(codes, consumed_type_name) for an arbitrary union consuming ONE
    branch: exactly one branch's type is in `consumed_types`; nulls map to
    -1 (unset), the consumed branch to -2, every other branch to its
    generic skip-program id. A POPULATED non-consumed branch reads as
    ABSENT (the default applies) — the same semantic the pure-Python
    path's records_to_game_data applies to non-numeric/non-string values,
    so native and Python stay bit-identical (pinned by tests/
    test_native.py and tests/test_torch_native.py with populated odd
    branches). None when zero or
    several branches qualify."""
    if not isinstance(schema, list):
        return None
    branch_types = [_schema_type(b) for b in schema]
    if sum(ts in consumed_types for ts in branch_types) != 1:
        return None  # ambiguous (e.g. [null, double, float]): Python path
    codes, hit = [], None
    for b, ts in zip(schema, branch_types):
        if ts == "null":
            codes.append(-1)
        elif ts in consumed_types:
            hit = ts
            codes.append(-2)
        else:
            if skippable_types is not None and ts not in skippable_types:
                return None  # populated values would diverge from Python
            pid = skips.add(b)
            if pid is None:
                return None
            codes.append(pid)
    return codes, hit


def compile_plan(schema, config: GameDataConfig):
    """Schema → (ops, aux, vkinds, bag names, sk_prog, sk_off, bt_flat,
    bt_off) or None.

    CONSUMED fields must match a supported shape: scalars are
    double/float/int/long — plain, 2-branch nullable (either order), or
    behind a WIDER union whose single numeric branch is consumed and
    whose other branches compile to skip programs (decoded-but-unset);
    entity columns are string with the same plain/nullable/wide-union
    shapes; configured feature bags are array<NameTermValue> or
    map<string, double|float|long|int>, plain or 2-branch nullable.
    Every UNCONSUMED field of any Avro shape — nested records, wide
    unions, enums, fixed, maps, arrays — compiles to a generic skip
    program and stays on the native road (the round-3 builder rejected
    the whole schema over one odd extra field, a ~10-20x ingest cliff;
    round 5 removed the same cliff for exotic CONSUMED shapes)."""
    if _schema_type(schema) != "record":
        return None
    scalar_slots = {config.response_field: 0, config.offset_field: 1,
                    config.weight_field: 2}
    entity_idx = {e: i for i, e in enumerate(config.entity_fields)}
    required = {b for cfg in config.shards.values() for b in cfg.bags}
    skips = _SkipTable()
    branch_tables: list = []
    ops, aux, vkinds, bag_names = [], [], [], []
    for f in schema["fields"]:
        name, t = f["name"], f["type"]
        ts = _schema_type(t)
        if name in scalar_slots:
            if ts == "double":  # classic shapes keep the classic ops
                ops.append(_OP_DOUBLE)
                aux.append(scalar_slots[name])
            elif _is_opt(t, "double"):
                ops.append(_OP_OPT_DOUBLE)
                aux.append(scalar_slots[name])
            elif (m := _two_branch_mode(t, _NUM_KIND)) is not None:
                mode, inner = m
                ops.append(_OP_SCALAR_GEN)
                aux.append(scalar_slots[name] | (_NUM_KIND[inner] << 8)
                           | (mode << 16))
            else:
                bt = _union_branch_table(t, _NUM_KIND, skips)
                if bt is None:
                    return None
                codes, inner = bt
                branch_tables.append(codes)
                ops.append(_OP_SCALAR_UNION)
                aux.append(scalar_slots[name] | (_NUM_KIND[inner] << 8)
                           | ((len(branch_tables) - 1) << 16))
        elif name in entity_idx:
            if _is_opt(t, "string"):
                ops.append(_OP_ENTITY)
                aux.append(entity_idx[name])
            elif (m := _two_branch_mode(t, ("string",))) is not None:
                mode, _ = m
                ops.append(_OP_ENTITY_GEN)
                aux.append(entity_idx[name] | (mode << 16))
            else:
                bt = _union_branch_table(t, ("string",), skips,
                                         skippable_types=_ENTITY_SKIPPABLE)
                if bt is None:
                    return None
                branch_tables.append(bt[0])
                ops.append(_OP_ENTITY_UNION)
                aux.append(entity_idx[name]
                           | ((len(branch_tables) - 1) << 16))
        elif name in required:
            bm = _bag_mode(t)
            if bm is None:
                return None
            mode, bag_t = bm
            if _schema_type(bag_t) == "array":
                vk = _ntv_value_kind(
                    bag_t["items"] if isinstance(bag_t, dict) else None)
                if vk is None:
                    return None
                ops.append(_OP_BAG)
            else:
                vk = _BAG_VALUE_KIND.get(_schema_type(bag_t["values"]))
                if vk is None:
                    return None
                ops.append(_OP_BAG_MAP)
            aux.append(len(bag_names) | (mode << 16))
            vkinds.append(vk)
            bag_names.append(name)
        else:
            # every unconsumed field skips natively, whatever its shape
            pid = skips.add(t)
            if pid is None:
                return None
            ops.append(_OP_GENERIC_SKIP)
            aux.append(pid)
    if not required.issubset(bag_names):
        return None  # a configured bag is missing from the schema
    sk_prog, sk_off = skips.tables()
    bt_flat, bt_off = [], []
    for codes in branch_tables:
        bt_off.append(len(bt_flat))
        bt_flat.append(len(codes))
        bt_flat.extend(codes)
    return (ops, aux, vkinds, bag_names, sk_prog, sk_off,
            bt_flat or [0], bt_off or [0])


def build_decode_plan(plan0, config: GameDataConfig, shard_names) -> tuple:
    """The decode_block plan tuple from a compiled schema plan — store s
    consumes its shard's bags IN CONFIG ORDER (id-assignment parity with
    build_index_map's `for bag in config.bags` loop). Shared by the
    one-shot reader and data.streaming."""
    ops, aux, vkinds, bag_names, sk_prog, sk_off, bt_flat, bt_off = plan0
    sb_off, sb_idx = [0], []
    for s in shard_names:
        sb_idx.extend(bag_names.index(b) for b in config.shards[s].bags)
        sb_off.append(len(sb_idx))
    return (np.asarray(ops, np.int32), np.asarray(aux, np.int32),
            np.asarray(vkinds or [0], np.int32),
            np.asarray(sb_off, np.int32),
            np.asarray(sb_idx or [0], np.int32), len(config.entity_fields),
            np.asarray(sk_prog, np.int32), np.asarray(sk_off, np.int32),
            np.asarray(bt_flat, np.int32), np.asarray(bt_off, np.int32))


def frozen_stores(index_maps: dict, shard_names) -> list:
    """One native store per shard, preloaded from its FROZEN index map
    (intercept excluded — it is appended as a COO column, not looked up)."""
    stores = []
    for s in shard_names:
        imap = index_maps[s]
        keys = imap.keys_in_order()
        if imap.has_intercept:
            keys = keys[:-1]
        stores.append(native.NativeIndexStore.from_keys(keys))
    return stores


def read_game_data_native(
    path,
    config: GameDataConfig,
    index_maps: Optional[dict] = None,
    sparse_k: Optional[int] = None,
):
    """Native-decoder twin of ingest.read_game_data; None when inapplicable."""
    if not native.available():
        return None
    paths = avro_paths(path)
    if not paths:
        return None
    readers = [AvroContainerReader(p) for p in paths]
    plan0 = compile_plan(readers[0].schema, config)
    if plan0 is None:
        return None
    shard_names = list(config.shards)
    index_maps = dict(index_maps or {})
    build_flags = [index_maps.get(s) is None for s in shard_names]
    if len(set(build_flags)) > 1:
        return None  # mixed build/frozen per call is not supported natively
    build_mode = build_flags[0] if build_flags else True
    if build_mode:
        stores = [native.NativeIndexStore(capacity_hint=1024)
                  for _ in shard_names]
    else:
        stores = frozen_stores(index_maps, shard_names)
    plan = build_decode_plan(plan0, config, shard_names)

    ys, offs, wts = [], [], []
    coos = [[] for _ in shard_names]
    ents = [[] for _ in config.entity_fields]
    row0 = 0
    for rd in readers:
        if compile_plan(rd.schema, config) != plan0:
            return None  # schema drift across files: fall back
        for count, payload in rd.blocks():
            dec = native.decode_block(payload, count, row0, plan, stores,
                                      build_mode)
            if not dec.ok:
                raise ValueError(f"{rd.path}: malformed Avro block")
            y, y_set = dec.scalars(0)
            if not y_set.all():
                raise ValueError(f"{rd.path}: record missing response")
            off, off_set = dec.scalars(1)
            wt, wt_set = dec.scalars(2)
            ys.append(y)
            offs.append(np.where(off_set, off, 0.0))
            wts.append(np.where(wt_set, wt, 1.0))
            for si in range(len(shard_names)):
                coos[si].append(dec.coo(si))
            for e in range(len(config.entity_fields)):
                ents[e].append(dec.entity_column(e))
            dec.free()
            row0 += count

    n = row0
    y = np.concatenate(ys).astype(np.float32) if ys else np.zeros(0, np.float32)
    offsets = (np.concatenate(offs).astype(np.float32)
               if offs else np.zeros(0, np.float32))
    weights = (np.concatenate(wts).astype(np.float32)
               if wts else np.ones(0, np.float32))

    shards = {}
    for si, s in enumerate(shard_names):
        cfg = config.shards[s]
        imap = index_maps.get(s)
        if imap is None:
            key_to_id = {k: i for i, k in enumerate(stores[si].keys_in_order())}
            imap = IndexMap(key_to_id, frozen=True,
                            has_intercept=cfg.has_intercept)
            if cfg.has_intercept:
                imap.index_of(INTERCEPT_KEY)  # no-op id; records metadata
            index_maps[s] = imap
        rows = np.concatenate([c[0] for c in coos[si]]) if coos[si] else \
            np.zeros(0, np.int64)
        cols = np.concatenate([c[1] for c in coos[si]]).astype(np.int64) \
            if coos[si] else np.zeros(0, np.int64)
        vals = np.concatenate([c[2] for c in coos[si]]) if coos[si] else \
            np.zeros(0, np.float32)
        if cfg.has_intercept:
            rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
            cols = np.concatenate(
                [cols, np.full(n, imap.intercept_id, np.int64)])
            vals = np.concatenate([vals, np.ones(n, np.float32)])
        shards[s] = coo_to_matrix(rows, cols, vals, n, imap.n_features,
                                  cfg.dense_threshold, k=sparse_k)

    ids = {}
    optional = set(config.optional_entity_fields)
    for e_i, e in enumerate(config.entity_fields):
        col, null = entity_ids_of(ents[e_i])
        if null.any() and e not in optional:  # like the Python path's
            raise ValueError(f"records missing entity id {e!r}")
        ids[e] = col
    return GameData(y, weights, offsets, shards, ids), index_maps


def entity_ids_of(parts) -> tuple[np.ndarray, np.ndarray]:
    """One entity column from its blocks' `DecodedBlock.entity_column`
    pieces: (str array, null mask), "" at the nulls, as the Python path's
    ``np.asarray([str(v) ...])`` types it (width = the longest id)."""
    if not parts:
        return np.asarray([]), np.zeros(0, bool)
    col = np.concatenate([c for c, _ in parts])
    null = np.concatenate([m for _, m in parts])
    width = max(int(np.char.str_len(col).max()) if col.size else 1, 1)
    if col.dtype.itemsize != 4 * width:
        col = col.astype(f"U{width}")
    return col, null
