"""Avro object-container-file reader/writer, pure Python (the port's copy
of `photon_tpu/data/avro_io.py`; files written by either package read in
the other to equal records).

Reference parity: com.linkedin.photon.ml.io.avro (AvroUtils,
AvroDataReader) — the reference reads TrainingExampleAvro/GameDatum records
from HDFS Avro container files. The container format is implemented
directly (no Avro dependency in this image): header magic ``Obj\\x01``, file
metadata (schema JSON + codec), 16-byte sync marker, then blocks of
(record count, byte size, payload, sync). Codecs: ``null``, ``deflate``
(raw zlib) and ``snappy`` (raw block + 4-byte big-endian CRC32 of the
uncompressed bytes, per the Avro spec) — the three the reference's Hadoop
jobs produce; snappy blocks decompress through the C++ runtime
(`native/`) when it is available, `data.snappy` (pure Python) otherwise.
The native block decoder (`data.native_ingest`) reads the payloads this
module's readers return.

Decoding yields plain Python dicts keyed by field name — the
``feature_bags`` builder consumes these directly.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Iterable, Iterator, Optional

import numpy as np

from photon_tpu_torch.data import snappy as _snappy

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

# --------------------------------------------------------------------------
# binary primitives
# --------------------------------------------------------------------------


def _read_long(buf: io.BufferedIOBase) -> int:
    """Zigzag varint (Avro int/long share the encoding)."""
    shift = 0
    result = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (result >> 1) ^ -(result & 1)


def _write_long(out: io.BufferedIOBase, n: int) -> None:
    n = (n << 1) ^ (n >> 63)
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((byte | 0x80,)))
        else:
            out.write(bytes((byte,)))
            break


def _read_bytes(buf) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


def _write_bytes(out, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# --------------------------------------------------------------------------
# schema-driven decode/encode
# --------------------------------------------------------------------------

PRIMITIVES = {"null", "boolean", "int", "long", "float", "double",
              "bytes", "string"}


def parse_schema(schema) -> dict | list | str:
    """Normalize a schema (JSON string or already-parsed) and register named
    types so recursive references resolve. The input is deep-copied — the
    caller's schema dict is never mutated (named-type references are expanded
    into shared sub-dicts only inside the parsed copy)."""
    import copy

    if isinstance(schema, str) and schema not in PRIMITIVES:
        schema = json.loads(schema)
    else:
        schema = copy.deepcopy(schema)
    named: dict = {}

    def walk(s):
        if isinstance(s, str):
            return named.get(s, s)
        if isinstance(s, list):
            return [walk(x) for x in s]
        t = s.get("type")
        if t in ("record", "error"):
            full = s.get("namespace", "")
            name = f"{full}.{s['name']}" if full else s["name"]
            named[name] = s
            named[s["name"]] = s
            s["fields"] = [dict(f, type=walk(f["type"])) for f in s["fields"]]
            return s
        if t in ("enum", "fixed"):
            named[s["name"]] = s
            return s
        if t == "array":
            return dict(s, items=walk(s["items"]))
        if t == "map":
            return dict(s, values=walk(s["values"]))
        if isinstance(t, (dict, list)):
            return dict(s, type=walk(t))
        return s

    return walk(schema)


def _schema_type(schema):
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    t = schema["type"]
    return t if isinstance(t, str) else _schema_type(t)


def read_datum(buf, schema):
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    if t == "union":
        branches = schema if isinstance(schema, list) else schema["type"]
        return read_datum(buf, branches[_read_long(buf)])
    if t == "record":
        return {f["name"]: read_datum(buf, f["type"]) for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)  # block byte size, unused
                n = -n
            for _ in range(n):
                out.append(read_datum(buf, schema["items"]))
        return out
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)
                n = -n
            for _ in range(n):
                k = _read_bytes(buf).decode("utf-8")
                out[k] = read_datum(buf, schema["values"])
        return out
    raise ValueError(f"unsupported schema type: {t}")


# --------------------------------------------------------------------------
# compiled decode: the container readers' record decoder
# --------------------------------------------------------------------------
# `read_datum` walks the schema for every value. The readers below turn a
# schema into the source of one Python function that decodes a whole
# block payload with every primitive inlined (no call per field), which
# gives the same values several times faster.

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


def _varint_tail(b: bytes, p: int, first: int) -> tuple:
    """The rest of a varint whose first byte ``first`` (≥ 0x80) was read:
    (raw unsigned value, next position)."""
    result = first & 0x7F
    shift = 7
    while True:
        byte = b[p]
        p += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result, p
        shift += 7


class _Gen:
    """Source lines of a block decoder for one parsed schema."""

    def __init__(self):
        self.lines: list = []
        self.n = 0
        self.consts: dict = {}
        self.recursive: dict = {}  # id(record schema) -> its reader

    def var(self) -> str:
        self.n += 1
        return f"v{self.n}"

    def const(self, value) -> str:
        name = f"c{len(self.consts)}"
        self.consts[name] = value
        return name

    def emit(self, ind: int, line: str) -> None:
        self.lines.append("    " * ind + line)

    def long(self, v: str, ind: int) -> None:
        self.emit(ind, f"{v} = b[p]; p += 1")
        self.emit(ind, f"if {v} >= 128: {v}, p = _tail(b, p, {v})")
        self.emit(ind, f"{v} = ({v} >> 1) ^ -({v} & 1)")

    def raw(self, v: str, ind: int) -> None:
        """bytes value into ``v`` (length varint, then that many bytes)."""
        n = self.var()
        self.long(n, ind)
        self.emit(ind, f"{v} = b[p:p + {n}]; p += {n}")
        self.emit(ind, f"if p > L or {n} < 0: raise IndexError")

    def value(self, schema, v: str, ind: int, stack: tuple) -> None:
        t = _schema_type(schema)
        if t == "null":
            self.emit(ind, f"{v} = None")
        elif t == "boolean":
            self.emit(ind, f"{v} = b[p] == 1; p += 1")
        elif t in ("int", "long"):
            self.long(v, ind)
        elif t in ("float", "double"):
            fmt, w = ("_f32", 4) if t == "float" else ("_f64", 8)
            self.emit(ind, f"{v} = {fmt}(b, p)[0]; p += {w}")
        elif t == "bytes":
            self.raw(v, ind)
        elif t == "string":
            self.raw(v, ind)
            self.emit(ind, f"{v} = {v}.decode('utf-8')")
        elif t == "union":
            branches = schema if isinstance(schema, list) else schema["type"]
            i = self.var()
            self.long(i, ind)
            for k, br in enumerate(branches):
                self.emit(ind, f"{'if' if k == 0 else 'elif'} {i} == {k}:")
                self.value(br, v, ind + 1, stack)
            self.emit(ind, "else: raise IndexError")
        elif t == "record":
            if id(schema) in stack:  # a recursive named type
                rd = self.recursive.get(id(schema))
                if rd is None:
                    rd = self.recursive[id(schema)] = \
                        _recursive_reader(schema)
                self.emit(ind, f"{v}, p = {self.const(rd)}(b, p)")
                return
            names = []
            for f in schema["fields"]:
                fv = self.var()
                self.value(f["type"], fv, ind, stack + (id(schema),))
                names.append((f["name"], fv))
            items = ", ".join(f"{n!r}: {fv}" for n, fv in names)
            self.emit(ind, f"{v} = {{{items}}}")
        elif t == "enum":
            syms = self.const(list(schema["symbols"]))
            i = self.var()
            self.long(i, ind)
            self.emit(ind, f"{v} = {syms}[{i}]")
        elif t == "fixed":
            size = int(schema["size"])
            self.emit(ind, f"{v} = b[p:p + {size}]; p += {size}")
            self.emit(ind, "if p > L: raise IndexError")
        elif t in ("array", "map"):
            keyed = t == "map"
            n, item = self.var(), self.var()
            self.emit(ind, f"{v} = {{}}" if keyed else f"{v} = []")
            self.emit(ind, "while True:")
            self.long(n, ind + 1)
            self.emit(ind + 1, f"if {n} == 0: break")
            self.emit(ind + 1, f"if {n} < 0:")
            skip = self.var()
            self.long(skip, ind + 2)  # block byte size, unused
            self.emit(ind + 2, f"{n} = -{n}")
            self.emit(ind + 1, f"for _ in range({n}):")
            if keyed:
                key = self.var()
                self.raw(key, ind + 2)
                self.value(schema["values"], item, ind + 2, stack)
                self.emit(ind + 2, f"{v}[{key}.decode('utf-8')] = {item}")
            else:
                self.value(schema["items"], item, ind + 2, stack)
                self.emit(ind + 2, f"{v}.append({item})")
        else:
            raise ValueError(f"unsupported schema type: {t}")


def _compile(schema, body) -> object:
    g = _Gen()
    head, tail = body(g)
    src = "\n".join(head + g.lines + tail)
    env = {"_tail": _varint_tail, "_f32": _F32.unpack_from,
           "_f64": _F64.unpack_from, **g.consts}
    exec(compile(src, f"<avro decoder {id(schema):x}>", "exec"), env)
    return env["decode"]


def _recursive_reader(schema):
    """``(payload, pos) -> (value, pos)`` for a record that contains
    itself: compiled on its first call, its nested occurrences calling it
    back."""
    fn = None

    def call(b, p):
        nonlocal fn
        if fn is None:
            def body(g):
                g.recursive[id(schema)] = call
                g.value(schema, "out", 1, ())
                return (["def decode(b, p):", "    L = len(b)"],
                        ["    return out, p"])
            fn = _compile(schema, body)
        return fn(b, p)
    return call


def compile_reader(schema):
    """A block decoder ``(payload, count) -> records`` for a parsed schema,
    giving `read_datum`'s values (EOFError when the payload is short)."""
    def body(g):
        g.value(schema, "rec", 2, ())
        return (["def decode(b, count):", "    L = len(b)", "    p = 0",
                 "    out = []", "    for _ in range(count):"],
                ["        out.append(rec)", "    return out"])

    decode = _compile(schema, body)

    def block(payload: bytes, count: int) -> list:
        try:
            return decode(payload, count)
        except (IndexError, struct.error):
            raise EOFError("truncated record in block") from None
    return block


def _union_branch(schema_list, value):
    """Pick the union branch for a Python value (writer side): exact
    Python-type match first (a str routes to the string branch of
    [null, long, string], not the first non-null one), then a lenient
    numeric match (int into float/double), then the first non-null
    branch (the historical 2-branch-nullable behavior)."""
    if value is None:
        for i, s in enumerate(schema_list):
            if _schema_type(s) == "null":
                return i, s
        raise ValueError(f"no null branch in {schema_list}")

    def exact(t):
        if t in ("int", "long"):
            return isinstance(value, int) and not isinstance(value, bool)
        if t in ("float", "double"):
            return isinstance(value, float)
        if t in ("string", "enum"):
            return isinstance(value, str)
        if t == "boolean":
            return isinstance(value, bool)
        if t in ("bytes", "fixed"):
            return isinstance(value, (bytes, bytearray))
        if t == "array":
            return isinstance(value, (list, tuple))
        if t in ("map", "record"):
            return isinstance(value, dict)
        return False

    for match in (exact,
                  lambda t: (t in ("float", "double")
                             and isinstance(value, int)
                             and not isinstance(value, bool)),
                  lambda t: t != "null"):
        for i, s in enumerate(schema_list):
            if match(_schema_type(s)):
                return i, s
    raise ValueError(f"no union branch for {value!r} in {schema_list}")


def write_datum(out, schema, value) -> None:
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(value))
    elif t == "float":
        out.write(struct.pack("<f", float(value)))
    elif t == "double":
        out.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        _write_bytes(out, bytes(value))
    elif t == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    elif t == "union":
        branches = schema if isinstance(schema, list) else schema["type"]
        i, s = _union_branch(branches, value)
        _write_long(out, i)
        write_datum(out, s, value)
    elif t == "record":
        for f in schema["fields"]:
            if f["name"] not in value and "default" in f:
                write_datum(out, f["type"], f["default"])
            else:
                write_datum(out, f["type"], value[f["name"]])
    elif t == "enum":
        _write_long(out, schema["symbols"].index(value))
    elif t == "fixed":
        out.write(bytes(value))
    elif t == "array":
        if value:
            _write_long(out, len(value))
            for item in value:
                write_datum(out, schema["items"], item)
        _write_long(out, 0)
    elif t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, str(k).encode("utf-8"))
                write_datum(out, schema["values"], v)
        _write_long(out, 0)
    else:
        raise ValueError(f"unsupported schema type: {t}")


# --------------------------------------------------------------------------
# container files
# --------------------------------------------------------------------------


def _snappy_block_uncompress(path, payload: bytes) -> bytes:
    """Avro snappy block: raw snappy + 4-byte big-endian CRC32 of the
    uncompressed bytes. Decompresses through the C++ runtime when it is
    available (the ingest hot path), the pure-Python `data.snappy`
    otherwise."""
    if len(payload) < 4:
        raise ValueError(f"{path}: snappy block too short for its CRC")
    raw, (crc,) = payload[:-4], struct.unpack(">I", payload[-4:])
    from photon_tpu_torch import native

    out = (native.snappy_uncompress(raw) if native.available()
           else _snappy.uncompress(raw))
    if zlib.crc32(out) & 0xFFFFFFFF != crc:
        raise ValueError(f"{path}: snappy block CRC mismatch")
    return out


class AvroContainerReader:
    """Iterate records of one Avro object container file."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError(f"{path}: not an Avro container file")
            meta = {}
            while True:
                n = _read_long(f)
                if n == 0:
                    break
                if n < 0:
                    _read_long(f)
                    n = -n
                for _ in range(n):
                    k = _read_bytes(f).decode("utf-8")
                    meta[k] = _read_bytes(f)
            self.metadata = meta
            self.codec = meta.get("avro.codec", b"null").decode("utf-8")
            if self.codec not in ("null", "deflate", "snappy"):
                raise ValueError(f"{path}: unsupported codec {self.codec!r}")
            self.schema = parse_schema(meta["avro.schema"].decode("utf-8"))
            self.sync = f.read(SYNC_SIZE)
            self._data_offset = f.tell()
        self._reader = None

    def _decompress(self, payload: bytes) -> bytes:
        """Apply the file's codec to one raw block payload — shared by the
        sequential `blocks` walk and the random-access `blocks_at` reads
        (the ingest plane's per-worker block slices)."""
        if self.codec == "deflate":
            return zlib.decompress(payload, -15)
        if self.codec == "snappy":
            return _snappy_block_uncompress(self.path, payload)
        return payload

    def blocks(self, skip_payload: bool = False) -> Iterator[tuple[int, bytes]]:
        """(record count, decompressed payload) per container block. With ``skip_payload`` the
        payload is seeked over without reading or decompressing (the
        streaming layer's header-only row-count scan) and b"" is yielded."""
        for _, count, _, payload in self.walk_blocks(skip_payload):
            yield count, payload

    def walk_blocks(self, skip_payload: bool = False):
        """(offset of the block's count varint, record count, compressed
        size, decompressed payload) per block — `blocks` plus the
        offset/size entries the ingest plane's block index records, so one
        walk can decode AND index (the map-building scan collects both)."""
        with open(self.path, "rb") as f:
            f.seek(self._data_offset)
            while True:
                offset = f.tell()
                head = f.read(1)
                if not head:
                    return
                f.seek(-1, os.SEEK_CUR)
                count = _read_long(f)
                size = _read_long(f)
                if skip_payload:
                    f.seek(size, os.SEEK_CUR)
                    payload = b""
                else:
                    payload = f.read(size)
                    if len(payload) != size:
                        raise EOFError(f"{self.path}: truncated block")
                sync = f.read(SYNC_SIZE)
                if sync != self.sync:
                    raise ValueError(f"{self.path}: bad sync marker")
                if not skip_payload:
                    payload = self._decompress(payload)
                yield offset, count, size, payload

    def block_index(self) -> list:
        """[(offset, count, compressed size)] of every container block —
        a header-only scan (no payload read or decompress). The unit the
        ingest plane's chunk-task planner splits across decode workers,
        and the row-count source `scan_row_counts` reuses so a cold start
        touches each file's headers once."""
        return [(off, count, size) for off, count, size, _
                in self.walk_blocks(skip_payload=True)]

    def blocks_at(self, entries) -> Iterator[tuple[int, bytes]]:
        """(record count, decompressed payload) for the given block-index
        ``entries`` ([(offset, count, size)]) — random access, one seek
        per block, sync-marker-verified. A decode worker reads ONLY its
        slice of the container this way; nothing else is touched."""
        with open(self.path, "rb") as f:
            for offset, count, size in entries:
                f.seek(offset)
                got_count = _read_long(f)
                got_size = _read_long(f)
                if got_count != count or got_size != size:
                    raise ValueError(
                        f"{self.path}: block at offset {offset} does not "
                        f"match its index entry (file changed since the "
                        "index was built?)")
                payload = f.read(size)
                if len(payload) != size:
                    raise EOFError(f"{self.path}: truncated block")
                if f.read(SYNC_SIZE) != self.sync:
                    raise ValueError(f"{self.path}: bad sync marker")
                yield count, self._decompress(payload)

    def records(self, count: int, payload: bytes) -> list:
        """The records of one decompressed block payload."""
        if self._reader is None:
            self._reader = compile_reader(self.schema)
        return self._reader(payload, count)

    def __iter__(self) -> Iterator[dict]:
        for count, payload in self.blocks():
            yield from self.records(count, payload)


def avro_paths(path) -> list:
    """One file, or every .avro file of a directory in sorted order — THE
    file-selection convention (the reference's HDFS-folder input), shared
    by the one-shot, native, and streaming readers."""
    if os.path.isdir(path):
        return [os.path.join(path, n) for n in sorted(os.listdir(path))
                if n.endswith(".avro")]
    return [str(path)]


def read_avro(path) -> list:
    """All records of one container file (or every .avro file in a dir,
    matching the reference's HDFS-folder input convention)."""
    out: list = []
    for p in avro_paths(path):
        out.extend(AvroContainerReader(p))
    return out


def write_avro(
    path,
    records: Iterable[dict],
    schema,
    codec: str = "deflate",
    sync: Optional[bytes] = None,
    block_records: int = 4096,
) -> None:
    """Write one container file (fixture/test/model output path).
    Container framing and codecs live in AvroBlockWriter (one place);
    this adds only the per-record datum encoding."""
    parsed = parse_schema(schema)
    with AvroBlockWriter(path, schema, codec=codec, sync=sync) as w:
        block: list = []

        def flush():
            if not block:
                return
            buf = io.BytesIO()
            for r in block:
                write_datum(buf, parsed, r)
            w.write_block(len(block), buf.getvalue())
            block.clear()

        for r in records:
            block.append(r)
            if len(block) >= block_records:
                flush()
        flush()


class AvroBlockWriter:
    """Container-file writer fed PRE-ENCODED block payloads.

    Consumers encode whole blocks vectorized (see the block-encoding
    primitives below) and append them chunk by chunk — inputs and outputs
    both stay bounded, and no per-record Python write_datum loop gates
    throughput. `write_block` takes the RAW (uncompressed) payload;
    compression follows the file's codec exactly as write_avro's flush
    does.
    """

    def __init__(self, path, schema, codec: str = "deflate",
                 sync: Optional[bytes] = None):
        if codec not in ("null", "deflate", "snappy"):
            raise ValueError(f"unsupported codec {codec!r}")
        self.codec = codec
        self.sync = sync or os.urandom(SYNC_SIZE)
        schema_json = schema if isinstance(schema, str) else json.dumps(schema)
        # a GB-scale streaming append cannot buffer for commit_bytes;
        # readers detect torn containers by sync marker + CRC
        # photon: allow(durable_write, streaming Avro container writer)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        meta = {"avro.schema": schema_json.encode("utf-8"),
                "avro.codec": codec.encode("utf-8")}
        _write_long(self._f, len(meta))
        for k, v in meta.items():
            _write_bytes(self._f, k.encode("utf-8"))
            _write_bytes(self._f, v)
        _write_long(self._f, 0)
        self._f.write(self.sync)

    def write_block(self, count: int, payload: bytes) -> None:
        if count <= 0:
            return
        if self.codec == "deflate":
            c = zlib.compressobj(6, zlib.DEFLATED, -15)
            payload = c.compress(payload) + c.flush()
        elif self.codec == "snappy":
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            payload = _snappy.compress(payload) + struct.pack(">I", crc)
        _write_long(self._f, count)
        _write_long(self._f, len(payload))
        self._f.write(payload)
        self._f.write(self.sync)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# vectorized block-encoding primitives (the output analog of the native
# block decoder: build whole block payloads with numpy byte scatter, no
# per-record write_datum loop). Schema-specific encoders compose these —
# see drivers.score.encode_scored_block for the ScoredItemAvro instance.
# --------------------------------------------------------------------------


def varint_bytes(values):
    """Zigzag varint encoding of NON-NEGATIVE int64s, vectorized: returns
    (byte matrix (n, w), per-value byte lengths). Bytes past a value's
    length are zero and must not be emitted."""
    z = values.astype(np.uint64) << np.uint64(1)
    cols = []
    lengths = np.ones(values.shape[0], np.int64)
    rem = z.copy()
    while True:
        b = (rem & np.uint64(0x7F)).astype(np.uint8)
        rem >>= np.uint64(7)
        more = rem != 0
        cols.append(np.where(more, b | 0x80, b).astype(np.uint8))
        if not more.any():
            break
        lengths += more  # continuing values get one more byte
    return np.stack(cols, axis=1), lengths


def ragged_arange(lens):
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def scatter_ragged(buf, starts, mat, lens) -> None:
    """buf[starts[i] + j] = mat[i, j] for j < lens[i], no Python loop."""
    intra = ragged_arange(lens)
    rows = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    buf[np.repeat(starts, lens) + intra] = mat[rows, intra]
