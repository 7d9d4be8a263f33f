"""The port's Avro container IO (`photon_tpu_torch.data.avro_io`,
`data.snappy`) against the JAX package's copies.

Null, deflate and snappy round trips of a schema with every type the
drivers meet (longs, doubles, floats, nullable unions, nested records, a
named-type reference, arrays, maps, booleans); each package reads the
other's files to equal records, block index included; the port's
`snappy.compress` gives the reference's bytes and its `uncompress` the
same verdicts; the vectorized block-encoding primitives and
`AvroBlockWriter` give the reference's bytes for the same sync marker.
Inputs are written from a numpy seed under ``tmp_path``.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import io  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from photon_tpu.data import avro_io as RA  # noqa: E402
from photon_tpu.data import snappy as RS  # noqa: E402

from photon_tpu_torch.data import avro_io as PA  # noqa: E402
from photon_tpu_torch.data import snappy as PS  # noqa: E402

CODECS = ["null", "deflate", "snappy"]
SYNC = bytes(range(16))

SCHEMA = {
    "type": "record",
    "name": "Rich",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "score", "type": "double"},
        {"name": "f", "type": "float"},
        {"name": "tag", "type": ["null", "string"], "default": None},
        {"name": "nested", "type": {
            "type": "record", "name": "Inner",
            "fields": [{"name": "v", "type": "double"}],
        }},
        {"name": "arr", "type": {"type": "array", "items": "Inner"}},
        {"name": "m", "type": {"type": "map", "values": "int"}},
        {"name": "flag", "type": "boolean"},
        {"name": "wide", "type": ["null", "long", "string"], "default": None},
    ],
}


def records(n: int = 300, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "id": int(rng.integers(-2**40, 2**40)),
            "score": float(rng.normal()),
            "f": float(np.float32(rng.normal())),
            "tag": None if i % 3 else f"tag{i}é",
            "nested": {"v": float(rng.uniform())},
            "arr": [{"v": float(j)} for j in range(i % 4)],
            "m": {f"k{j}": int(rng.integers(-5, 5)) for j in range(i % 3)},
            "flag": bool(i % 2),
            "wide": (None, i, f"s{i}")[i % 3],
        })
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_round_trip(tmp_path, codec):
    recs = records()
    p = tmp_path / "t.avro"
    PA.write_avro(p, recs, SCHEMA, codec=codec, block_records=64)
    assert PA.read_avro(p) == recs
    rd = PA.AvroContainerReader(p)
    assert rd.codec == codec
    assert [c for c, _ in rd.blocks()] == [64] * 4 + [44]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_files(tmp_path, codec, writer):
    recs = records(seed=1)
    w, r = (PA, RA) if writer == "port" else (RA, PA)
    p = tmp_path / "x.avro"
    w.write_avro(p, recs, SCHEMA, codec=codec, sync=SYNC, block_records=50)
    assert r.read_avro(p) == recs == w.read_avro(p)
    assert (PA.AvroContainerReader(p).block_index()
            == RA.AvroContainerReader(p).block_index())
    # the same sync marker gives the same file, byte for byte
    q = tmp_path / "y.avro"
    r.write_avro(q, recs, SCHEMA, codec=codec, sync=SYNC, block_records=50)
    assert q.read_bytes() == p.read_bytes()


def test_directory_read_and_paths(tmp_path):
    for i in range(3):
        PA.write_avro(tmp_path / f"part-{i}.avro", records(20, seed=i),
                      SCHEMA)
    (tmp_path / "notes.txt").write_text("skip me")
    assert PA.avro_paths(tmp_path) == RA.avro_paths(tmp_path)
    assert PA.read_avro(tmp_path) == RA.read_avro(tmp_path)


def snappy_cases() -> list:
    rng = np.random.default_rng(0)
    return [
        b"", b"x", b"abcd" * 1000,
        rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        b"the quick brown fox " * 3000,
        rng.integers(0, 4, 80_000, dtype=np.uint8).tobytes(),
    ]


def test_snappy_compress_gives_the_reference_bytes():
    for raw in snappy_cases():
        z = PS.compress(raw)
        assert z == RS.compress(raw)
        assert PS.uncompress(z) == raw == RS.uncompress(z)


def test_snappy_bad_blocks_raise_as_the_reference():
    good = PS.compress(b"y" * 500)
    for bad in (b"", b"\xff\xff\xff\xff\xff\xff", good[:-3], good[:-1]):
        with pytest.raises(ValueError):
            PS.uncompress(bad)
        with pytest.raises(ValueError):
            RS.uncompress(bad)


def test_snappy_crc_mismatch_raises(tmp_path):
    p = tmp_path / "t.avro"
    PA.write_avro(p, records(50), SCHEMA, codec="snappy", block_records=50)
    raw = bytearray(p.read_bytes())
    raw[-18] ^= 0xFF  # a CRC byte of the last block (… crc4 sync16)
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        PA.read_avro(p)


def test_bad_sync_and_magic_raise(tmp_path):
    p = tmp_path / "t.avro"
    PA.write_avro(p, records(10), SCHEMA, codec="null")
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="sync"):
        PA.read_avro(p)
    p.write_bytes(b"NotAvro")
    with pytest.raises(ValueError, match="not an Avro"):
        PA.AvroContainerReader(p)


def test_block_encoding_primitives_match():
    rng = np.random.default_rng(3)
    vals = np.concatenate([[0, 1, 63, 64, 8191, 8192, 2**40],
                           rng.integers(0, 2**20, 200)]).astype(np.int64)
    pm, pl = PA.varint_bytes(vals)
    rm, rl = RA.varint_bytes(vals)
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(pl, rl)
    for i, v in enumerate(vals[:20]):
        out = io.BytesIO()
        PA._write_long(out, int(v))
        assert out.getvalue() == pm[i, :pl[i]].tobytes()
    lens = rng.integers(0, 5, 30)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    mat = rng.integers(0, 255, (30, 5)).astype(np.uint8)
    a = np.zeros(int(lens.sum()), np.uint8)
    b = a.copy()
    PA.scatter_ragged(a, starts, mat, lens)
    RA.scatter_ragged(b, starts, mat, lens)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PA.ragged_arange(lens),
                                  RA.ragged_arange(lens))


@pytest.mark.parametrize("codec", CODECS)
def test_block_writer_matches_reference(tmp_path, codec):
    recs = records(40, seed=4)
    parsed = PA.parse_schema(SCHEMA)
    buf = io.BytesIO()
    for r in recs:
        PA.write_datum(buf, parsed, r)
    for mod, name in ((PA, "p.avro"), (RA, "r.avro")):
        with mod.AvroBlockWriter(tmp_path / name, SCHEMA, codec=codec,
                                 sync=SYNC) as w:
            w.write_block(len(recs), buf.getvalue())
            w.write_block(0, b"")
    assert (tmp_path / "p.avro").read_bytes() == \
        (tmp_path / "r.avro").read_bytes()
    assert RA.read_avro(tmp_path / "p.avro") == recs


def test_parse_schema_leaves_the_callers_dict():
    import copy

    before = copy.deepcopy(SCHEMA)
    PA.parse_schema(SCHEMA)
    assert SCHEMA == before
    with pytest.raises(ValueError, match="codec"):
        PA.AvroBlockWriter(io.BytesIO(), SCHEMA, codec="zstd")


RECURSIVE = {
    "type": "record", "name": "Node",
    "fields": [{"name": "v", "type": "long"},
               {"name": "kind", "type": {"type": "enum", "name": "K",
                                         "symbols": ["A", "B"]}},
               {"name": "tag", "type": {"type": "fixed", "name": "F",
                                        "size": 3}},
               {"name": "blob", "type": "bytes"},
               {"name": "next", "type": ["null", "Node"]}],
}


def chain(i: int, depth: int) -> dict:
    return {"v": -i * 1000, "kind": "AB"[i % 2], "tag": bytes([i, 1, 2]),
            "blob": bytes(range(i % 7)),
            "next": None if depth == 0 else chain(i + 1, depth - 1)}


@pytest.mark.parametrize("schema,recs", [
    (SCHEMA, records(100, seed=5)),
    (RECURSIVE, [chain(i, i % 4) for i in range(20)])])
def test_compiled_decoder_matches_read_datum(schema, recs):
    """The readers' compiled block decoder gives `read_datum`'s values
    (the reference's decoder, kept as the port's reference), recursive
    named types included, and EOFError on a short payload."""
    parsed = PA.parse_schema(schema)
    buf = io.BytesIO()
    for r in recs:
        PA.write_datum(buf, parsed, r)
    payload = buf.getvalue()
    rbuf = io.BytesIO(payload)
    want = [RA.read_datum(rbuf, RA.parse_schema(schema)) for _ in recs]
    assert PA.compile_reader(parsed)(payload, len(recs)) == want == recs
    with pytest.raises(EOFError):
        PA.compile_reader(parsed)(payload[:-3], len(recs))
