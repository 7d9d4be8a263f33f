"""The port's native layer (`photon_tpu_torch.native`: the feature-index
store, `PalDBIndexMap`, the Avro block decoder, snappy) against the
port's pure-Python decode and the JAX package's native decode, on Avro
written from a numpy seed under ``tmp_path``.

Every comparison is exact: the native layer is a fast path, never a
semantic fork. Covers the null, deflate and snappy codecs, build and
frozen modes, a directory input, exotic unconsumed fields, map-typed
bags, widened scalars, corrupt and truncated blocks, an unplannable
schema's counted fallback, a library that cannot build (raises under
``use_native=True``, falls back counted under None), the file-locked
build under concurrent processes, and the indexing driver's native count.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from photon_tpu import native as RN  # noqa: E402
from photon_tpu.data import index_map as RIM  # noqa: E402
from photon_tpu.data import ingest as RI  # noqa: E402
from photon_tpu.data.feature_bags import \
    FeatureShardConfig as RFeatureShardConfig  # noqa: E402

from photon_tpu_torch import native as PN  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import ingest as PI  # noqa: E402
from photon_tpu_torch.data import snappy as PS  # noqa: E402
from photon_tpu_torch.data.avro_io import (parse_schema,  # noqa: E402
                                           write_avro)
from photon_tpu_torch.data.feature_bags import \
    FeatureShardConfig  # noqa: E402
from photon_tpu_torch.data.index_map import (INTERCEPT_KEY,  # noqa: E402
                                             IndexMap, PalDBIndexMap,
                                             feature_key)
from photon_tpu_torch.data.matrix import SparseRows  # noqa: E402
from photon_tpu_torch.data.native_ingest import (  # noqa: E402
    compile_plan, read_game_data_native)
from photon_tpu_torch.drivers import index as PDI  # noqa: E402

SHARDS = {"global": (("features", "ctx"), True),
          # bag order reversed against the schema's field order: ids
          # follow config order
          "rev": (("ctx", "features"), True),
          "per_user": (("ctx",), False),
          "wide": (("features",), True, 4)}


def configs(shards=SHARDS, entity_fields=("userId",)):
    def cfg(cls):
        return {s: cls(bags=v[0], has_intercept=v[1],
                       **({"dense_threshold": v[2]} if len(v) > 2 else {}))
                for s, v in shards.items()}

    return (PI.GameDataConfig(shards=cfg(FeatureShardConfig),
                              entity_fields=entity_fields),
            RI.GameDataConfig(shards=cfg(RFeatureShardConfig),
                              entity_fields=entity_fields))


def records(rng, n=200):
    recs = []
    for i in range(n):
        feats = [{"name": f"f{j}", "term": ("" if j % 3 == 0 else f"t{j % 5}"),
                  "value": float(rng.normal())}
                 for j in rng.choice(30, size=rng.integers(1, 8),
                                     replace=False)]
        recs.append({
            "response": float(i % 2),
            "offset": None if i % 4 else 0.25,
            "weight": None if i % 3 else 2.0,
            "uid": f"u{i}",
            "userId": f"user{i % 11}",
            "features": feats,
            "ctx": [{"name": "c", "term": "", "value": 1.0 + i}],
        })
    return recs


def schema(bags=("features", "ctx")):
    return PI.training_example_schema(feature_bags=bags,
                                      entity_fields=("userId",))


def assert_same(a, b, amaps=None, bmaps=None):
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert set(a.shards) == set(b.shards)
    for s in a.shards:
        A, B = a.shards[s], b.shards[s]
        if isinstance(A, SparseRows) or hasattr(A, "indices"):
            np.testing.assert_array_equal(np.asarray(A.indices),
                                          np.asarray(B.indices))
            np.testing.assert_array_equal(np.asarray(A.values),
                                          np.asarray(B.values))
        else:
            np.testing.assert_array_equal(np.asarray(A), np.asarray(B))
        if amaps is not None:
            assert amaps[s].keys_in_order() == bmaps[s].keys_in_order()
    assert a.entity_ids.keys() == b.entity_ids.keys()
    for e in a.entity_ids:
        np.testing.assert_array_equal(np.asarray(a.entity_ids[e]),
                                      np.asarray(b.entity_ids[e]))


def three_way(path, pcfg, rcfg, index_maps=None):
    """Port native == port Python == the reference's native read."""
    pn, pnm = PI.read_game_data(path, pcfg, index_maps=index_maps,
                                use_native=True)
    pp, ppm = PI.read_game_data(path, pcfg, index_maps=index_maps,
                                use_native=False)
    rmaps = None
    if index_maps is not None:
        rmaps = {s: RIM.IndexMap(dict(m.key_to_id), frozen=True,
                                 has_intercept=m.has_intercept)
                 for s, m in index_maps.items()}
    rn, rnm = RI.read_game_data(path, rcfg, index_maps=rmaps,
                                use_native=True)
    assert_same(pn, pp, pnm, ppm)
    assert_same(pn, rn, pnm, rnm)
    return pn, pnm


# ------------------------------------------------------------- the store
def test_native_store_against_index_map_and_reference(tmp_path):
    keys = [f"f{i}\x01t{i % 7}" for i in range(500)]
    s = PN.NativeIndexStore(capacity_hint=8)
    np.testing.assert_array_equal(s.insert_batch(keys), np.arange(500))
    np.testing.assert_array_equal(s.insert_batch(keys[:10]), np.arange(10))
    assert len(s) == 500 and s.get("missing") == -1 and s.get("") == -1
    imap = IndexMap().build(keys).freeze()
    probe = keys[::3] + ["absent", "f1"]
    want = np.asarray([imap.get(k) for k in probe], np.int32)
    np.testing.assert_array_equal(s.lookup_batch(probe), want)
    r = RN.NativeIndexStore.from_keys(keys)
    np.testing.assert_array_equal(r.lookup_batch(probe), want)
    assert s.keys_in_order() == keys == r.keys_in_order()
    # the saved file is the reference's format: either package opens it
    s.save(tmp_path / "p.phidx")
    r.save(tmp_path / "r.phidx")
    assert (tmp_path / "p.phidx").read_bytes() == \
        (tmp_path / "r.phidx").read_bytes()
    s2 = PN.NativeIndexStore.open(tmp_path / "r.phidx")
    assert s2.keys_in_order() == keys and s2.insert("nope") == -1


def test_paldb_index_map(tmp_path):
    imap = IndexMap()
    for i in range(100):
        imap.index_of(feature_key(f"f{i}", f"t{i % 3}"))
    imap.index_of(INTERCEPT_KEY)
    imap.freeze()
    pal = PalDBIndexMap.build(imap)
    assert (pal.n_features, pal.intercept_id) == (imap.n_features,
                                                  imap.intercept_id)
    for k in imap.keys_in_order():
        assert pal.get(k) == imap.get(k)
    assert pal.get("absent") == IndexMap.NULL_ID
    probe = imap.keys_in_order() + ["absent"]
    np.testing.assert_array_equal(
        pal.lookup_batch(probe), [imap.get(k) for k in probe])
    pal.save(tmp_path / "pal.bin")
    for other in (PalDBIndexMap.open(tmp_path / "pal.bin"),
                  RIM.PalDBIndexMap.open(tmp_path / "pal.bin")):
        assert other.keys_in_order() == imap.keys_in_order()
        assert other.to_index_map().key_to_id == imap.key_to_id


def test_snappy_native_equals_python():
    rng = np.random.default_rng(3)
    for n in (0, 1, 100, 70000):
        raw = bytes(rng.integers(0, 4, n).astype(np.uint8))
        comp = PS.compress(raw)
        assert PN.snappy_uncompress(comp) == PS.uncompress(comp) == raw
    with pytest.raises(ValueError):
        PN.snappy_uncompress(b"\xff\xff\xff\xff\xff\xff")


# ------------------------------------------------------------ the decoder
@pytest.mark.parametrize("codec", ["null", "deflate", "snappy"])
def test_decode_three_ways_build_and_frozen(tmp_path, codec):
    rng = np.random.default_rng(7)
    path = tmp_path / "t.avro"
    write_avro(path, records(rng), schema(), codec=codec, block_records=64)
    pcfg, rcfg = configs()
    _, maps = three_way(path, pcfg, rcfg)
    assert isinstance(PI.read_game_data(path, pcfg)[0].shards["wide"],
                      SparseRows)
    # frozen: the scoring side, a map that misses features
    other = tmp_path / "o.avro"
    write_avro(other, records(np.random.default_rng(8), 90), schema(),
               codec=codec, block_records=32)
    three_way(other, pcfg, rcfg, index_maps=maps)


def test_directory_input(tmp_path):
    rng = np.random.default_rng(9)
    recs = records(rng, 120)
    d = tmp_path / "data"
    d.mkdir()
    write_avro(d / "part-00000.avro", recs[:50], schema(), codec="null")
    write_avro(d / "part-00001.avro", recs[50:], schema(), codec="snappy",
               block_records=16)
    pcfg, rcfg = configs()
    got, _ = three_way(d, pcfg, rcfg)
    assert got.n == 120


def test_exotic_unconsumed_fields_map_bags_and_widened_scalars(tmp_path):
    rng = np.random.default_rng(11)
    sch = schema()
    sch["fields"] += [
        {"name": "meta", "type": {
            "type": "record", "name": "Meta", "fields": [
                {"name": "a", "type": "long"},
                {"name": "b", "type": ["null", "string", "double"]},
                {"name": "inner", "type": {
                    "type": "record", "name": "Inner", "fields": [
                        {"name": "xs", "type": {"type": "array",
                                                "items": "double"}}]}}]}},
        {"name": "tags", "type": {"type": "map", "values": "string"}},
        {"name": "kind", "type": {"type": "enum", "name": "Kind",
                                  "symbols": ["A", "B", "C"]}},
        {"name": "blob", "type": {"type": "fixed", "name": "Blob",
                                  "size": 6}},
        {"name": "flag", "type": "boolean"},
        {"name": "mbag", "type": {"type": "map", "values": "float"}},
    ]
    for f in sch["fields"]:
        if f["name"] == "response":
            f["type"] = "float"
        elif f["name"] == "weight":
            f["type"] = ["long", "null"]
        elif f["name"] == "offset":
            f["type"] = ["null", "string", "double"]
    recs = [dict(r, response=float(i % 2), weight=(i % 5) or None,
                 offset=("x" if i % 7 == 0 else 0.5 * (i % 3)),
                 meta={"a": i, "b": ("s" if i % 3 == 0 else
                                     (None if i % 3 == 1 else 2.5)),
                       "inner": {"xs": [1.0] * (i % 4)}},
                 tags={f"t{j}": "v" for j in range(i % 3)},
                 kind="ABC"[i % 3], blob=b"\x01\x02\x03\x04\x05\x06",
                 flag=bool(i % 2),
                 mbag={f"m{j}": float(j + i) for j in range(i % 4)})
            for i, r in enumerate(records(rng, 120))]
    path = tmp_path / "x.avro"
    write_avro(path, recs, sch, block_records=40)
    shards = dict(SHARDS, maps=(("mbag", "ctx"), True))
    pcfg, rcfg = configs(shards)
    # native by construction
    assert compile_plan(parse_schema(sch), pcfg) is not None
    three_way(path, pcfg, rcfg)


def _corrupt(path, out, stride=37):
    from photon_tpu_torch.data.avro_io import AvroContainerReader

    raw = bytearray(path.read_bytes())
    start = AvroContainerReader(path)._data_offset + 8
    for off in range(start, min(start + 2000, len(raw) - 20), stride):
        raw[off] ^= 0xFF
    out.write_bytes(bytes(raw))


def test_corrupt_and_truncated_blocks_raise(tmp_path):
    rng = np.random.default_rng(12)
    path = tmp_path / "ok.avro"
    write_avro(path, records(rng, 50), schema(), codec="null",
               block_records=50)
    pcfg, _ = configs()
    _corrupt(path, tmp_path / "bad.avro")
    raw = path.read_bytes()
    (tmp_path / "trunc.avro").write_bytes(raw[:len(raw) - len(raw) // 3])
    for bad in ("bad.avro", "trunc.avro"):
        with pytest.raises((ValueError, EOFError)):
            read_game_data_native(tmp_path / bad, pcfg)


def test_unplannable_schema_falls_back_counted(tmp_path):
    rng = np.random.default_rng(13)
    sch = schema()
    for f in sch["fields"]:
        if f["name"] == "response":
            f["type"] = ["null", "double", "float"]  # ambiguous: Python
    path = tmp_path / "odd.avro"
    write_avro(path, records(rng, 20), sch)
    pcfg, rcfg = configs()
    with pytest.raises(RuntimeError, match="not native-plannable"):
        PI.read_game_data(path, pcfg, use_native=True)
    telemetry.reset()
    got, gmaps = PI.read_game_data(path, pcfg)
    c = telemetry.snapshot()["counters"]
    assert c.get("ingest.python_fallback") == 1
    assert "ingest.native_unavailable" not in c
    want, wmaps = RI.read_game_data(path, rcfg, use_native=False)
    assert_same(got, want, gmaps, wmaps)


def test_library_that_cannot_build(tmp_path, monkeypatch):
    rng = np.random.default_rng(14)
    path = tmp_path / "t.avro"
    write_avro(path, records(rng, 30), schema())
    pcfg, _ = configs()
    want, _ = PI.read_game_data(path, pcfg, use_native=False)
    bad = tmp_path / "broken.cc"
    bad.write_text('#error "deliberately broken"\n')
    monkeypatch.setattr(PN, "_SRC", bad)
    monkeypatch.setattr(PN, "_LIB_PATH", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_tried", False)
    monkeypatch.setattr(PN, "_error", None)
    assert not PN.available()
    assert "deliberately broken" in PN.build_error()
    with pytest.raises(RuntimeError, match="deliberately broken"):
        PI.read_game_data(path, pcfg, use_native=True)
    telemetry.reset()
    got, _ = PI.read_game_data(path, pcfg)
    c = telemetry.snapshot()["counters"]
    assert c.get("ingest.native_unavailable") == 1
    assert c.get("ingest.python_fallback") == 1
    assert_same(got, want)
    assert not (tmp_path / "_build" / "lib.so").exists()


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Three processes import the module and build at once into one
    build directory: each loads a whole library (the file lock and the
    os.replace of a temporary name)."""
    lib = tmp_path / "_build" / "libphoton_native.so"
    code = (
        "import sys, pathlib; sys.path.insert(0, sys.argv[1]);"
        "from photon_tpu_torch import native as N;"
        "N._LIB_PATH = pathlib.Path(sys.argv[2]);"
        "s = N.NativeIndexStore.from_keys(['a', 'b']);"
        "assert s.get('b') == 1, N.build_error(); print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code, root, str(lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert lib.exists()
    assert not [f for f in os.listdir(lib.parent) if ".tmp." in f]


def test_indexing_driver_native_count_equals_python(tmp_path):
    rng = np.random.default_rng(15)
    path = tmp_path / "t.avro"
    write_avro(path, records(rng, 300), schema(), block_records=50)
    shards = {"global": {"bags": ["features", "ctx"]},
              "rev": {"bags": ["ctx", "features"], "has_intercept": False}}
    outs = {}
    for name, use in (("native", None), ("python", False)):
        telemetry.reset()
        outs[name] = PDI.run_indexing(PDI.IndexingParams(
            str(path), str(tmp_path / name), shards, min_count=3,
            use_native=use))
        assert "ingest.python_fallback" not in \
            telemetry.snapshot()["counters"]
    assert outs["native"].sizes == outs["python"].sizes
    assert outs["native"].n_records == outs["python"].n_records == 300
    for s in shards:
        assert (tmp_path / "native" / f"{s}.index.tsv").read_bytes() == \
            (tmp_path / "python" / f"{s}.index.tsv").read_bytes()
