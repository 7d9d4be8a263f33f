"""The port's streamed reads (`photon_tpu_torch.data.streaming`) against
its one-shot read and the JAX package's streaming, on multi-file Avro
written from a numpy seed under ``tmp_path``.

Chunks (the Python and the native decoder, several heights) concatenate
to the one-shot read and equal the reference's chunks; the arena stays
bounded; ragged widths quantize to powers of two; the maps of the
native first pass, `scan_ingest`'s block index and `scan_row_counts`
equal the reference's; `stream_to_device(device="cpu")` and
`stream_to_host` give the reference's arrays (bit for bit; a bf16
storage dtype rounds as the reference's); meshes raise naming their
item.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import feature_bags as RF  # noqa: E402
from photon_tpu.data import ingest as RI  # noqa: E402
from photon_tpu.data import streaming as RST  # noqa: E402
from photon_tpu.data.matrix import SparseRows as RSparseRows  # noqa: E402

from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import feature_bags as PF  # noqa: E402
from photon_tpu_torch.data import ingest as PI  # noqa: E402
from photon_tpu_torch.data import streaming as PST  # noqa: E402
from photon_tpu_torch.data.avro_io import write_avro  # noqa: E402
from photon_tpu_torch.data.dataset import ChunkedMatrix  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows, next_pow2  # noqa

CPU = torch.device("cpu")


def write_files(root, n_files=3, rows_per_file=400, seed=0, wide=False):
    """A multi-file GAME dataset; ``wide`` makes the second bag a
    high-cardinality one (a `SparseRows` shard)."""
    rng = np.random.default_rng(seed)
    schema = PI.training_example_schema(feature_bags=("f", "g"),
                                        entity_fields=("member",))
    for fi in range(n_files):
        recs = []
        for i in range(rows_per_file):
            f_bag = [{"name": "age", "term": "", "value": float(rng.normal())},
                     {"name": "ctr", "term": "", "value": float(rng.normal())}]
            if wide:
                g_bag = [{"name": f"id{int(v)}", "term": "t",
                          "value": float(rng.normal())}
                         for v in rng.integers(0, 500, size=rng.integers(
                             1, 4))]
            else:
                g_bag = [{"name": "bias", "term": "", "value": 1.0}]
            recs.append({
                "response": float(rng.integers(0, 2)),
                "offset": float(rng.normal()) if i % 3 == 0 else None,
                "weight": 2.0 if i % 5 == 0 else None,
                "uid": f"r{fi}_{i}",
                "member": f"m{int(rng.integers(0, 37))}",
                "f": f_bag, "g": g_bag})
        write_avro(root / f"part-{fi:03d}.avro", recs, schema,
                   block_records=130)
    return str(root)


def configs(wide=False):
    def shards(cls):
        return {"dense": cls(bags=("f",), has_intercept=True),
                "other": cls(bags=("g",), has_intercept=not wide,
                             dense_threshold=4 if wide else 1024)}

    return (PI.GameDataConfig(shards=shards(PF.FeatureShardConfig),
                              entity_fields=("member",)),
            RI.GameDataConfig(shards=shards(RF.FeatureShardConfig),
                              entity_fields=("member",)))


def ref_maps(maps):
    from photon_tpu.data.index_map import IndexMap

    return {s: IndexMap(dict(m.key_to_id), frozen=True,
                        has_intercept=m.has_intercept)
            for s, m in maps.items()}


def host(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.is_floating_point() \
            else a.numpy()
    return np.asarray(a, np.float32) if getattr(a, "dtype", None) == \
        jnp.bfloat16 else np.asarray(a)


def assert_shard(a, b):
    if isinstance(a, SparseRows) or isinstance(a, RSparseRows):
        np.testing.assert_array_equal(host(a.indices), host(b.indices))
        np.testing.assert_array_equal(host(a.values), host(b.values))
    else:
        np.testing.assert_array_equal(host(a), host(b))


def assert_data(a, b, n=None):
    n = a.n if n is None else n
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(host(getattr(a, f))[:n],
                                      host(getattr(b, f))[:n])
    for s in a.shards:
        A, B = a.shards[s], b.shards[s]
        if isinstance(A, SparseRows):
            assert_shard(SparseRows(host(A.indices)[:n], host(A.values)[:n],
                                    A.n_features),
                         SparseRows(host(B.indices)[:n], host(B.values)[:n],
                                    B.n_features))
        else:
            assert_shard(host(A)[:n], host(B)[:n])
    for e in a.entity_ids:
        np.testing.assert_array_equal(np.asarray(a.entity_ids[e])[:n],
                                      np.asarray(b.entity_ids[e])[:n])


def concat(parts):
    from photon_tpu_torch.game.dataset import GameData

    shards = {}
    for s, X in parts[0].shards.items():
        if isinstance(X, SparseRows):
            shards[s] = SparseRows(
                np.concatenate([p.shards[s].indices for p in parts]),
                np.concatenate([p.shards[s].values for p in parts]),
                X.n_features)
        else:
            shards[s] = np.concatenate([p.shards[s] for p in parts])
    return GameData(*(np.concatenate([getattr(p, f) for p in parts])
                      for f in ("y", "weights", "offsets")), shards,
                    {e: np.concatenate([p.entity_ids[e] for p in parts])
                     for e in parts[0].entity_ids})


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("use_native", [False, True])
def test_chunks_equal_one_shot_and_reference(tmp_path, wide, use_native):
    root = write_files(tmp_path, wide=wide)
    pcfg, rcfg = configs(wide)
    k = 4 if wide else None
    one, maps = PI.read_game_data(root, pcfg, sparse_k=k)
    streamed = PST.build_index_maps_streaming(root, pcfg,
                                              use_native=use_native)
    rstreamed = RST.build_index_maps_streaming(root, rcfg)
    for s in pcfg.shards:
        assert streamed[s].keys_in_order() == maps[s].keys_in_order() \
            == rstreamed[s].keys_in_order()
    for chunk_rows in (100, 300):
        stream, chunks = PST.iter_game_chunks(root, pcfg, streamed,
                                              chunk_rows=chunk_rows,
                                              sparse_k=k,
                                              use_native=use_native)
        parts = list(chunks)
        _, rchunks = RST.iter_game_chunks(root, rcfg, ref_maps(streamed),
                                          chunk_rows=chunk_rows, sparse_k=k,
                                          use_native=use_native)
        rparts = list(rchunks)
        assert len(parts) >= 2
        assert [c.n for c in parts] == [c.n for c in rparts]
        for a, b in zip(parts, rparts):
            assert_data(a, b)
        assert_data(concat(parts), one)


def test_bounded_arena(tmp_path):
    root = write_files(tmp_path, n_files=6, rows_per_file=500)
    pcfg, _ = configs()
    maps = PST.build_index_maps_streaming(root, pcfg)
    for use_native in (False, None):
        stream, chunks = PST.iter_game_chunks(root, pcfg, maps,
                                              chunk_rows=250,
                                              use_native=use_native)
        sizes = [PST._chunk_nbytes(c) for c in chunks]
        assert len(sizes) >= 6
        assert stream.peak_arena_bytes <= 2 * max(sizes) + (1 << 16)


@pytest.mark.parametrize("use_native", [False, None])
def test_ragged_widths_quantize_pow2(tmp_path, use_native):
    root = write_files(tmp_path, wide=True)
    pcfg, rcfg = configs(wide=True)
    maps = PST.build_index_maps_streaming(root, pcfg)
    _, chunks = PST.iter_game_chunks(root, pcfg, maps, chunk_rows=300,
                                     use_native=use_native,
                                     uniform_sparse_k=False)
    _, rchunks = RST.iter_game_chunks(root, rcfg, ref_maps(maps),
                                      chunk_rows=300,
                                      use_native=use_native,
                                      uniform_sparse_k=False)
    for a, b in zip(list(chunks), list(rchunks)):
        k = a.shards["other"].indices.shape[1]
        assert k == next_pow2(k)
        assert_data(a, b)


def test_scans_equal_reference(tmp_path):
    root = write_files(tmp_path, n_files=4, rows_per_file=123)
    pcfg, rcfg = configs()
    assert PST.scan_row_counts(root) == RST.scan_row_counts(root) == [123] * 4
    scan, rscan = PST.scan_ingest(root, pcfg), RST.scan_ingest(root, rcfg)
    assert scan.block_index == rscan.block_index and scan.n_rows == 492
    for s in pcfg.shards:
        assert scan.index_maps[s].keys_in_order() == \
            rscan.index_maps[s].keys_in_order()
    assert PST.scan_row_counts(root, block_index=scan.block_index) == \
        [123] * 4
    head = PST.scan_ingest(root, PI.GameDataConfig(shards={}))
    assert head.n_rows == 492 and head.index_maps == {}
    with pytest.raises(ValueError, match="frozen index maps"):
        PST.iter_game_chunks(root, pcfg, {})


@pytest.mark.parametrize("wide", [False, True])
def test_stream_to_device_cpu_equals_reference(tmp_path, wide):
    root = write_files(tmp_path, wide=wide)
    pcfg, rcfg = configs(wide)
    k = 4 if wide else None
    one, maps = PI.read_game_data(root, pcfg, sparse_k=k)
    telemetry.reset()
    data, n = PST.stream_to_device(root, pcfg, maps, chunk_rows=300,
                                   sparse_k=k, device=CPU)
    assert telemetry.snapshot()["counters"]["ingest.device_chunks"] >= 2
    rdata, rn = RST.stream_to_device(root, rcfg, ref_maps(maps),
                                     chunk_rows=300, sparse_k=k)
    assert n == rn == one.n == 1200
    assert data.y.device == CPU and data.y.dtype == torch.float32
    assert_data(data, rdata)
    assert_data(data, one)
    # a bf16 storage dtype, as the reference's
    b16, _ = PST.stream_to_device(root, pcfg, maps, chunk_rows=300,
                                  sparse_k=k, device=CPU,
                                  feature_dtype="bfloat16")
    rb16, _ = RST.stream_to_device(root, rcfg, ref_maps(maps),
                                   chunk_rows=300, sparse_k=k,
                                   feature_dtype=jnp.bfloat16)
    X = b16.shards["other"]
    assert (X.values if wide else X).dtype == torch.bfloat16
    assert_data(b16, rb16)
    with pytest.raises(NotImplementedError, match="item 10"):
        PST.stream_to_device(root, pcfg, maps, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="item 10"):
        PST.stream_to_device(root, pcfg, maps, local_only=True, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PST.stream_to_device(root, pcfg, maps)


@pytest.mark.parametrize("wide", [False, True])
def test_stream_to_host_equals_reference(tmp_path, wide):
    root = write_files(tmp_path, wide=wide)
    pcfg, rcfg = configs(wide)
    k = 4 if wide else None
    _, maps = PI.read_game_data(root, pcfg, sparse_k=k)
    for dtype, rdtype in ((None, None), ("bfloat16", jnp.bfloat16)):
        data, n = PST.stream_to_host(root, pcfg, maps,
                                     chunked_shards={"other"},
                                     chunk_rows=300,
                                     objective_chunk_rows=256, sparse_k=k,
                                     feature_dtype=dtype)
        rdata, rn = RST.stream_to_host(root, rcfg, ref_maps(maps),
                                       chunked_shards={"other"},
                                       chunk_rows=300,
                                       objective_chunk_rows=256,
                                       sparse_k=k, feature_dtype=rdtype)
        assert n == rn == data.n == 1200
        X, RX = data.shards["other"], rdata.shards["other"]
        assert isinstance(X, ChunkedMatrix) and X.n_chunks == RX.n_chunks == 5
        for a, b in zip(X.chunks, RX.chunks):
            if wide:
                assert a.values.dtype == (torch.bfloat16 if dtype
                                          else torch.float32)
            assert_shard(a, b)
        # resident shards and scalars: host numpy (the values rounded
        # through the storage dtype)
        assert isinstance(data.shards["dense"], np.ndarray)
        np.testing.assert_array_equal(
            data.shards["dense"], host(rdata.shards["dense"]))
        for f in ("y", "weights", "offsets"):
            np.testing.assert_array_equal(getattr(data, f),
                                          host(getattr(rdata, f)))
        np.testing.assert_array_equal(data.entity_ids["member"],
                                      rdata.entity_ids["member"])
    with pytest.raises(ValueError, match="chunked_shards"):
        PST.stream_to_host(root, pcfg, maps, chunked_shards={"nope"},
                           sparse_k=k)
