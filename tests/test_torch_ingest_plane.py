"""The port's ingest plane (`photon_tpu_torch.data.ingest_plane`,
`data.chunk_cache`, `ingest`) against the serial chunk stream and the JAX
package's plane, on multi-file Avro written from a numpy seed under
``tmp_path``.

The task plan equals the reference's; the thread pool (native and
Python decoders) and a 2-worker spawn process pool give the serial
chunks bit for bit; an ``ingest_worker`` kill at the first, a middle and
the last task degrades that chunk, counted, without a hang. The cache: a
cold build and a hit equal the serial chunks bit for bit and the hit
reads no Avro; a kill mid-commit reads as a miss; the key moves with
every input and equals the reference's; a newer schema is refused; a
corrupt payload fails its CRC; a blocked-ELL ladder round-trips bit for
bit and equals `chunk_blocked_ell` of the in-memory read.
`AdaptivePrefetch` decides as the reference's on the same observations,
and a `DeviceChunkRing` driven by it yields the same chunks at every
depth, adding slots as it widens. Thread mode serves wherever the
process pool is not what is tested.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import chunk_cache as rcc  # noqa: E402
from photon_tpu.data import ingest_plane as RIP  # noqa: E402

from photon_tpu_torch import ingest  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.checkpoint.faults import (FaultPlan,  # noqa: E402
                                                InjectedFault, fault_plan,
                                                record_sites)
from photon_tpu_torch.data import chunk_cache as cc  # noqa: E402
from photon_tpu_torch.data import ingest as PI  # noqa: E402
from photon_tpu_torch.data import ingest_plane as PIP  # noqa: E402
from photon_tpu_torch.data import streaming as PST  # noqa: E402
from photon_tpu_torch.data.dataset import (chunk_batch,  # noqa: E402
                                           chunk_blocked_ell, make_batch,
                                           _leaves)
from photon_tpu_torch.data.index_map import IndexMap  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows  # noqa: E402

from test_torch_streaming import (configs, ref_maps,  # noqa: E402
                                  write_files)
from _reference_native import reference_native  # noqa: E402

# the JAX package's native library, built once across the test processes
reference_native()

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = write_files(tmp_path_factory.mktemp("plane"), wide=True)
    pcfg, rcfg = configs(wide=True)
    scan = PST.scan_ingest(root, pcfg)
    _, chunks = PST.iter_game_chunks(root, pcfg, scan.index_maps,
                                     chunk_rows=300, sparse_k=4)
    return root, pcfg, rcfg, scan, list(chunks)


def chunks_equal(a, b):
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for s, X in a.shards.items():
        Y = b.shards[s]
        if isinstance(X, SparseRows):
            np.testing.assert_array_equal(X.indices, Y.indices)
            np.testing.assert_array_equal(X.values, Y.values)
        else:
            np.testing.assert_array_equal(X, Y)
    for e, col in a.entity_ids.items():
        np.testing.assert_array_equal(col, b.entity_ids[e])


def all_equal(want, got):
    got = list(got)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        chunks_equal(a, b)


def test_task_plan_equals_reference(dataset):
    root, _, _, scan, ref = dataset
    for rows in (1, 130, 300, 1000, 10 ** 6):
        tasks = PIP.plan_chunk_tasks(scan.block_index, rows)
        assert [dataclasses.astuple(t) for t in tasks] == [
            dataclasses.astuple(t)
            for t in RIP.plan_chunk_tasks(scan.block_index, rows)]
    tasks = PIP.plan_chunk_tasks(scan.block_index, 300)
    assert [t.n_rows for t in tasks] == [c.n for c in ref]
    assert PIP.scan_or_reuse_block_index(root) == scan.block_index


@pytest.mark.parametrize("use_native", [None, False])
def test_thread_pool_parity(dataset, use_native):
    root, pcfg, _, scan, ref = dataset
    if use_native is False:
        _, c = PST.iter_game_chunks(root, pcfg, scan.index_maps,
                                    chunk_rows=300, sparse_k=4,
                                    use_native=False)
        ref = list(c)
    telemetry.reset()
    _, c = PIP.iter_game_chunks_parallel(
        root, pcfg, scan.index_maps, chunk_rows=300, sparse_k=4, workers=3,
        mode="thread", use_native=use_native, block_index=scan.block_index)
    all_equal(ref, c)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.worker_chunks"] == len(ref)
    assert "ingest.python_fallback" not in counters


def test_process_pool_parity(dataset):
    """Two spawn workers (the real plane): the serial chunks bit for bit.
    A stream given no pool starts its own; two streams through one
    `DecodePool` share its workers, and a stream of another decode state
    restarts them."""
    root, pcfg, _, scan, ref = dataset
    kw = dict(chunk_rows=300, sparse_k=4, workers=2, mode="process",
              block_index=scan.block_index)
    telemetry.reset()
    _, c = PIP.iter_game_chunks_parallel(root, pcfg, scan.index_maps, **kw)
    all_equal(ref, c)
    assert telemetry.snapshot()["counters"]["ingest.pool_starts"] == 1
    with PIP.DecodePool() as pool:
        for _ in range(2):
            _, c = PIP.iter_game_chunks_parallel(
                root, pcfg, scan.index_maps, pool=pool, **kw)
            all_equal(ref, c)
        counters = telemetry.snapshot()["counters"]
        assert counters["ingest.worker_chunks"] == 3 * len(ref)
        assert counters["ingest.pool_starts"] == 2
        assert "ingest.worker_deaths" not in counters
        _, c = PIP.iter_game_chunks_parallel(
            root, pcfg, scan.index_maps, pool=pool, use_native=False, **kw)
        all_equal(ref, c)
    assert telemetry.snapshot()["counters"]["ingest.pool_starts"] == 3


def test_worker_kill_degrades(dataset):
    root, pcfg, _, scan, ref = dataset
    n = len(ref)
    for occ in (1, max(n // 2, 1), n):
        telemetry.reset()
        with fault_plan(FaultPlan.kill_at("ingest_worker", occ)):
            _, c = PIP.iter_game_chunks_parallel(
                root, pcfg, scan.index_maps, chunk_rows=300, sparse_k=4,
                workers=2, mode="thread", block_index=scan.block_index)
            all_equal(ref, c)
        counters = telemetry.snapshot()["counters"]
        assert counters["ingest.worker_deaths"] == 1
        assert counters["ingest.worker_chunks"] == n - 1


def test_cache_cold_and_hit_bit_for_bit(dataset, tmp_path, monkeypatch):
    root, pcfg, _, scan, ref = dataset
    cache = str(tmp_path / "cache")
    telemetry.reset()
    _, c = PIP.open_chunk_source(root, pcfg, scan.index_maps, chunk_rows=300,
                                 sparse_k=4, cache_dir=cache, workers=2,
                                 mode="thread", block_index=scan.block_index)
    all_equal(ref, c)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.cache_misses"] == 1
    assert counters["ingest.cache_builds"] == 1

    def no_avro(*a, **k):
        raise AssertionError("a cache hit opened an Avro container")

    monkeypatch.setattr(PST, "AvroContainerReader", no_avro)
    monkeypatch.setattr(PIP, "AvroContainerReader", no_avro)
    telemetry.reset()
    _, c = PIP.open_chunk_source(root, pcfg, scan.index_maps, chunk_rows=300,
                                 sparse_k=4, cache_dir=cache)
    all_equal(ref, c)
    assert telemetry.snapshot()["counters"]["ingest.cache_hits"] == 1
    # the reference opens the port's entry: same key, manifest, arrays
    key = cc.cache_key(root, pcfg, scan.index_maps, 300, 4)
    assert key == rcc.cache_key(root, dataset[2], ref_maps(scan.index_maps),
                                300, 4)
    bag = rcc.open_cache(cache, key, "game_chunks")
    all_equal(ref, rcc.iter_cached_chunks(bag))


def test_kill_mid_commit_reads_as_a_miss(dataset, tmp_path):
    root, pcfg, _, scan, ref = dataset
    key = cc.cache_key(root, pcfg, scan.index_maps, 300, 4)
    with record_sites() as rec:
        _, c = PIP.open_chunk_source(root, pcfg, scan.index_maps,
                                     chunk_rows=300, sparse_k=4,
                                     cache_dir=str(tmp_path / "dry"))
        list(c)
    n_hits = rec.hits["cache_commit"]
    for occ in (1, n_hits):
        cache = str(tmp_path / f"kill_{occ}")
        with pytest.raises(InjectedFault):
            with fault_plan(FaultPlan.kill_at("cache_commit", occ)):
                _, c = PIP.open_chunk_source(root, pcfg, scan.index_maps,
                                             chunk_rows=300, sparse_k=4,
                                             cache_dir=cache)
                list(c)
        assert cc.open_cache(cache, key, "game_chunks") is None
        _, c = PIP.open_chunk_source(root, pcfg, scan.index_maps,
                                     chunk_rows=300, sparse_k=4,
                                     cache_dir=cache)
        all_equal(ref, c)
        assert cc.open_cache(cache, key, "game_chunks") is not None


def test_cache_key_invalidation_refusal_and_crc(dataset, tmp_path):
    root, pcfg, rcfg, scan, _ = dataset
    maps = scan.index_maps
    base = cc.cache_key(root, pcfg, maps, 300, 4)
    assert base == rcc.cache_key(root, rcfg, ref_maps(maps), 300, 4)
    assert cc.cache_key(root, pcfg, maps, 256, 4) != base
    assert cc.cache_key(root, pcfg, maps, 300, 8) != base
    assert cc.cache_key(root, dataclasses.replace(pcfg, entity_fields=()),
                        maps, 300, 4) != base
    assert cc.cache_key(root, pcfg, {**maps, "other": IndexMap(
        {"only": 0}, frozen=True)}, 300, 4) != base
    assert cc.cache_key(root, pcfg, maps, 300, 4, kind="ladder") != base
    cache = str(tmp_path / "cache")
    _, c = PIP.open_chunk_source(root, pcfg, maps, chunk_rows=300,
                                 sparse_k=4, cache_dir=cache)
    list(c)
    bag = cc.open_cache(cache, base, "game_chunks")
    victim = os.path.join(bag.dir, bag.manifest["entries"][0]["file"])
    raw = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(raw[:-4] + b"\x00\x01\x02\x03")
    with pytest.raises(cc.ChunkCacheCorrupt):
        _, c = PIP.open_chunk_source(root, pcfg, maps, chunk_rows=300,
                                     sparse_k=4, cache_dir=cache)
        list(c)
    mpath = os.path.join(cc.entry_dir(cache, base), "MANIFEST.json")
    doc = json.load(open(mpath))
    doc["schema"] = cc.CACHE_SCHEMA_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(doc, f)
    with pytest.raises(cc.ChunkCacheSchemaError):
        PIP.open_chunk_source(root, pcfg, maps, chunk_rows=300, sparse_k=4,
                              cache_dir=cache)


def test_ladder_from_avro_and_its_cache(dataset, tmp_path):
    root, pcfg, _, scan, _ = dataset
    cache = str(tmp_path / "ladder")
    kw = dict(d_dense=64, sparse_k=4, cache_dir=cache, workers=2,
              mode="thread", feature_dtype=torch.bfloat16)
    telemetry.reset()
    cold = PIP.chunk_blocked_ell_from_avro(root, pcfg, scan.index_maps,
                                           "other", 256, **kw)
    hit = ingest.chunk_blocked_ell_from_avro(root, pcfg, scan.index_maps,
                                             "other", 256, **kw)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.cache_hits"] == 1
    assert counters["ingest.cache_builds"] == 1
    one, _ = PI.read_game_data(root, pcfg, index_maps=scan.index_maps,
                               sparse_k=4)
    want = chunk_blocked_ell(make_batch(one.shards["other"], one.y,
                                        one.weights, one.offsets,
                                        device=CPU), 256, d_dense=64,
                             feature_dtype=torch.bfloat16)
    for got in (cold, hit):
        assert got.X.n_chunks == want.X.n_chunks == 5
        for a, b in zip(got.X.chunks, want.X.chunks):
            la, lb = _leaves(a), _leaves(b)
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                assert x.dtype == y.dtype and torch.equal(x, y)
            assert torch.equal(a.perm_cols, b.perm_cols)
            assert (a.n_prefix, a.last_col_pos, a.tail_nnz) == \
                (b.n_prefix, b.last_col_pos, b.tail_nnz)
        for f in ("y", "weights", "offsets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert torch.equal(got.X.inv_perm, torch.as_tensor(want.X.inv_perm))
        assert got.X.last_col_pos == want.X.last_col_pos
    # a ladder laid for a 2-slot mesh (ported; it raised before), through
    # the cache too: each chunk the pair of shards `chunk_blocked_ell`
    # lays from the in-memory read
    mesh_kw = dict(kw, cache_dir=str(tmp_path / "mesh_ladder"))
    want2 = chunk_blocked_ell(make_batch(one.shards["other"], one.y,
                                         one.weights, one.offsets,
                                         device=CPU), 256, d_dense=64,
                              feature_dtype=torch.bfloat16, n_shards=2)
    for _ in range(2):  # cold, then a cache hit
        got2 = PIP.chunk_blocked_ell_from_avro(
            root, pcfg, scan.index_maps, "other", 256, n_shards=2,
            **mesh_kw)
        assert got2.X.chunk_shards == 2
        for a, b in zip(got2.X.chunks, want2.X.chunks):
            for x, y in zip(_leaves(a), _leaves(b)):
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_adaptive_prefetch_decides_as_reference():
    kw = dict(depth=2, max_depth=8, byte_budget=1000)
    ours, theirs = PIP.AdaptivePrefetch(**kw), RIP.AdaptivePrefetch(**kw)
    seq = [("o", 1.0, 0.1, 4, 100), ("o", 0.2, 1.0, 4, 100),
           ("o", 0.0, 1.0, 4, 100), ("o", 9.0, 0.1, 4, 200),
           ("w", 0.5, 200), ("w", 0.5, 50), ("w", 1e-5, 50),
           ("o", 0.0, 1.0, 4, 50), ("o", 0.01, 1.0, 4, 50)]
    for op, *args in seq:
        for ap in (ours, theirs):
            (ap.observe if op == "o" else ap.observe_wait)(*args)
        assert ours.depth == theirs.depth
    assert ours.decisions == theirs.decisions
    assert [d["why"] for d in ours.decisions][:5] == [
        "stalled", "stalled", "stall-free", "stalled", "upload-wait"]


def test_device_chunk_ring_follows_the_controller():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    y = rng.normal(size=100).astype(np.float32)
    cb = chunk_batch(make_batch(X, y, device=CPU), 16)
    want = [cb.chunk(i) for i in range(cb.n_chunks)]
    # the CPU's measured stalls never widen it (widen_frac): the depth of
    # each pass is set here, as a widening or narrowing would set it
    ctl = PIP.AdaptivePrefetch(depth=2, max_depth=5, widen_frac=1e9)
    ring = cb.device_ring(device=CPU, prefetch=ctl)
    for depth in (2, 4, 3, 2, 5):
        ctl.depth = depth
        assert ring.depth == depth
        for i, got in ring.stream_pass():
            assert torch.equal(got.X, want[i].X)
            assert torch.equal(got.y, want[i].y)
    assert len(ring._slots) == 5  # slots grew with the depth
    assert len(ctl.decisions) == 5  # one observation a pass
    assert all(d["n_items"] == cb.n_chunks for d in ctl.decisions)
    # the one-pass form takes a controller too
    out = [c.y.clone() for _, c in cb.iter_device(device=CPU,
                                                  prefetch=ctl)]
    for a, b in zip(out, want):
        assert torch.equal(a, b.y)
    assert len(ctl.decisions) == 6
