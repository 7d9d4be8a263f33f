"""The port's multi-process mesh spine on the CPU: the validation of
`initialize_distributed` and `launch` (mirroring tests/test_multihost.py's
round-17 classes), `shard_chunk_range`, the one-process pieces of the
``local_only`` ingest against the reference's `stream_to_device(mesh=)`,
and gloo runs of the `parallel.selfcheck` targets in spawned processes:

- the psum-signature digest at 1, 2 and 4 processes — one value, equal
  to the in-process 8-slot mesh's (bit for bit: the slot-ordered tree);
  and in the same launches GAME on the mesh, one digest of every table
  at 1, 2 and 4 processes equal to the in-process mesh's;
- the ``local_only`` ingest + mesh solve at 1, 2 and 4 processes — the
  coefficients bit for bit equal to each other and to the in-process
  mesh's, every rank of a multi-process run skipping chunks (the same
  launches as the digest: `target_stream_solve` runs both);
- a 2-process streamed snapshot restored at 1 and at 4 processes, bit for
  bit equal to an uninterrupted run; the same snapshot (one kill, copied
  before each restore writes into it) read by
  the REFERENCE's `SnapshotStore` and `unpack_row_slots` on its 8-device
  mesh (the carry-over format: ``p<k>_`` payloads, ``meta_p<k>.json``,
  ``@s<slot>`` keys) gives the port's global row caches back exactly;
- a rank killed between its payload and the commit barrier: the survivor's
  commit fails loudly within ``PHOTON_TPU_BARRIER_TIMEOUT_S`` and the
  previous manifest still restores;
- a failing child raises `ChildFailure` naming its rank.

Each spawned child re-imports torch (about 2 s here), so the tests share
their launches through module fixtures: eight in all.
"""
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.checkpoint import state as RState  # noqa: E402
from photon_tpu.checkpoint.store import (  # noqa: E402
    SnapshotStore as RSnapshotStore)
from photon_tpu.data import chunk_cache as RCC  # noqa: E402
from photon_tpu.data import streaming as RST  # noqa: E402
from photon_tpu.parallel import mesh as RMesh  # noqa: E402

from photon_tpu_torch import checkpoint  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import chunk_cache as CC  # noqa: E402
from photon_tpu_torch.data import streaming as PST  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402
from photon_tpu_torch.parallel import selfcheck as sc  # noqa: E402
from photon_tpu_torch.parallel.launch import (ChildFailure,  # noqa: E402
                                              launch)
from photon_tpu_torch.utils.env import KNOB_DOCS  # noqa: E402

CPU = "cpu"


def run(target, n, *args, **kw):
    return launch(target, n, args=args, device=CPU, timeout_s=240, **kw)


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(n_devices=8, device=CPU)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return sc.write_e2e_dataset(tmp_path_factory.mktemp("e2e"))


@pytest.fixture(scope="module")
def stream_runs(dataset):
    """{n: the ranks' `target_stream_solve` results} at 1, 2 and 4
    processes (the three clusters launched side by side): the psum digest
    and the ``local_only`` solve of each."""
    counts = (1, 2, 4)
    with ThreadPoolExecutor(len(counts)) as pool:
        futures = [pool.submit(run, sc.target_stream_solve, n, str(dataset))
                   for n in counts]
        return {n: f.result() for n, f in zip(counts, futures)}


@pytest.fixture(scope="module")
def two_process_snapshot(tmp_path_factory):
    """A 2-process mesh-streamed solve killed at its 7th evaluation: the
    snapshot directory it committed (copy it before resuming into it)."""
    ck = tmp_path_factory.mktemp("snap") / "ck"
    killed = run(sc.target_snapshot_kill, 2, str(ck), "evaluation", 7)
    assert all(r["killed"] and r["latest_seq"] >= 0 for r in killed)
    return ck


# ---------------------------------------------------------- validation
class TestInitializeDistributedValidation:
    """Loud validation before any traffic, and the knob plumbing the
    launcher rides (tests/test_multihost.py's round-17 class)."""

    def test_process_id_out_of_range(self):
        with pytest.raises(ValueError, match=r"ranks are 0\.\.3"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=4,
                                      process_id=4, device=CPU)
        with pytest.raises(ValueError, match="out of range"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=-1, device=CPU)

    def test_process_id_without_num_processes(self):
        with pytest.raises(ValueError, match="without num_processes"):
            PM.initialize_distributed("127.0.0.1:9", process_id=0,
                                      device=CPU)
        with pytest.raises(ValueError, match="without process_id"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      device=CPU)

    def test_bad_num_processes(self):
        with pytest.raises(ValueError, match="num_processes"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=0,
                                      device=CPU)

    def test_knobs_feed_validation(self, monkeypatch):
        monkeypatch.setenv("PHOTON_TPU_NUM_PROCESSES", "2")
        monkeypatch.setenv("PHOTON_TPU_PROCESS_ID", "5")
        with pytest.raises(ValueError, match="out of range"):
            PM.initialize_distributed(device=CPU)

    def test_no_cluster_is_a_single_process(self, monkeypatch):
        for knob in ("PHOTON_TPU_COORDINATOR", "PHOTON_TPU_NUM_PROCESSES",
                     "PHOTON_TPU_PROCESS_ID"):
            monkeypatch.delenv(knob, raising=False)
        assert PM.initialize_distributed(device=CPU) is False
        assert PM.distributed_client() is None
        assert PM.cluster_barrier("alone") == 0.0

    def test_double_initialize_refused(self, monkeypatch):
        monkeypatch.setattr(PM, "distributed_client", lambda: {"world": 2})
        with pytest.raises(RuntimeError, match="already initialized"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=0, device=CPU)

    def test_nccl_needs_a_card_per_process(self, monkeypatch):
        with pytest.raises(ValueError, match="NCCL reduces CUDA tensors"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=0, backend="nccl",
                                      device=CPU)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="a card per process"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=0, device="cuda")
        with pytest.raises(ValueError, match="backend must be"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=0, backend="mpi",
                                      device=CPU)

    def test_knobs_are_registered(self):
        for knob in ("PHOTON_TPU_COORDINATOR", "PHOTON_TPU_NUM_PROCESSES",
                     "PHOTON_TPU_PROCESS_ID",
                     "PHOTON_TPU_BARRIER_TIMEOUT_S"):
            assert knob in KNOB_DOCS, knob
        with pytest.raises(KeyError, match="not a declared"):
            from photon_tpu_torch.utils.env import get_raw
            get_raw("PHOTON_TPU_NOT_A_KNOB")

    def test_barrier_timeout_knob(self, monkeypatch):
        monkeypatch.setenv("PHOTON_TPU_BARRIER_TIMEOUT_S", "8")
        assert PM.barrier_timeout_s() == 8.0
        monkeypatch.setenv("PHOTON_TPU_BARRIER_TIMEOUT_S", "junk")
        assert PM.barrier_timeout_s() == 120.0


class TestLaunchValidation:
    """Argument validation — no processes are spawned."""

    def test_non_dividing_device_count(self):
        with pytest.raises(ValueError, match="does not divide"):
            launch(len, 3, total_devices=8, device=CPU)

    def test_bad_process_count(self):
        with pytest.raises(ValueError, match="n_processes"):
            launch(len, 0, device=CPU)

    def test_nccl_on_the_cpu(self):
        with pytest.raises(ValueError, match="CPU launch uses gloo"):
            launch(len, 2, device=CPU, backend="nccl")


class TestShardChunkRange:
    """The per-process chunk split the distributed cache and the
    ``local_only`` convention lean on: contiguous, in process order, an
    exact partition, the reference's own."""

    def test_union_is_exact_partition_and_matches_reference(self):
        for n_chunks in (0, 1, 7, 8, 9, 64, 1000):
            for n_proc in (1, 2, 3, 4, 8):
                spans = [CC.shard_chunk_range(n_chunks, k, n_proc)
                         for k in range(n_proc)]
                assert spans == [RCC.shard_chunk_range(n_chunks, k, n_proc)
                                 for k in range(n_proc)]
                assert spans[0][0] == 0 and spans[-1][1] == n_chunks
                for (_, a_hi), (b_lo, _) in zip(spans, spans[1:]):
                    assert a_hi == b_lo
                sizes = [hi - lo for lo, hi in spans]
                assert max(sizes) - min(sizes) <= 1
                assert sizes == sorted(sizes, reverse=True)

    def test_small_and_out_of_range(self):
        assert [CC.shard_chunk_range(2, k, 4) for k in range(4)] == \
            [(0, 1), (1, 2), (2, 2), (2, 2)]
        assert [CC.shard_chunk_range(10, k, 4) for k in range(4)] == \
            [(0, 3), (3, 6), (6, 8), (8, 10)]
        for bad in (4, -1):
            with pytest.raises(ValueError, match="out of range"):
                CC.shard_chunk_range(10, bad, 4)


# ------------------------------------------------------ one-process ingest
def _assert_rows(got, want, n_pad):
    np.testing.assert_array_equal(
        got.local().cpu().numpy()[:n_pad],
        np.asarray(want)[:n_pad])


def test_stream_to_device_mesh_matches_reference(dataset, pmesh):
    """The port's slot-sharded ingest equals the reference's 8-device
    mesh arrays row for row (padding rows weight 0), and the local_only
    mask skips the chunks whose rows no local slot owns."""
    config = sc._e2e_config()
    scan = PST.scan_ingest(str(dataset), config)
    from photon_tpu.data import feature_bags as RFB
    from photon_tpu.data import ingest as RI

    rconfig = RI.GameDataConfig(
        shards={"dense": RFB.FeatureShardConfig(bags=("f",),
                                                has_intercept=True)},
        entity_fields=("member",))
    rscan = RST.scan_ingest(str(dataset), rconfig)
    rmesh = RMesh.make_mesh(devices=jax.devices("cpu"))
    want, rn = RST.stream_to_device(str(dataset), rconfig, rscan.index_maps,
                                    mesh=rmesh, chunk_rows=300,
                                    block_index=rscan.block_index)
    telemetry.reset()
    got, n = PST.stream_to_device(str(dataset), config, scan.index_maps,
                                  mesh=pmesh, chunk_rows=300,
                                  block_index=scan.block_index,
                                  local_only=True)
    c = telemetry.snapshot()["counters"]
    assert n == rn == 1200 and c.get("ingest.chunks_skipped", 0) == 0
    for f in ("y", "weights", "offsets"):
        _assert_rows(getattr(got, f), getattr(want, f), 1200)
    _assert_rows(got.shards["dense"], want.shards["dense"], 1200)
    np.testing.assert_array_equal(got.entity_ids["member"],
                                  want.entity_ids["member"])
    # half the slots: the second half's chunk tasks are never decoded
    telemetry.reset()
    half, _ = PST.stream_to_device(str(dataset), config, scan.index_maps,
                                   mesh=pmesh, chunk_rows=300,
                                   block_index=scan.block_index,
                                   local_only=True,
                                   _local_mask=[True] * 4 + [False] * 4)
    c = telemetry.snapshot()["counters"]
    assert c["ingest.chunks_skipped"] >= 1 and c["ingest.chunks"] >= 1
    np.testing.assert_array_equal(half.y.local()[:600].numpy(),
                                  got.y.local()[:600].numpy())
    assert float(half.weights.local()[600:].sum()) == 0.0
    with pytest.raises(ValueError, match="cannot tee the chunk cache"):
        PST.stream_to_device(str(dataset), config, scan.index_maps,
                             mesh=pmesh, local_only=True, cache_dir="cc")
    with pytest.raises(ValueError, match="pass the mesh"):
        PST.stream_to_device(str(dataset), config, scan.index_maps,
                             local_only=True, device=CPU)


# ------------------------------------------------------ spawned processes
def test_psum_digest_one_value_at_1_2_4_processes(pmesh, stream_runs):
    want = sc.psum_signature(pmesh)
    for n, res in stream_runs.items():
        assert [r["rank"] for r in res] == list(range(n))
        assert all(r["n_devices"] == 8 for r in res)
        assert {r["psum_digest"] for r in res} == {want}
        # one collective (of the (1,) partial) when there is more than one
        # process; none in one
        assert all(r["collectives"] == (1 if n > 1 else 0) for r in res)
        assert all(r["wire_bytes"] == 4 * (n - 1) for r in res)
        assert all(r["backend"] == ("gloo" if n > 1 else None) for r in res)


def test_game_digest_one_value_at_1_2_4_processes(pmesh, stream_runs):
    """GAME on the mesh (`selfcheck.game_fit`: a fixed effect and a
    per-user random effect whose lanes split over the 8 slots) in the
    same launches: one digest of every table at 1, 2 and 4 processes,
    equal to the in-process mesh's bit for bit."""
    want = sc.game_fit(pmesh)["digest"]
    for n, res in stream_runs.items():
        assert {r["game_digest"] for r in res} == {want}


def test_local_only_solve_bit_identical_and_split(dataset, pmesh,
                                                  stream_runs):
    want = sc.stream_solve(dataset, pmesh)
    assert want["chunks_skipped"] == 0 and want["n_real"] == 1200
    for n, res in stream_runs.items():
        for r in res:
            assert r["n_real"] == 1200
            np.testing.assert_array_equal(r["w"], want["w"])
        if n > 1:  # the disk and decode work is partitioned
            assert all(r["chunks_decoded"] >= 1 and r["chunks_skipped"] >= 1
                       for r in res)


def test_two_process_snapshot_restores_at_1_and_4(tmp_path, pmesh,
                                                  two_process_snapshot):
    # the uninterrupted run, in this process: a session over an empty
    # directory restores nothing and changes no bit
    telemetry.reset()
    with checkpoint.session(str(tmp_path / "fresh"), every_evals=1,
                            every_s=None, async_writer=False):
        ref = sc.solve_chunked(pmesh)
    assert telemetry.snapshot()["counters"].get(
        "checkpoint.solver_restores", 0) == 0
    np.testing.assert_array_equal(ref, sc.solve_chunked(pmesh))
    for resume_n in (1, 4):
        ck = tmp_path / f"snap_{resume_n}"
        shutil.copytree(two_process_snapshot, ck)
        res = run(sc.target_resume_solve, resume_n, str(ck))
        assert len(res) == resume_n
        for r in res:
            assert r["restored"] == 1
            np.testing.assert_array_equal(r["w"], ref)


def test_reference_reads_the_two_process_snapshot(pmesh,
                                                  two_process_snapshot):
    """The carry-over format: a snapshot the port's 2-process run
    committed loads in the reference's `SnapshotStore`, and its
    `unpack_row_slots` on the 8-device JAX mesh gives back the same
    global margin caches the port's own unpack gives."""
    ck = two_process_snapshot
    snap = json.load(open(ck / "MANIFEST.json"))["latest"]
    files = sorted(os.listdir(ck / snap))
    assert {"meta_p0.json", "meta_p1.json"} <= set(files)
    assert any(f.startswith("p0_") for f in files)
    assert any(f.startswith("p1_") for f in files)
    meta1 = json.load(open(ck / snap / "meta_p1.json"))
    keys1 = [k for e in meta1["entries"].values() for k in e]
    # rank 1 wrote its own slots' row caches and nothing replicated
    assert keys1 and all("@s" in k for k in keys1)
    assert {k.split("@s")[1] for k in keys1} == {"0004", "0005", "0006",
                                                 "0007"}
    rstate, _ = RSnapshotStore(str(ck)).load_latest()
    pstate, _ = checkpoint.SnapshotStore(str(ck)).load_latest()
    (path,) = [p for p in pstate if p.endswith("lbfgs_streamed")]
    rmesh = RMesh.make_mesh(devices=jax.devices("cpu"))
    cb = sc.chunked_problem()
    pad = cb.mesh_chunk_rows(pmesh)
    for i in range(cb.n_chunks):
        want = checkpoint.unpack_row_slots(pstate[path], f"z{i}", pmesh,
                                           pad, cb.chunk_rows)
        got = RState.unpack_row_slots(rstate[path], f"z{i}", rmesh, pad,
                                      cb.chunk_rows)
        np.testing.assert_array_equal(np.asarray(got), want)
        assert np.isfinite(want).all() and np.abs(want).sum() > 0
    for key in ("w", "g", "S", "Y"):
        np.testing.assert_array_equal(np.asarray(rstate[path][key]),
                                      np.asarray(pstate[path][key]))


def test_commit_kill_is_loud_and_the_manifest_intact(tmp_path):
    ck = tmp_path / "ck"
    res = run(sc.target_commit_kill, 2, str(ck), 1, 2,
              env={"PHOTON_TPU_BARRIER_TIMEOUT_S": "8"})
    by_rank = {r["rank"]: r for r in res}
    assert by_rank[1]["outcome"] == "killed"
    assert by_rank[0]["outcome"] == "commit_failed", by_rank[0]
    assert by_rank[0]["seconds"] < 8.0 + 30.0
    store = checkpoint.SnapshotStore(str(ck))
    manifest = store.read_manifest()
    assert manifest is not None and manifest["seq"] == 0
    state, _ = store.load_latest()
    assert state and os.path.isdir(ck / manifest["latest"])


def test_a_failing_child_is_named(tmp_path):
    with pytest.raises(ChildFailure, match="rank 1: .*Error"):
        run(sc.target_stream_solve, 2, str(tmp_path / "no_such_dataset"))


def test_multi_process_sessions_snapshot_by_evaluations(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(PM, "_DIST", {"world": 2, "rank": 0})
    with pytest.raises(ValueError, match="every_s=None"):
        checkpoint.CheckpointSession(str(tmp_path / "s"))
    checkpoint.CheckpointSession(str(tmp_path / "s"), every_s=None,
                                 every_evals=1, async_writer=False).close()
