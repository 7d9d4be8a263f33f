"""Elastic runs in the port (`photon_tpu_torch.checkpoint`): crash-
consistent snapshot/restore with deterministic fault injection, on the
CPU, held to the single-device cases of the reference's
`tests/test_checkpoint.py` and against the JAX package itself.

The acceptance property: a streamed L-BFGS solve killed at every kill
site (chunk upload, evaluation close, mid-snapshot-write, the commit
rename) at its first, middle and last occurrence, a streamed OWL-QN
solve, and a GAME fit (straggler budget on, ``pipeline_depth=1``) killed
at every bucket retirement and mid-write, each restored from the last
committed snapshot, finish with results EQUAL bit for bit to the
uninterrupted run's (coefficients, histories, objective history). Also:
an armed but unkilled run equals the session-less one; the store's and
session's edge cases (a newer schema refused, a re-chunked resume
refused, retention, a killed ``commit_bytes``, retry/backoff, scoping and
consumed-once restores); the resident tap; snapshot directories that
either package writes and the other loads bit for bit; killed-and-resumed
port runs against the reference's uninterrupted ones (the tolerances of
`test_torch_streamed.py` and `test_torch_game.py`); ``pipeline_depth``
0, 1 and 2 bit for bit; ``run_training(checkpoint_dir=...)`` killed and
rerun; the selftest; and every registered fault site but
``replica_dispatch`` and ``selftest_io`` hit by a path of the port.
"""
import json
import os

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import checkpoint as rckpt  # noqa: E402
from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.game import dataset as RGD  # noqa: E402
from photon_tpu.game import fixed_effect as RFE  # noqa: E402
from photon_tpu.game import random_effect as RRE  # noqa: E402
from photon_tpu.game.coordinate_descent import (  # noqa: E402
    coordinate_descent as ref_coordinate_descent)
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402

from photon_tpu_torch import checkpoint  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.checkpoint import faults  # noqa: E402
from photon_tpu_torch.checkpoint import store as pstore  # noqa: E402
from photon_tpu_torch.data.dataset import chunk_batch, make_batch  # noqa
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game.coordinate_descent import (  # noqa: E402
    coordinate_descent)
from photon_tpu_torch.game.fixed_effect import (  # noqa: E402
    FixedEffectCoordinate)
from photon_tpu_torch.game.random_effect import (  # noqa: E402
    RandomEffectCoordinate)
from photon_tpu_torch.models.training import train_glm  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim import regularization as reg  # noqa: E402
from photon_tpu_torch.optim.config import (OptimizerConfig,  # noqa: E402
                                           OptimizerType)

CPU = "cpu"
TASK = TaskType.LOGISTIC_REGRESSION
# tolerance=0 forces the full iteration budget: the kill/restore matrix
# then exercises mid-run cuts, not an early-converged triviality
CFG = OptimizerConfig(max_iters=10, tolerance=0.0, reg=reg.l2(),
                      reg_weight=1e-2, history=4)
# the registered KILL sites of a streamed solve (snapshot_io is a retry
# site, not a kill site)
KILL_SITES = ("chunk_upload", "evaluation", "snapshot_write", "commit")
# against the reference: `test_torch_streamed.py`'s histories and its
# streamed-equals-resident coefficients; `test_torch_game.py`'s
# coefficients (its entity solves stop at 1e-3)
HIST_RTOL = 1e-5
S_W_RTOL, S_W_ATOL = 2e-3, 2e-5
G_W_RTOL, G_W_ATOL = 1e-4, 1e-5


def _stream_xy(n=96, d=5):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def _stream_data(chunk_rows=32):
    X, y = _stream_xy()
    return chunk_batch(make_batch(X, y, device=CPU), chunk_rows)


@pytest.fixture(scope="module")
def cb():
    return _stream_data()


def _solve(cb, cfg=CFG):
    _, res = train_glm(cb, TASK, cfg, device=CPU)
    return res


def _w(res) -> np.ndarray:
    return res.w.numpy().astype(np.float64)


def _same_result(want, got, label="") -> None:
    np.testing.assert_array_equal(_w(want), _w(got), err_msg=label)
    np.testing.assert_array_equal(want.loss_history.numpy(),
                                  got.loss_history.numpy(), err_msg=label)
    np.testing.assert_array_equal(want.grad_norm_history.numpy(),
                                  got.grad_norm_history.numpy(),
                                  err_msg=label)
    assert (want.iterations, want.evaluations, want.trials) == \
        (got.iterations, got.evaluations, got.trials), label


def _kill_then_resume(ckdir, run_fn, site, occ, async_writer=False):
    """Arm (site, occ), run; on the injected kill, resume from the last
    committed snapshot. Returns (result, was_killed)."""
    try:
        with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                                async_writer=async_writer):
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at(site, occ)):
                return run_fn(), False
    except checkpoint.InjectedFault:
        pass
    with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                            async_writer=async_writer):
        return run_fn(), True


def _occurrences(n):
    """First / middle / last — the spread each site is killed at."""
    return sorted({1, (n + 1) // 2, n})


# ------------------------------------------------------------- streamed GLM
def test_armed_but_unkilled_run_is_bit_identical(cb, tmp_path):
    """Checkpointing observes and never perturbs: a run that snapshots at
    every evaluation equals the session-less run bit for bit."""
    ref = _solve(cb)
    for async_writer in (False, True):
        with checkpoint.session(str(tmp_path / f"ck{async_writer}"),
                                every_evals=1, every_s=None,
                                async_writer=async_writer):
            _same_result(ref, _solve(cb))


@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_every_site_resume_bit_identical(cb, tmp_path, site):
    """Every kill site at its first, middle and last occurrence restores
    and finishes bit for bit, kills during a snapshot write and the commit
    rename included (restore falls back to the previous manifest)."""
    ref = _solve(cb)
    with checkpoint.session(str(tmp_path / "rec"), every_evals=1,
                            every_s=None, async_writer=False):
        with checkpoint.record_sites() as rec:
            _solve(cb)
    n = rec.hits.get(site, 0)
    assert n > 0, f"site {site} never hit"
    for occ in _occurrences(n):
        res, killed = _kill_then_resume(tmp_path / f"{site}_{occ}",
                                        lambda: _solve(cb), site, occ)
        assert killed, (site, occ)
        _same_result(ref, res, f"drift after a kill at {site}#{occ}")


def test_empty_history_resume_at_it0_equals_cold_start(cb, tmp_path):
    """Evaluation #1 is the initial pass (snapshotted at it=0), #2 the
    first direction pass: killed there, the restored state has an EMPTY
    curvature history and replays the whole solve."""
    ref = _solve(cb)
    ckdir = tmp_path / "it0"
    telemetry.reset()
    res, killed = _kill_then_resume(ckdir, lambda: _solve(cb),
                                    "evaluation", 2)
    assert killed
    assert checkpoint.SnapshotStore(str(ckdir)).latest_seq() >= 0
    assert telemetry.snapshot()["counters"][
        "checkpoint.solver_restores"] == 1
    _same_result(ref, res)


def test_async_writer_kill_resume(cb, tmp_path):
    """Snapshots committed on the writer thread: a kill mid-run restores
    bit for bit, and the session's close drains the queue."""
    ref = _solve(cb)
    res, killed = _kill_then_resume(tmp_path / "async", lambda: _solve(cb),
                                    "evaluation", 9, async_writer=True)
    assert killed
    _same_result(ref, res)


def test_owlqn_streamed_kill_resume(cb, tmp_path):
    cfg = OptimizerConfig(max_iters=8, tolerance=0.0, reg=reg.l1(),
                          reg_weight=1e-3, history=4)
    ref = _solve(cb, cfg)
    for site, occ in (("evaluation", 5), ("chunk_upload", 9)):
        res, killed = _kill_then_resume(tmp_path / f"owlqn_{site}",
                                        lambda: _solve(cb, cfg), site, occ)
        assert killed, site
        _same_result(ref, res, site)


def test_resumed_streamed_solves_match_the_reference(cb, tmp_path):
    """The port killed and resumed against the reference's uninterrupted
    streamed solve on the same chunks: equal iterations, histories within
    rtol 1e-5, coefficients within the streamed tolerance."""
    X, y = _stream_xy()
    rcb = RD.chunk_batch(RD.make_batch(X, y), 32)
    for name, rcfg, pcfg in (
            ("lbfgs", RConfig(max_iters=10, tolerance=0.0, reg=RReg.l2(),
                              reg_weight=1e-2, history=4), CFG),
            ("owlqn", RConfig(max_iters=8, tolerance=0.0, reg=RReg.l1(),
                              reg_weight=1e-3, history=4),
             OptimizerConfig(max_iters=8, tolerance=0.0, reg=reg.l1(),
                             reg_weight=1e-3, history=4))):
        _, rr = RT.train_glm(rcb, RL.TaskType.LOGISTIC_REGRESSION, rcfg)
        res, killed = _kill_then_resume(tmp_path / name,
                                        lambda: _solve(cb, pcfg),
                                        "evaluation", 6)
        assert killed, name
        assert res.iterations == int(rr.iterations), name
        rh = np.asarray(rr.loss_history)
        np.testing.assert_allclose(res.history(), rh[~np.isnan(rh)],
                                   rtol=HIST_RTOL, err_msg=name)
        np.testing.assert_allclose(_w(res), np.asarray(rr.w),
                                   rtol=S_W_RTOL, atol=S_W_ATOL,
                                   err_msg=name)


# -------------------------------------------------------------------- GAME
def _game_arrays():
    rng = np.random.default_rng(3)
    E, d = 13, 4
    rows = rng.integers(3, 28, size=E)
    ent = np.repeat(np.arange(E), rows)
    rng.shuffle(ent)
    n = ent.shape[0]
    Xr = rng.normal(size=(n, d)).astype(np.float32)
    Xf = rng.normal(size=(n, 3)).astype(np.float32)
    w_re = rng.normal(size=(E, d)) * 1.5
    logit = np.einsum("nd,nd->n", Xr, w_re[ent]) + \
        Xf @ np.array([0.5, -0.3, 0.2])
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return y, {"s": Xr, "fx": Xf}, {"e": ent.astype(np.int64)}


def _game_problem(tolerance=1e-7):
    """The reference test's GAME problem: a fixed effect and a per-entity
    effect in 2 buckets, straggler budgeting on (the pipelined block loop
    runs, the re-solve inside each retire), 2 sweeps. Returns run(depth)."""
    y, shards, ids = _game_arrays()
    data = GD.GameData.build(y, shards, ids)
    ds = GD.RandomEffectDataset.build(data, "e", "s", max_blocks=2,
                                      device=CPU)
    fe = GD.FixedEffectDataset.build(data, "fx", device=CPU)
    cfg = OptimizerConfig(max_iters=30, tolerance=tolerance, reg=reg.l2(),
                          reg_weight=0.5, history=4)

    def run(depth=1):
        coords = {
            "fixed": FixedEffectCoordinate(fe, TASK, cfg),
            "re": RandomEffectCoordinate(ds, TASK, cfg,
                                         pipeline_depth=depth,
                                         straggler_budget=8),
        }
        return coordinate_descent(coords, data.y, data.weights,
                                  np.zeros(data.n, np.float32), TASK,
                                  n_sweeps=2)

    return run


def _game_w(out):
    return (out.model.coordinates["fixed"].model.coefficients.means
            .numpy().astype(np.float64),
            out.model.coordinates["re"].coefficients.numpy()
            .astype(np.float64))


def _same_game(ref, got, label=""):
    for a, b in zip(_game_w(ref), _game_w(got)):
        np.testing.assert_array_equal(a, b, err_msg=label)
    assert ref.objective_history == got.objective_history, label
    for name in ("fixed", "re"):
        assert len(ref.coordinate_stats[name]) == \
            len(got.coordinate_stats[name]), label


def test_game_kill_every_site_resume_bit_identical(tmp_path):
    """Killed at EVERY bucket retirement plus mid-snapshot-write and
    mid-commit, each resume finishes bit for bit (coefficients and
    objective history) with the descent's and the block loop's restores
    counted."""
    run = _game_problem()
    ref = run()
    with checkpoint.session(str(tmp_path / "rec"), every_evals=1,
                            every_s=None, async_writer=False):
        with checkpoint.record_sites() as rec:
            armed = run()
    _same_game(ref, armed, "armed")
    counts = dict(rec.hits)
    assert counts.get("bucket_retire", 0) >= 4  # 2 blocks x 2 sweeps
    matrix = [("bucket_retire", occ)
              for occ in range(1, counts["bucket_retire"] + 1)]
    matrix += [("snapshot_write", _occurrences(counts["snapshot_write"])[1]),
               ("commit", _occurrences(counts["commit"])[1])]
    restores = {"checkpoint.descent_restores": 0,
                "checkpoint.re_restores": 0}
    for site, occ in matrix:
        telemetry.reset()
        out, killed = _kill_then_resume(tmp_path / f"{site}_{occ}", run,
                                        site, occ)
        assert killed, (site, occ)
        _same_game(ref, out, f"drift at {site}#{occ}")
        c = telemetry.snapshot()["counters"]
        for k in restores:
            restores[k] += c.get(k, 0)
    assert restores["checkpoint.re_restores"] >= 2
    assert restores["checkpoint.descent_restores"] >= len(matrix) - 1


@pytest.mark.parametrize("depth", [0, 2])
def test_pipeline_depth_is_bit_identical(depth):
    """Buckets partition the entity set: dispatch running ahead of retire
    by any depth gives the depth-1 bits."""
    run = _game_problem()
    want = run(1)
    telemetry.reset()
    _same_game(want, run(depth), f"depth {depth}")
    # 2 buckets: depth 0 holds one in flight, depth 2 both
    assert telemetry.snapshot()["gauges"]["game_re.blocks_in_flight"] == \
        min(depth + 1, 2)


def test_resumed_game_fit_matches_the_reference(tmp_path):
    """A port GAME fit killed at a bucket retirement and resumed against
    the reference's uninterrupted `coordinate_descent` on the same data
    (entity solves stopped at 1e-3, as `test_torch_game.py` stops them):
    objective histories within rtol 1e-5, coefficients within rtol 1e-4
    (atol 1e-5)."""
    y, shards, ids = _game_arrays()
    rdata = RGD.GameData.build(y, shards, ids)
    rds = RGD.RandomEffectDataset.build(rdata, "e", "s", max_blocks=2)
    rfe = RGD.FixedEffectDataset(X=rdata.shards["fx"], y=rdata.y,
                                 weights=rdata.weights, shard_name="fx")
    rcfg = RConfig(max_iters=30, tolerance=1e-3, reg=RReg.l2(),
                   reg_weight=0.5, history=4)
    rtask = RL.TaskType.LOGISTIC_REGRESSION
    rout = ref_coordinate_descent(
        {"fixed": RFE.FixedEffectCoordinate(rfe, rtask, rcfg),
         "re": RRE.RandomEffectCoordinate(rds, rtask, rcfg,
                                          pipeline_depth=1,
                                          straggler_budget=8)},
        rdata.y, rdata.weights, np.zeros(rdata.n, np.float32), rtask,
        n_sweeps=2)
    out, killed = _kill_then_resume(tmp_path / "vs_ref",
                                    _game_problem(1e-3), "bucket_retire", 3)
    assert killed
    np.testing.assert_allclose(out.objective_history,
                               [float(v) for v in rout.objective_history],
                               rtol=HIST_RTOL)
    wf, wr = _game_w(out)
    np.testing.assert_allclose(
        wf, np.asarray(rout.model.coordinates["fixed"].model.coefficients
                       .means), rtol=G_W_RTOL, atol=G_W_ATOL)
    np.testing.assert_allclose(
        wr, np.asarray(rout.model.coordinates["re"].coefficients),
        rtol=G_W_RTOL, atol=G_W_ATOL)


def test_re_snapshot_that_does_not_fit_is_refused(tmp_path):
    """A random-effect snapshot whose (kind, E, d, n_blocks, has_var)
    differs from the resuming coordinate's is refused, not resumed."""
    y, shards, ids = _game_arrays()
    data = GD.GameData.build(y, shards, ids)
    ds = GD.RandomEffectDataset.build(data, "e", "s", max_blocks=2,
                                      device=CPU)
    s = checkpoint.CheckpointSession(str(tmp_path / "s"), async_writer=False)
    s.update("re", {"kind": "re_train", "E": 99, "d": 4, "n_blocks": 2,
                    "has_var": False})
    s.snapshot()
    s.close()
    coord = RandomEffectCoordinate(ds, TASK, OptimizerConfig(max_iters=5))
    with checkpoint.session(str(tmp_path / "s"), async_writer=False):
        with pytest.raises(checkpoint.SnapshotStateError, match="n_blocks"):
            coord.train(np.zeros(data.n, np.float32))


# ----------------------------------------------------- store / state layer
def test_newer_schema_rejected_with_clear_error(cb, tmp_path):
    ckdir = tmp_path / "newer"
    with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                            async_writer=False):
        _solve(cb)
    mpath = ckdir / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    manifest["schema"] = checkpoint.SCHEMA_VERSION + 1
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(checkpoint.SnapshotSchemaError, match="newer"):
        checkpoint.CheckpointSession(str(ckdir), async_writer=False)


def test_state_shape_mismatch_rejected(cb, tmp_path):
    """A snapshot fits only the program that wrote it: re-chunking the
    dataset is refused with the mismatch spelled out."""
    ckdir = tmp_path / "mismatch"
    with pytest.raises(checkpoint.InjectedFault):
        with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                                async_writer=False):
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at("evaluation", 5)):
                _solve(cb)
    with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                            async_writer=False):
        with pytest.raises(checkpoint.SnapshotStateError, match="chunk"):
            _solve(_stream_data(chunk_rows=16))


def test_retention_keeps_newest(cb, tmp_path):
    ckdir = tmp_path / "gc"
    with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                            async_writer=False, keep=2):
        _solve(cb)
    snaps = sorted(d for d in os.listdir(ckdir) if d.startswith("snap_"))
    assert 1 <= len(snaps) <= 2
    store = checkpoint.SnapshotStore(str(ckdir))
    assert f"snap_{store.latest_seq():08d}" == snaps[-1]


def test_commit_bytes_kill_leaves_old_content(tmp_path):
    path = tmp_path / "blob"
    checkpoint.commit_bytes(str(path), b"generation-1")
    with pytest.raises(checkpoint.InjectedFault):
        with checkpoint.fault_plan(checkpoint.FaultPlan.kill_at("commit", 1)):
            checkpoint.commit_bytes(str(path), b"generation-2")
    assert path.read_bytes() == b"generation-1"
    checkpoint.commit_bytes(str(path), b"generation-2")
    assert path.read_bytes() == b"generation-2"


def test_retry_io_backoff_and_snapshot_reads(tmp_path):
    """Injected transient errors at ``snapshot_io`` are absorbed by the
    store's reads and writes; the backoff is exponential and counted."""
    delays = []
    telemetry.reset()
    with checkpoint.fault_plan(checkpoint.FaultPlan(errors={"s": 3})):
        out = checkpoint.retry_io(lambda: 42, site="s", base_delay=0.01,
                                  sleep=delays.append)
    assert out == 42 and delays == [0.01, 0.02, 0.04]
    c = telemetry.snapshot()["counters"]
    assert c["faults.io_retries"] == 3 and c["faults.injected_errors"] == 3
    store = checkpoint.SnapshotStore(str(tmp_path / "io"))
    with checkpoint.fault_plan(checkpoint.FaultPlan(
            errors={"snapshot_io": 2})):
        store.commit({"a": {"x": np.arange(3, dtype=np.float32)}}, 0)
        state, _ = store.load_latest()
    np.testing.assert_array_equal(state["a"]["x"], np.arange(3))


def test_async_writer_error_raises_at_the_next_call(tmp_path):
    s = checkpoint.CheckpointSession(str(tmp_path / "w"), async_writer=True)
    s.update("x", {"v": np.ones(2, np.float32)})
    with checkpoint.fault_plan(checkpoint.FaultPlan.kill_at("commit", 1)):
        s.snapshot()  # the writer thread dies at its commit
        with pytest.raises(checkpoint.InjectedFault):
            s.snapshot(block=True)
    s.close()


def test_multi_process_and_mesh_forms_raise_item_10(tmp_path, monkeypatch):
    """The mesh forms (ported; they raised before): row caches pack per
    slot and re-slice onto another mesh, and a rank other than 0 writes
    only its slot-keyed entries (rank 0 the replicated ones and the
    manifest)."""
    from photon_tpu_torch.parallel import mesh as PM

    m8 = PM.make_mesh(n_devices=8, device="cpu")
    m4 = PM.make_mesh(n_devices=4, device="cpu")
    rows = np.arange(16, dtype=np.float32)
    local = rows.reshape(8, 2)
    np.testing.assert_array_equal(checkpoint.pack_rows(local, m8, 15),
                                  rows[:15])
    packed = checkpoint.pack_row_slots(local, m8, 15, "z0")
    assert sorted(packed) == [f"z0@s{j:04d}" for j in range(8)]
    np.testing.assert_array_equal(
        checkpoint.unpack_row_slots(packed, "z0", m4, 16, 15),
        np.concatenate([rows[:15], [0.0]]).reshape(4, 4))
    monkeypatch.setattr(pstore, "_process_index", lambda: 1)
    store = checkpoint.SnapshotStore(str(tmp_path / "mp"))
    store.commit({"s": {"w": np.ones(3, np.float32), "z0@s0004":
                        np.zeros(2, np.float32), "it": 3}}, 0)
    meta = json.load(open(tmp_path / "mp" / "snap_00000000" /
                          "meta_p1.json"))
    assert list(meta["entries"]["s"]) == ["z0@s0004"]
    assert store.read_manifest() is None  # rank 0 commits the manifest


def test_row_slots_v1_and_multi_slot_payloads_restore_on_one_device():
    """Schema v2 slot entries written by a multi-slot run concatenate
    slot-major onto one device; a v1 single-key payload still reads."""
    rows = np.arange(10, dtype=np.float32)
    payload = {"z0@s0001": rows[5:], "z0@s0000": rows[:5]}
    np.testing.assert_array_equal(
        checkpoint.unpack_row_slots(payload, "z0", None, 12, 10),
        np.concatenate([rows, np.zeros(2, np.float32)]))
    np.testing.assert_array_equal(
        checkpoint.unpack_row_slots({"z0": rows}, "z0", None, 10, 10), rows)
    packed = checkpoint.pack_row_slots(torch.from_numpy(rows), None, 7, "z1")
    assert list(packed) == ["z1@s0000"]
    np.testing.assert_array_equal(packed["z1@s0000"].numpy(), rows[:7])
    np.testing.assert_array_equal(checkpoint.pack_rows(rows, None, 4),
                                  rows[:4])
    with pytest.raises(checkpoint.SnapshotStateError, match="row-slot"):
        checkpoint.unpack_row_slots({}, "z0", None, 4, 4)


def test_seeded_fault_plan_is_deterministic():
    counts = {"evaluation": 12, "chunk_upload": 30}
    a = checkpoint.FaultPlan.seeded(5, counts)
    b = checkpoint.FaultPlan.seeded(5, counts)
    assert a.kills == b.kills and len(a.kills) == 1


# ----------------------------------------------------- across the packages
def _state():
    rng = np.random.default_rng(11)
    return {
        "solver/lbfgs_streamed": {
            "w": rng.normal(size=7).astype(np.float32),
            "S": rng.normal(size=(3, 7)).astype(np.float32),
            "hist": np.array([1.5, np.nan], np.float32),
            "iters": np.arange(4, dtype=np.int64),
            "conv": np.array([True, False]),
            "it": 3, "f": 0.6931471805599453, "done": False,
            "kind": "lbfgs_streamed", "objective": [1.0, 0.5]},
        "game-abc-0/progress": {"n_done": 2, "s.re": np.ones(5, np.float32)},
    }


def _states_equal(want, got):
    assert set(want) == set(got)
    for path, payload in want.items():
        assert set(payload) == set(got[path]), path
        for k, v in payload.items():
            g = got[path][k]
            if isinstance(v, np.ndarray):
                assert np.asarray(g).dtype == v.dtype, (path, k)
                np.testing.assert_array_equal(np.asarray(g), v)
            else:
                assert g == v, (path, k)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_directories_load_across_packages(tmp_path, writer):
    """A snapshot directory either package's `SnapshotStore` commits loads
    in the other's bit for bit (arrays, dtypes and inline values)."""
    W, R = ((rckpt.SnapshotStore, checkpoint.SnapshotStore)
            if writer == "reference"
            else (checkpoint.SnapshotStore, rckpt.SnapshotStore))
    root = str(tmp_path / "snap")
    W(root).commit(_state(), 0)
    W(root).commit(_state(), 1)
    assert R(root).latest_seq() == 1
    state, manifest = R(root).load_latest()
    assert manifest["schema"] == checkpoint.SCHEMA_VERSION == \
        rckpt.SCHEMA_VERSION
    _states_equal(_state(), state)


def test_reference_session_reads_a_port_solver_snapshot(cb, tmp_path):
    """A port session's streamed-solver snapshot opens in the reference's
    session with its keys, shapes and cursor (the layout is shared)."""
    ckdir = str(tmp_path / "x")
    with pytest.raises(checkpoint.InjectedFault):
        with checkpoint.session(ckdir, every_evals=1, every_s=None,
                                async_writer=False):
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at("evaluation", 6)):
                _solve(cb)
    s = rckpt.CheckpointSession(ckdir, async_writer=False)
    st = s.restore("lbfgs_streamed")
    s.close()
    assert st["kind"] == "lbfgs_streamed" and st["n_chunks"] == 3
    assert np.asarray(st["S"]).shape == (4, 5)
    for i in range(3):
        assert np.asarray(st[f"z{i}@s0000"]).shape == (32,)
    z = rckpt.unpack_row_slots(st, "z1", None, 32, 32)
    assert z.dtype == np.float32 and np.isfinite(z).all()


# ------------------------------------------------------------ resident tap
def test_resident_tap_captures_last_iterate_and_restores(tmp_path):
    rng = np.random.default_rng(1)
    n, d = 48, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    batch = make_batch(X, y, device=CPU)
    cfg = OptimizerConfig(max_iters=4, reg=reg.l2(), reg_weight=0.3,
                          history=3)
    ckdir = tmp_path / "resident"
    _, off = train_glm(batch, TASK, cfg, device=CPU)
    with checkpoint.session(str(ckdir), every_evals=None, every_s=None,
                            async_writer=False) as sess:
        _, quiet = train_glm(batch, TASK, cfg, device=CPU)
        assert not any(k.startswith("resident/") for k in sess._state)
    assert torch.equal(off.w, quiet.w)
    with checkpoint.session(str(ckdir), every_evals=None, every_s=None,
                            async_writer=False, resident_tap=True) as sess:
        assert checkpoint.snapshot_tap_enabled()
        _, res = train_glm(batch, TASK, cfg, device=CPU)
        cap = sess._state["resident/lbfgs_margin"]
        assert int(cap["it"]) == res.iterations
        assert torch.equal(cap["w"], res.w)
        with checkpoint.snapshot_tap_disabled():
            assert not checkpoint.snapshot_tap_enabled()
        tron = dataclasses_replace(cfg, optimizer=OptimizerType.TRON)
        _, tres = train_glm(batch, TASK, tron, device=CPU)
        tcap = sess._state["resident/tron_margin"]
        assert int(tcap["it"]) == tres.iterations
        assert float(tcap["aux"]) > 0.0  # the trust radius
        sess.snapshot(block=True)
    assert not checkpoint.snapshot_tap_enabled()  # disarmed at close
    with checkpoint.session(str(ckdir), async_writer=False):
        got = checkpoint.resident_restore("lbfgs_margin")
        assert checkpoint.resident_restore("lbfgs_margin") is None
    assert got is not None and np.asarray(got["w"]).shape == (d,)
    np.testing.assert_array_equal(np.asarray(got["w"]), res.w.numpy())
    assert checkpoint.resident_restore("lbfgs_margin") is None  # no session


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


# ------------------------------------------------------------- session API
def test_scope_paths_and_consumed_once_restore(tmp_path):
    s = checkpoint.CheckpointSession(str(tmp_path / "s"), async_writer=False)
    with s.scope("a"):
        with s.scope("b"):
            s.update("leaf", {"v": 1, "t": torch.arange(3)})
            assert s.path("leaf") == "a/b/leaf"
    assert "a/b/leaf" in s._state
    assert s.invocation("fp") == 0 and s.invocation("fp") == 1
    s.snapshot()
    s2 = checkpoint.CheckpointSession(str(tmp_path / "s"),
                                      async_writer=False)
    assert s2.restored_any()
    with s2.scope("a"), s2.scope("b"):
        got = s2.restore("leaf")
        assert got["v"] == 1
        np.testing.assert_array_equal(got["t"], np.arange(3))
        assert s2.restore("leaf") is None  # consumed once
    s.close()
    s2.close()


def test_update_copies_by_value(tmp_path):
    """The cut's values, whatever the contributor mutates afterwards."""
    s = checkpoint.CheckpointSession(str(tmp_path / "v"), async_writer=False)
    t, a = torch.zeros(3), np.zeros(3, np.float32)
    s.update("x", {"t": t, "a": a})
    t += 1.0
    a += 1.0
    s.snapshot()
    s.close()
    state, _ = checkpoint.SnapshotStore(str(tmp_path / "v")).load_latest()
    np.testing.assert_array_equal(state["x"]["t"], np.zeros(3))
    np.testing.assert_array_equal(state["x"]["a"], np.zeros(3))


def test_clear_prefix_drops_subtree(tmp_path):
    s = checkpoint.CheckpointSession(str(tmp_path / "s"), async_writer=False)
    with s.scope("u0"):
        s.update("re", {"v": 1})
        s.update("other", {"v": 2})
    s.update("progress", {"v": 3})
    s.clear("u0", prefix=True)
    assert set(s._state) == {"progress"}
    s.close()


# ---------------------------------------------------------------- the driver
def _write_job(root):
    from photon_tpu_torch.data.avro_io import write_avro
    from photon_tpu_torch.data.ingest import training_example_schema

    rng = np.random.default_rng(5)
    n, n_users = 400, 8
    user = rng.integers(0, n_users, n)
    age, ctr = rng.normal(size=n), rng.normal(size=n)
    margin = 1.2 * age - 0.8 * ctr + np.linspace(-1.5, 1.5, n_users)[user]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    schema = training_example_schema(feature_bags=("global", "puser"),
                                     entity_fields=("userId",))
    write_avro(root / "train.avro", [{
        "response": float(y[i]), "offset": None, "weight": None,
        "uid": f"row{i}", "userId": f"u{user[i]}",
        "global": [{"name": "age", "term": "", "value": float(age[i])},
                   {"name": "ctr", "term": "", "value": float(ctr[i])}],
        "puser": [{"name": "bias", "term": "", "value": 1.0}],
    } for i in range(n)], schema, block_records=100)
    return str(root / "train.avro")


def test_run_training_killed_and_rerun_saves_the_same_model(tmp_path):
    from photon_tpu_torch import drivers as PD
    from photon_tpu_torch.data import model_io

    path = _write_job(tmp_path)
    shards = {"fixedShard": {"bags": ["global"], "has_intercept": True},
              "userShard": {"bags": ["puser"], "has_intercept": False}}
    coords = {
        "fixed": {"feature_shard": "fixedShard", "reg_type": "l2",
                  "reg_weight": 0.5, "max_iters": 20},
        "perUser": {"feature_shard": "userShard", "entity_name": "userId",
                    "reg_type": "l2", "reg_weight": 2.0, "max_iters": 20,
                    "reg_weights": [1.0, 4.0]}}

    def params(out, **kw):
        return PD.TrainingParams(
            train_path=path, output_dir=str(out), feature_shards=shards,
            coordinates=coords, entity_fields=["userId"], n_sweeps=2, **kw)

    plain = PD.run_training(params(tmp_path / "plain"), device=CPU)
    ck = dict(checkpoint_dir="ck", checkpoint_every_s=None,
              checkpoint_every_evals=1, checkpoint_async=False)
    with pytest.raises(checkpoint.InjectedFault):
        with checkpoint.fault_plan(
                checkpoint.FaultPlan.kill_at("bucket_retire", 3)):
            PD.run_training(params(tmp_path / "o", **ck), device=CPU)
    assert checkpoint.current() is None  # the driver closed its session
    assert checkpoint.SnapshotStore(
        str(tmp_path / "o" / "ck")).latest_seq() >= 0
    telemetry.reset()
    again = PD.run_training(params(tmp_path / "o", **ck), device=CPU)
    assert telemetry.snapshot()["counters"][
        "checkpoint.descent_restores"] >= 1
    a, _ = model_io.load_game_model(plain.model_dir, device=CPU)
    b, _ = model_io.load_game_model(again.model_dir, device=CPU)
    for name in ("fixed", "perUser"):
        ma, mb = a.coordinates[name], b.coordinates[name]
        ta = (ma.model.coefficients.means if name == "fixed"
              else ma.coefficients)
        tb = (mb.model.coefficients.means if name == "fixed"
              else mb.coefficients)
        assert torch.equal(ta, tb), name


def test_selftest_passes_on_the_cpu():
    from photon_tpu_torch.checkpoint.__main__ import main, selftest

    report = selftest("cpu")
    assert report["ok"], report
    assert main(["--selftest", "--device", "cpu", "--json"]) == 0


# ------------------------------------------------------------- fault sites
def test_every_registered_site_is_hit_by_a_port_path(cb, tmp_path):
    """A small streamed solve, a GAME fit with a budget, a checkpointed
    snapshot and restore, an ingest-plane read through a cache, a served
    batch, a published and opened store together hit every registered
    fault site but ``replica_dispatch`` (the fleet, not ported) and
    ``selftest_io`` (the selftest's own)."""
    from photon_tpu_torch import continual, serving
    from photon_tpu_torch.convert import game_model_from_arrays
    from photon_tpu_torch.data import ingest_plane, streaming
    from photon_tpu_torch.data.feature_bags import FeatureShardConfig
    from photon_tpu_torch.data.ingest import GameDataConfig

    path = _write_job(tmp_path)
    cfg = GameDataConfig(
        shards={"g": FeatureShardConfig(bags=("global",),
                                        has_intercept=True)},
        entity_fields=("userId",))
    rng = np.random.default_rng(2)
    keys = np.asarray(["u0", "u1", "u2"])
    model = game_model_from_arrays(TASK, {
        "fixed": {"type": "fixed", "feature_shard": "g",
                  "means": rng.normal(size=3)},
        "perUser": {"type": "random", "feature_shard": "p",
                    "entity_name": "userId", "entity_keys": keys,
                    "coefficients": rng.normal(size=(3, 2))}}, device=CPU)
    with checkpoint.record_sites() as rec:
        with checkpoint.session(str(tmp_path / "ck"), every_evals=1,
                                every_s=None, async_writer=False):
            _solve(cb)
            _game_problem()()
        with checkpoint.session(str(tmp_path / "ck"), async_writer=False):
            _solve(cb)  # restores the finished solve's last cut
        scan = streaming.scan_ingest(path, cfg)
        for _ in range(2):  # a cache build through 2 workers, then a hit
            _, chunks = ingest_plane.open_chunk_source(
                path, cfg, scan.index_maps, chunk_rows=128, workers=2,
                mode="thread", cache_dir=str(tmp_path / "cache"),
                block_index=scan.block_index)
            assert sum(c.n for c in chunks) == 400
        store = serving.CoefficientStore.from_game_model(model, device=CPU)
        continual.swap.publish_store(str(tmp_path / "serve"), store)
        live, _ = continual.swap.open_current(str(tmp_path / "serve"),
                                              device=CPU)
        ladder = serving.ProgramLadder(live, floor=8, max_batch=8)
        disp = serving.MicroBatchDispatcher(ladder, max_delay_us=1000)
        try:
            score = disp.score(serving.ScoreRequest(
                features={"g": np.ones(3, np.float32),
                          "p": np.ones(2, np.float32)},
                entities={"userId": "u1"}), timeout=60)
        finally:
            disp.close()
    assert np.isfinite(score)
    hit = {s for s, n in rec.hits.items() if n > 0}
    want = set(faults.FAULT_SITES) - {"replica_dispatch", "selftest_io"}
    assert want <= hit, sorted(want - hit)
