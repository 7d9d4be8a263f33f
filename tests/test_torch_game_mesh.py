"""GAME on the port's in-process 8-slot CPU mesh against the JAX package's
8-device CPU mesh (`tests/conftest.py` gives the JAX side 8 devices), on
the same numpy-seeded inputs (the GAME fixture of `test_torch_game.py`):

- `GameEstimator.fit(mesh=)`, two sweeps, with a dense fixed shard and
  with the mesh's blocked-ELL form of it (`shard_blocked_ell_batch`; the
  kernels' plain versions here) — the reference's GAME takes no
  blocked-ELL fixed shard on a resident mesh, so that case holds the
  reference's mesh fit of the same rows as `SparseRows`: objective
  histories within rtol 1e-5, coefficients
  and entity tables within rtol 1e-4 / atol 1e-5 and equal iteration
  counts (`test_torch_game.assert_same_fit`, the single-device parity
  bounds); the port's mesh fit against its one-device fit within the
  reference's own mesh-against-single bound, atol 2e-3
  (`tests/test_game.py:226-233`); scoring a sharded shard;
- `fit_game_grid(mesh=)` (the lane-axis grid through the estimator) at
  the same bounds, validation scores within 1e-5;
- `score_chunked_host(mesh=)` over dense, `SparseRows` and mesh-ladder
  chunks (rows padded to the mesh) against the reference's and the
  resident product (rtol 1e-5 / atol 1e-5), and its actionable errors;
- GAME's streamed fixed effect over a mesh ladder against the resident
  one-device fit (`tests/test_game_e2e.py:105-160`: coefficients rtol
  5e-3 / atol 1e-3, objective rtol 1e-4), its scores host numpy;
- a kill at ``bucket_retire`` on the mesh, resumed bit for bit, and the
  same fit in 2 gloo processes (`parallel.launch`) with the in-process
  mesh's bits, killed there and resumed in one process; the mesh's
  snapshot resumed on 4 slots and on one device (atol 2e-3);
- ROADMAP §C16: on GM's generator, the mesh fit against the one-device
  fit parts entity by entity only where the solves run to the f32 floor.
"""
import dataclasses

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

import test_torch_game as TG  # noqa: E402
from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.game import scoring as RGS  # noqa: E402
from photon_tpu.parallel import mesh as RMesh  # noqa: E402

from photon_tpu_torch import checkpoint, telemetry  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game import estimator as GE  # noqa: E402
from photon_tpu_torch.game import scoring as GS  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402
from photon_tpu_torch.parallel import selfcheck as sc  # noqa: E402
from photon_tpu_torch.parallel.launch import launch  # noqa: E402

CPU = "cpu"
# The reference's mesh-against-one-device bound for a GAME fit
# (tests/test_game.py:226-233).
MESH_VS_SINGLE_ATOL = 2e-3
# Chunk scoring: one matvec per slot's rows against XLA's.
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
# The streamed-against-resident GAME bounds (tests/test_game_e2e.py:
# 105-160).
STREAMED_TOL = dict(rtol=5e-3, atol=1e-3)
STREAMED_HIST_RTOL = 1e-4


@pytest.fixture(scope="module")
def rmesh():
    return RMesh.make_mesh(devices=jax.devices("cpu"))


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(n_devices=8, device=CPU)


def _ell_fixed(raw, n_shards=8):
    """The fixed shard's rows as COO (every column a slot): (the
    reference's `SparseRows`, the port's layout for an ``n_shards``-slot
    mesh, the port's one-device `BlockedEllRows`)."""
    Xf, y = raw["Xf"], raw["y"]
    n, d = Xf.shape
    ind = np.tile(np.arange(d, dtype=np.int32), (n, 1))
    pX = D.shard_blocked_ell_batch(D.make_batch(M.SparseRows(ind, Xf, d), y,
                                                device=CPU), n_shards, 2).X
    return (RM.SparseRows(ind, Xf, d), pX,
            M.to_blocked_ell(M.SparseRows(ind, Xf, d), 2, device=CPU))


def _with_fixed(ref, port, rX, pX):
    return (dataclasses.replace(ref, shards={**ref.shards, "fixed": rX}),
            dataclasses.replace(port, shards={**port.shards, "fixed": pX}))


def _tables(fit) -> dict:
    out = {}
    for name, m in fit.model.coordinates.items():
        out[name] = TG._np(m.model.weights if hasattr(m, "model")
                           else m.coefficients)
    return out


# ------------------------------------------------------------ the fits
@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_mesh_fit_matches_reference(layout, rmesh, pmesh):
    raw = TG.raw_game(n=600)
    ref, port = TG.game_pair(raw)
    single = port
    if layout == "ell":
        rX, pX, bell = _ell_fixed(raw)
        ref, port = _with_fixed(ref, port, rX, pX)
        single = dataclasses.replace(port, shards={**port.shards,
                                                   "fixed": bell})
    rest, pest = TG.estimator_pair("logistic")
    (rr,) = dataclasses.replace(rest, mesh=rmesh).fit(ref)
    telemetry.reset()
    (pr,) = dataclasses.replace(pest, mesh=pmesh).fit(port)
    c = telemetry.snapshot()["counters"]
    TG.assert_same_fit(rr, pr)
    # every bucket's lanes ran on all 8 slots, nothing fused
    assert c["game_re.slot_solves"] == 8 * c["game_re.blocks"]
    assert c["mesh.reductions"] > 0
    # against the port's own one-device fit, the reference's mesh bound
    (p1,) = pest.fit(single)
    for name, got in _tables(pr).items():
        np.testing.assert_allclose(got, _tables(p1)[name],
                                   atol=MESH_VS_SINGLE_ATOL)
    # scoring what the mesh fit returns (a sharded shard scores shard by
    # shard on the model's device)
    np.testing.assert_allclose(TG._np(GS.score_game(pr.model, port)),
                               np.asarray(RGS.score_game(rr.model, ref)),
                               rtol=1e-4, atol=1e-4)


def _gm_problem(rows=20_000, users=1_000, items=500, seed=0):
    """The GM generator of the chip script (benches/game_10m.py's shapes:
    a bf16 fixed shard of d 32, per-user and per-item shards of d 4, a
    planted logistic GAME model), cut to ``rows`` rows."""
    rng = np.random.default_rng(seed)
    w_true = (rng.normal(size=32) * 0.3).astype(np.float32)
    u_true = rng.normal(size=(users, 4)).astype(np.float32)
    i_true = rng.normal(size=(items, 4)).astype(np.float32)
    Xf = rng.normal(size=(rows, 32)).astype(np.float32)
    Xu = rng.normal(size=(rows, 4)).astype(np.float32)
    Xi = rng.normal(size=(rows, 4)).astype(np.float32)
    uid = rng.integers(0, users, size=rows)
    iid = rng.integers(0, items, size=rows)
    margin = (Xf @ w_true + np.einsum("nd,nd->n", Xu, u_true[uid])
              + np.einsum("nd,nd->n", Xi, i_true[iid]))
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)
    return GD.GameData.build(y, shards={
        "fixed": torch.from_numpy(Xf).to(torch.bfloat16), "u": Xu,
        "i": Xi}, entity_ids={"user": uid, "item": iid})


def _gm_estimator(tolerance, mesh=None):
    """GM's configuration (fixed 30 iterations at L2 1, entities 15 at
    L2 5, two sweeps) with every solve stopped at ``tolerance``."""
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    def cfg(iters, weight):
        return OptimizerConfig(max_iters=iters, reg=l2(), reg_weight=weight,
                               tolerance=tolerance)

    return GE.GameEstimator(
        task=L.TaskType.LOGISTIC_REGRESSION, n_sweeps=2, device=CPU,
        mesh=mesh, coordinate_configs={
            "fixed": GE.FixedEffectConfig("fixed", cfg(30, 1.0)),
            "per_user": GE.RandomEffectConfig("user", "u", cfg(15, 5.0)),
            "per_item": GE.RandomEffectConfig("item", "i", cfg(15, 5.0))})


# An entity is apart when a coefficient differs beyond rtol 1e-5 and 1e-5
# of its table's largest (ROADMAP §C8); at most this share may be apart
# where every solve stops at a relative progress of 1e-3 (§C8's bound).
ENTITY_RTOL, ENTITY_SHARE = 1e-5, 1e-3


def _entities_apart(want, got) -> dict:
    out = {}
    for name, a in _tables(want).items():
        if name == "fixed":
            continue
        b = _tables(got)[name]
        off = (np.abs(b - a) > ENTITY_RTOL * np.abs(a).max()
               + ENTITY_RTOL * np.abs(a)).any(axis=1)
        out[name] = (off.mean(), float(np.abs(b - a).max()))
    return out


def test_mesh_fit_parts_only_at_the_f32_floor(pmesh):
    """ROADMAP §C16 on GM's generator at 20,000 rows, 1,000 users and 500
    items. At GM's tolerance (1e-7) both fixed effects stop at the f32
    floor, a rounding apart, and the entities follow their offsets: the
    fixed effect and every entity stay within the reference's
    mesh-against-single atol 2e-3, while most entities part beyond rtol
    1e-5. With every solve stopped at 1e-3, at most 0.1% of the entities
    part (none here) and the fixed effect stays within 1e-6."""
    data = _gm_problem()
    (a,) = _gm_estimator(1e-7).fit(data)
    (b,) = _gm_estimator(1e-7, pmesh).fit(data)
    for name, t in _tables(a).items():
        np.testing.assert_allclose(_tables(b)[name], t,
                                   atol=MESH_VS_SINGLE_ATOL)
    assert all(share > 0.5 for share, _ in _entities_apart(a, b).values())
    (a,) = _gm_estimator(1e-3).fit(data)
    (b,) = _gm_estimator(1e-3, pmesh).fit(data)
    np.testing.assert_allclose(_tables(b)["fixed"], _tables(a)["fixed"],
                               atol=1e-6)
    for name, (share, _) in _entities_apart(a, b).items():
        assert share <= ENTITY_SHARE, (name, share)


def test_mesh_grid_matches_reference(rmesh, pmesh):
    """The lane-axis GAME grid on the mesh: the fixed batch row-sharded,
    each bucket's (entity × grid point) lanes split over the slots."""
    ref, port = TG.game_pair(TG.raw_game(seed=12, n=400))
    rest, pest = TG.estimator_pair(n_sweeps=1, warm_start=False)
    grids = []
    for est in (rest, pest):
        base = est.coordinate_configs["per_user"]
        grids.append([{"per_user": dataclasses.replace(
            base, optimizer=dataclasses.replace(base.optimizer,
                                                reg_weight=w))}
            for w in (1.0, 4.0)])
    rest, pest = (dataclasses.replace(rest, mesh=rmesh),
                  dataclasses.replace(pest, mesh=pmesh))
    assert pest.would_vectorize(grids[1], data=port)
    rres = rest.fit(ref, validation=ref, config_grid=grids[0])
    telemetry.reset()
    pres = pest.fit(port, validation=port, config_grid=grids[1])
    assert telemetry.snapshot()["counters"]["game.grid_vectorized_lanes"] \
        == 2
    for rr, pr in zip(rres, pres):
        TG.assert_same_fit(rr, pr)
        np.testing.assert_allclose(pr.validation_score, rr.validation_score,
                                   rtol=0, atol=1e-5)


# ------------------------------------------------------ streamed scoring
def _chunk_cases():
    rng = np.random.default_rng(31)
    n, d, k = 600, 90, 5
    ind = np.concatenate([rng.integers(0, d - 1, size=(n, k)),
                          np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, k)), np.ones((n, 1))],
                         1).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    X = np.zeros((n, d), np.float32)
    np.add.at(X, (np.arange(n)[:, None], ind), val)
    w = rng.normal(size=d).astype(np.float32)
    return ind, val, y, X, w, d


@pytest.mark.parametrize("kind", ["dense", "sparse", "ladder"])
def test_score_chunked_host_on_mesh_matches_reference(kind, rmesh, pmesh):
    """Chunks of 100 rows (13 a slot, padded) or a mesh ladder of 96-row
    chunks: every slot's margins in slot order, the padding dropped."""
    ind, val, y, X, w, d = _chunk_cases()
    if kind == "dense":
        rX, pX = RD.chunk_matrix(X, 100), D.chunk_matrix(X, 100)
    elif kind == "sparse":
        rX = RD.chunk_matrix(RM.SparseRows(ind, val, d), 100)
        pX = D.chunk_matrix(M.SparseRows(ind, val, d), 100)
    else:
        rX = RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val, d),
                                                y), 96, d_dense=8,
                                  n_shards=8).X
        pX = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, d), y,
                                              device=CPU), 96, d_dense=8,
                                 n_shards=8).X
    telemetry.reset()
    got = GS.score_chunked_host(pX, torch.from_numpy(w), mesh=pmesh)
    assert isinstance(got, np.ndarray) and got.shape == (600,)
    assert telemetry.snapshot()["counters"][
        "game_e2e.score_stream_chunks"] == pX.n_chunks
    np.testing.assert_allclose(got, RGS.score_chunked_host(rX, w, rmesh),
                               **SCORE_TOL)
    np.testing.assert_allclose(got, X @ w, **SCORE_TOL)


def test_score_chunked_host_errors(pmesh):
    ind, val, y, X, w, d = _chunk_cases()
    ladder = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, d), y,
                                              device=CPU), 96, d_dense=8,
                                 n_shards=8).X
    with pytest.raises(ValueError, match="laid for a 8-device mesh; pass "
                                         "mesh="):
        GS.score_chunked_host(ladder, w, device=CPU)
    with pytest.raises(ValueError, match="laid for 8 slot"):
        GS.score_chunked_host(ladder, w,
                              mesh=PM.make_mesh(n_devices=4, device=CPU))
    one = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, d), y,
                                           device=CPU), 96, d_dense=8).X
    with pytest.raises(ValueError, match="ONE device per chunk"):
        GS.score_chunked_host(one, w, mesh=pmesh)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        GS.score_chunked_host(one, w, mesh=object())


@pytest.mark.parametrize("kind", ["dense", "ladder"])
def test_streamed_fixed_effect_on_mesh(kind, pmesh):
    """GAME with a chunked fixed shard on the mesh (chunks streamed
    row-sharded through the mesh's upload ring, a mesh ladder shard by
    shard) against the resident fit on one device; the margins exchange
    through host caches."""
    ind, val, y, X, _, d = _chunk_cases()
    rng = np.random.default_rng(32)
    Xu = np.concatenate([rng.normal(size=(600, 3)), np.ones((600, 1))],
                        1).astype(np.float32)
    ids = {"user": (rng.zipf(1.3, size=600) - 1) % 20}
    if kind == "dense":
        chunked, resident = D.chunk_matrix(X, 100), X
    else:
        chunked = D.chunk_blocked_ell(D.make_batch(
            M.SparseRows(ind, val, d), y, device=CPU), 96, d_dense=8,
            n_shards=8).X
        resident = M.to_blocked_ell(M.SparseRows(ind, val, d), 8,
                                    device=CPU)
    _, pest = TG.estimator_pair(n_sweeps=2)
    cfgs = {k: v for k, v in pest.coordinate_configs.items()
            if k != "per_item"}
    est = dataclasses.replace(pest, coordinate_configs=cfgs)
    data = GD.GameData.build(y, {"fixed": chunked, "u": Xu}, ids)
    telemetry.reset()
    (fit,) = dataclasses.replace(est, mesh=pmesh).fit(data)
    c = telemetry.snapshot()["counters"]
    assert c["game_e2e.streamed_fixed_updates"] == 2
    assert c["game_e2e.host_offset_sums"] == 4
    assert c["game_e2e.score_stream_chunks"] >= 2 * chunked.n_chunks
    (base,) = est.fit(GD.GameData.build(y, {"fixed": resident, "u": Xu},
                                        ids))
    np.testing.assert_allclose(fit.descent.objective_history,
                               base.descent.objective_history,
                               rtol=STREAMED_HIST_RTOL)
    for name, got in _tables(fit).items():
        np.testing.assert_allclose(got, _tables(base)[name], **STREAMED_TOL)


# ------------------------------------------------------ elastic and P > 1
def test_kill_at_bucket_retire_resumes_bit_for_bit(pmesh, tmp_path):
    want = sc.game_fit(pmesh)
    for k in (1, 3):
        ck = tmp_path / f"k{k}"
        assert sc.game_fit(pmesh, "dense", str(ck), k)["killed"]
        got = sc.game_fit(pmesh, "dense", str(ck))
        assert got["restores"] >= 1
        assert got["digest"] == want["digest"]
        np.testing.assert_array_equal(got["tables"]["per_user"],
                                      want["tables"]["per_user"])


def test_mesh_snapshot_restores_on_one_device_and_another_mesh(pmesh,
                                                               tmp_path):
    """The descent's snapshot on a mesh is in global entity and row
    order: killed on 8 slots, it resumes on 4 slots and on one device
    (not bit for bit: another tree sums the fixed effect), within the
    reference's mesh-against-single bound of the uninterrupted fit."""
    want = sc.game_fit(pmesh)["tables"]
    data = sc.game_problem()
    for k, mesh in enumerate((PM.make_mesh(n_devices=4, device=CPU), None)):
        ck = tmp_path / f"m{k}"
        assert sc.game_fit(pmesh, "dense", str(ck), 3)["killed"]
        telemetry.reset()
        est = GE.GameEstimator(L.TaskType.LOGISTIC_REGRESSION,
                               sc.game_configs(), n_sweeps=2, mesh=mesh,
                               device=CPU)
        with checkpoint.session(str(ck), every_evals=1, every_s=None,
                                async_writer=False):
            (fit,) = est.fit(data)
        c = telemetry.snapshot()["counters"]
        assert c.get("checkpoint.descent_restores", 0) \
            + c.get("checkpoint.re_restores", 0) >= 1
        got = _tables(fit)
        for name, t in want.items():
            np.testing.assert_allclose(got[name], t,
                                       atol=MESH_VS_SINGLE_ATOL)


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_two_processes_give_the_in_process_bits(layout, pmesh, tmp_path):
    """2 gloo processes of 4 slots each: the same digest as the in-process
    8-slot mesh (the lanes and the gathers keep slot order); for the
    dense fit also a kill at the 2nd ``bucket_retire`` on both ranks,
    resumed in ONE process to the same bits."""
    want = sc.game_fit(pmesh, layout)["digest"]
    data = sc.game_problem(layout=layout)
    runs = launch(sc.target_game_data, 2, args=(
        data, sc.game_configs(), 2, None, None, 0), device=CPU,
        timeout_s=240)
    assert [r["digest"] for r in runs] == [want, want]
    assert all(r["collectives"] > 0 for r in runs)
    if layout == "dense":
        ck = str(tmp_path / "ck")
        killed = launch(sc.target_game_data, 2, args=(
            data, sc.game_configs(), 2, None, ck, 2), device=CPU,
            timeout_s=240)
        assert all(r["killed"] for r in killed)
        got = sc.game_fit(pmesh, layout, ck)
        assert got["restores"] >= 1 and got["digest"] == want
