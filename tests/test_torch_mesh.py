"""The port's in-process mesh (8 CPU slots) against the JAX package's
8-device CPU mesh (`tests/conftest.py` gives the JAX side 8 devices).

On the same numpy-seeded inputs: row sharding (`shard_rows`,
`fetch_local_rows`, `shard_local_rows`, `shard_stacked`) bit for bit; the
sharded blocked-ELL X passes at 1 and 8 lanes (rtol 1e-5 / atol 1e-5: a
slot's sums in another order, then the slot tree); `train_glm(mesh=)`
with L-BFGS, OWL-QN and TRON on `SparseRows` and the mesh blocked-ELL
form at a padded row count, `train_glm_grid(mesh=)`,
`train_glm_streamed(mesh=)` (dense chunks and a mesh ladder, with
normalization) and `FeatureSummary.compute(mesh=)`, each against the
reference's mesh solve AND the port's single-device one at the
reference's own bounds (`tests/test_training.py:34-35,47`: final value
rtol 1e-5, coefficients atol 1e-4, 5e-4 with padding rows); one reduction
per evaluation and per line-search trial, counted; one kernel plan per
slot (resident) and per (ring slot, mesh slot) (streamed). The port runs
on the CPU (its kernels' plain versions, or their emulated launches).
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

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.data import normalization as RN  # noqa: E402
from photon_tpu.data.statistics import FeatureSummary as RFS  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402
from photon_tpu.parallel import mesh as RMesh  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data import normalization as N  # noqa: E402
from photon_tpu_torch.data.statistics import FeatureSummary  # noqa: E402
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402

CPU = "cpu"
LOGISTIC = L.TaskType.LOGISTIC_REGRESSION
# The reference's mesh-against-one-device bounds (tests/test_training.py:
# 34-35, 47): f32 sums reordered over slots move the iterates by ulps.
VALUE_RTOL = 1e-5
W_ATOL, W_ATOL_PADDED = 1e-4, 5e-4
# X passes: one slot's sums in another order than XLA's, then the tree.
PASS_TOL = dict(rtol=1e-5, atol=1e-5)
# Streamed histories, as tests/test_torch_streamed.py: the same steps,
# per-slot chunk partials a few ulp apart.
HIST_RTOL = 1e-5


@pytest.fixture(scope="module")
def rmesh():
    return RMesh.make_mesh(devices=jax.devices("cpu"))


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(n_devices=8, device=CPU)


def _hist(res) -> np.ndarray:
    """A reference result's loss history up to its last iteration."""
    return np.asarray(res.loss_history)[:int(res.iterations) + 1]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def coo(seed=0, n=1001, d=300, k=6, zipf=True):
    """Padded COO rows with an intercept column last: zipf(1.4) columns
    (the X passes' skew), or uniform ones (a well-conditioned solve, as
    the reference's mesh tests use)."""
    rng = np.random.default_rng(seed)
    cols = ((rng.zipf(1.4, (n, k)) - 1) % (d - 1) if zipf
            else rng.integers(0, d - 1, (n, k)))
    ind = np.concatenate([cols, np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, k)), np.ones((n, 1))],
                         1).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32) * 0.3
    z = (val * w[ind]).sum(1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    return ind, val, y


def sparse_pair(n=1001, d=40, seed=0):
    ind, val, y = coo(seed, n, d, zipf=False)
    return (RD.make_batch(RM.SparseRows(ind, val, d), y),
            D.make_batch(M.SparseRows(ind, val, d), y, device=CPU))


def bell_pair(n=1001, d=40, seed=0, d_dense=8):
    rb, pb = sparse_pair(n, d, seed)
    return (RD.shard_blocked_ell_batch(rb, 8, d_dense=d_dense),
            D.shard_blocked_ell_batch(pb, 8, d_dense=d_dense))


# ------------------------------------------------------------ row sharding
def test_shard_fetch_round_trip_matches_reference(rmesh, pmesh):
    host = np.random.default_rng(1).normal(size=(100, 3)).astype(np.float32)
    want = RMesh.fetch_local_rows(RMesh.shard_rows(host, rmesh), rmesh)
    arr = PM.shard_rows(host, pmesh)
    got = PM.fetch_local_rows(arr, pmesh)
    assert got.shape == (8, 13, 3) and arr.n_rows == 104
    np.testing.assert_array_equal(got, want)
    back = PM.shard_local_rows(got, pmesh)
    np.testing.assert_array_equal(PM.fetch_local_rows(back, pmesh), want)
    np.testing.assert_array_equal(_np(arr.local())[:100], host)
    assert PM.local_row_slots(pmesh) == RMesh.local_row_slots(rmesh)
    assert len(PM.flat_mesh_devices(pmesh)) == 8
    wide = PM.shard_rows(np.ones(16, np.float32), pmesh, pad_rows=32)
    np.testing.assert_array_equal(
        PM.fetch_local_rows(wide, pmesh),
        RMesh.fetch_local_rows(RMesh.shard_rows(
            np.ones(16, np.float32), rmesh, pad_rows=32), rmesh))
    stacked = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    np.testing.assert_array_equal(
        PM.fetch_local_rows(PM.shard_stacked(stacked, pmesh), pmesh),
        RMesh.fetch_local_rows(RMesh.shard_stacked(stacked, rmesh), rmesh))
    with pytest.raises(ValueError, match="mesh slots"):
        PM.shard_stacked(stacked[:4], pmesh)


def test_make_mesh_and_the_raising_hybrid_mesh():
    m = PM.make_mesh(n_devices=8, device=CPU)
    assert (m.n_slots, m.local_slots, m.process_count) == (8, tuple(
        range(8)), 1)
    assert m.home == torch.device("cpu") and m.backend is None
    m2 = PM.make_mesh(devices=["cpu"] * 4)
    assert m2.n_slots == 4
    with pytest.raises(ValueError, match="at least one slot"):
        PM.make_mesh(n_devices=0, device=CPU)
    assert PM.make_hybrid_mesh(n_devices=8, device=CPU).shape == (1, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PM.make_mesh(n_devices=8)


def test_psum_is_the_slot_tree():
    """The reduction adds slot partials pairwise in slot order, and
    counts one reduction (no collective in one process)."""
    m = PM.make_mesh(n_devices=8, device=CPU)
    vals = [torch.tensor([np.float32(1e8) if j % 2 else np.float32(1.0)])
            for j in range(8)]
    telemetry.reset()
    (got,) = m.psum([(v,) for v in vals])
    want = vals[0]
    tree = [vals[j] + vals[j + 1] for j in range(0, 8, 2)]
    want = (tree[0] + tree[1]) + (tree[2] + tree[3])
    assert torch.equal(got, want)
    c = telemetry.snapshot()["counters"]
    assert c["mesh.reductions"] == 1 and "mesh.collectives" not in c
    with pytest.raises(ValueError, match="slot partials"):
        m.psum([(vals[0],)])


def test_compact_rows_onto_the_mesh(pmesh):
    block = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    out = PM.compact_rows((block,), [9, 1, 3], pad_rows=8, mesh=pmesh)[0]
    assert isinstance(out, PM.SlotRows) and out.rows_per_slot == 1
    want = torch.zeros(8, 4)
    want[:3] = block[[9, 1, 3]]
    assert torch.equal(out.local(), want)
    with pytest.raises(ValueError, match="divide"):
        PM.compact_rows((block,), [1, 2, 3], mesh=pmesh)


# ------------------------------------------------------------- X passes
@pytest.mark.parametrize("lanes", [0, 8])
def test_sharded_blocked_ell_passes_match_reference(rmesh, pmesh, lanes):
    ind, val, _ = coo(0, 203, 300)
    rb = RD.shard_blocked_ell_batch(RD.make_batch(RM.SparseRows(ind, val, 300),
                                                  np.zeros(203)), 8,
                                    d_dense=16)
    pb = D.shard_blocked_ell_batch(D.make_batch(M.SparseRows(ind, val, 300),
                                                np.zeros(203), device=CPU),
                                   8, d_dense=16)
    mb = D.mesh_batch(pb, pmesh)
    assert all(isinstance(p, M.BlockedEllRows) for p in mb.X.parts)
    d = pb.X.n_features
    rng = np.random.default_rng(5)
    shape = (d, lanes) if lanes else (d,)
    w = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=(208,) + shape[1:]).astype(np.float32)
    want_z = np.asarray(RM.matvec(rb.X, jax.numpy.asarray(w)))
    want_g = np.asarray(RM.rmatvec(rb.X, jax.numpy.asarray(r)))
    got_z = M.matvec(mb.X, torch.from_numpy(w))
    parts = M.rmatvec(mb.X, torch.from_numpy(r))
    assert isinstance(parts, PM.SlotParts) and len(parts) == 8
    (got_g,) = pmesh.psum([(p,) for p in parts])
    np.testing.assert_allclose(_np(got_z), want_z, **PASS_TOL)
    np.testing.assert_allclose(_np(got_g), want_g, **PASS_TOL)
    # the mesh form against the port's one-device layout of the same rows
    one = M.to_blocked_ell(M.SparseRows(*coo(0, 203, 300)[:2], 300), 16,
                           device=CPU)
    z1 = M.matvec(one, one.from_model_space(mb.X.to_model_space(
        torch.from_numpy(w))))
    np.testing.assert_allclose(_np(got_z)[:203], _np(z1), **PASS_TOL)


def test_resident_mesh_solve_builds_one_plan_per_slot(pmesh, monkeypatch):
    from test_torch_streamed import emulate_rmatvec, emulate_tail

    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_tail", emulate_tail)
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate_rmatvec)
    _, pb = bell_pair(n=400)
    cfg = OptimizerConfig(max_iters=4, reg=Reg.l2(), reg_weight=1.0)
    before = KB.plan_builds()
    K.reset_launch_counts()
    _, res = T.train_glm(pb, LOGISTIC, cfg, mesh=pmesh)
    assert KB.plan_builds() - before == 8
    counts = K.launch_counts()
    assert counts[KB.TAIL] > 0 and counts[KB.RMATVEC] > 0
    with K.scope("off"):
        _, plain = T.train_glm(pb, LOGISTIC, cfg, mesh=pmesh)
    np.testing.assert_allclose(res.history(), plain.history(), rtol=1e-6)


# ------------------------------------------------------------- training
OPTS = {"lbfgs": (ROpt.LBFGS, OptimizerType.LBFGS, "l2"),
        "owlqn": (ROpt.LBFGS, OptimizerType.LBFGS, "elastic"),
        "tron": (ROpt.TRON, OptimizerType.TRON, "l2")}


def _cfgs(opt, iters=150):
    r_opt, p_opt, reg = OPTS[opt]
    rr = (RReg.l2() if reg == "l2" else RReg.elastic_net(0.5))
    pr = (Reg.l2() if reg == "l2" else Reg.elastic_net(0.5))
    return (RConfig(max_iters=iters, reg=rr, reg_weight=1.0,
                    optimizer=r_opt),
            OptimizerConfig(max_iters=iters, reg=pr, reg_weight=1.0,
                            optimizer=p_opt))


@pytest.mark.parametrize("layout", ["sparse", "bell"])
@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
def test_train_glm_mesh_matches_reference(rmesh, pmesh, opt, layout):
    """1,001 rows: 7 zero-weight padding rows in the last slot."""
    rb, pb = (sparse_pair() if layout == "sparse" else bell_pair())
    rcfg, pcfg = _cfgs(opt)
    rm, rr = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                          mesh=rmesh)
    telemetry.reset()
    pm, pr = T.train_glm(pb, LOGISTIC, pcfg, mesh=pmesh)
    reductions = telemetry.snapshot()["counters"]["mesh.reductions"]
    np.testing.assert_allclose(float(pr.value), float(rr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               np.asarray(rm.coefficients.means),
                               atol=W_ATOL_PADDED)
    # against the port's own single-device solve of the same rows
    one = sparse_pair()[1]
    om, orr = T.train_glm(one, LOGISTIC, pcfg, device=CPU)
    np.testing.assert_allclose(float(pr.value), float(orr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               _np(om.coefficients.means),
                               atol=W_ATOL_PADDED)
    if opt == "owlqn":  # one reduction per f/g evaluation
        assert reductions == pr.evaluations
    assert pm.coefficients.means.device == pmesh.home


def test_cast_features_recasts_the_mesh_form(rmesh, pmesh):
    """`cast_features` recasts every value leaf of the mesh form, as the
    reference's does (the values bit for bit), and the bf16 mesh solve
    holds the reference's bf16 mesh value and the bf16 one-device solves
    of both packages at the reference's bounds (1,001 rows: padded). The
    reference's own bf16 mesh coefficients sit 5.9e-4 from its one-device
    ones, past its padded bound, so the coefficients are held against
    the one-device solves."""
    rb, pb = bell_pair()
    rc, pc = RD.cast_features(rb), D.cast_features(pb)
    for name in ("dense", "ell_vals", "bucket_vals"):
        want, got = getattr(rc.X, name), getattr(pc.X, name)
        want, got = ((want, got) if isinstance(got, tuple)
                     else ((want,), (got,)))
        assert len(got) == len(want) and got
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                _np(g.float()), np.asarray(w.astype(jax.numpy.float32)))
    rcfg, pcfg = _cfgs("lbfgs")
    _, rr = RT.train_glm(rc, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                         mesh=rmesh)
    pm, pr = T.train_glm(pc, LOGISTIC, pcfg, mesh=pmesh)
    np.testing.assert_allclose(float(pr.value), float(rr.value),
                               rtol=VALUE_RTOL)
    ind, val, y = coo(0, 1001, 40, zipf=False)
    _, r1 = RT.train_glm(RD.cast_features(RD.make_batch(RM.to_blocked_ell(
        RM.SparseRows(ind, val, 40), 8), y)),
        RL.TaskType.LOGISTIC_REGRESSION, rcfg)
    one = D.cast_features(D.make_batch(M.to_blocked_ell(
        M.SparseRows(ind, val, 40), 8, device=CPU), y, device=CPU))
    om, orr = T.train_glm(one, LOGISTIC, pcfg, device=CPU)
    for value, w in ((float(r1.value), np.asarray(r1.w)),
                     (float(orr.value), _np(om.coefficients.means))):
        np.testing.assert_allclose(float(pr.value), value, rtol=VALUE_RTOL)
        np.testing.assert_allclose(_np(pm.coefficients.means), w,
                                   atol=W_ATOL_PADDED)


def test_mesh_matches_single_device_unpadded(rmesh, pmesh):
    """The reference's own case (tests/test_training.py:27-35): 2,000
    dense rows of 12 features divide the slots — the tighter bound."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 12)).astype(np.float32)
    wt = (rng.normal(size=12) * 0.5).astype(np.float32)
    y = (rng.random(2000) < 1.0 / (1.0 + np.exp(-X @ wt))).astype(np.float32)
    rb, pb = RD.make_batch(X, y), D.make_batch(X, y, device=CPU)
    rcfg, pcfg = _cfgs("lbfgs", iters=150)
    _, rr = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                         mesh=rmesh)
    pm, pr = T.train_glm(pb, LOGISTIC, pcfg, mesh=pmesh)
    om, orr = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    np.testing.assert_allclose(float(pr.value), float(orr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(pr.value), float(rr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               _np(om.coefficients.means), atol=W_ATOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               np.asarray(rr.w), atol=W_ATOL)


def test_dense_mesh_with_variances_and_normalization(pmesh):
    """Dense X, SIMPLE variances (the Hessian diagonal closes with one
    reduction) and a normalization with shifts, against one device."""
    from photon_tpu_torch.models.variance import VarianceComputationType

    rng = np.random.default_rng(2)
    X = rng.normal(2.0, 3.0, size=(504, 6)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=504) < 0.5).astype(np.float32)
    b = D.make_batch(X, y, device=CPU)
    norm = N.NormalizationContext.from_summary(
        FeatureSummary.compute(X, mesh=pmesh),
        N.NormalizationType.STANDARDIZATION, intercept_index=5)
    cfg = OptimizerConfig(max_iters=60, reg=Reg.l2(), reg_weight=1.0)
    kw = dict(variance=VarianceComputationType.SIMPLE, normalization=norm)
    pm, pr = T.train_glm(b, LOGISTIC, cfg, mesh=pmesh, **kw)
    om, orr = T.train_glm(b, LOGISTIC, cfg, device=CPU, **kw)
    np.testing.assert_allclose(float(pr.value), float(orr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               _np(om.coefficients.means), atol=W_ATOL_PADDED)
    np.testing.assert_allclose(_np(pm.coefficients.variances),
                               _np(om.coefficients.variances), rtol=1e-4)


@pytest.mark.parametrize("reg", ["l2", "l1"])
def test_train_glm_grid_mesh_matches_reference(rmesh, pmesh, reg):
    rb, pb = sparse_pair()
    rr_ = RReg.l2() if reg == "l2" else RReg.l1()
    pr_ = Reg.l2() if reg == "l2" else Reg.l1()
    weights = [0.3, 3.0, 30.0]
    ref = RT.train_glm_grid(rb, RL.TaskType.LOGISTIC_REGRESSION,
                            RConfig(max_iters=30, reg=rr_), weights,
                            mesh=rmesh)
    got = T.train_glm_grid(pb, LOGISTIC, OptimizerConfig(max_iters=30,
                                                         reg=pr_),
                           weights, mesh=pmesh)
    one = T.train_glm_grid(pb, LOGISTIC, OptimizerConfig(max_iters=30,
                                                         reg=pr_),
                           weights, device=CPU)
    for (rm, rr), (gm, gr), (om, orr) in zip(ref, got, one):
        np.testing.assert_allclose(float(gr.value), float(rr.value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_allclose(float(gr.value), float(orr.value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_allclose(_np(gm.coefficients.means),
                                   np.asarray(rm.coefficients.means),
                                   atol=W_ATOL_PADDED)
        np.testing.assert_allclose(_np(gm.coefficients.means),
                                   _np(om.coefficients.means),
                                   atol=W_ATOL_PADDED)


# ------------------------------------------------------------- streamed
def _chunked_pair(kind, n=1000, seed=4):
    ind, val, y = coo(seed, n, 300)
    if kind == "ladder":
        return (RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val,
                                                                 300), y),
                                     256, d_dense=16, n_shards=8),
                D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, 300),
                                                 y, device=CPU), 256,
                                    d_dense=16, n_shards=8))
    rng = np.random.default_rng(seed)
    # columns on scales 0.1 .. 10: slow enough that 10 iterations stay
    # above the f32 floor
    X = (rng.normal(size=(n, 12)) * np.geomspace(0.1, 10.0, 12)).astype(
        np.float32)
    return (RD.chunk_batch(RD.make_batch(X, y), 250),
            D.chunk_batch(D.make_batch(X, y, device=CPU), 250))


@pytest.mark.parametrize("kind", ["dense", "ladder"])
@pytest.mark.parametrize("opt", ["lbfgs", "owlqn"])
def test_train_glm_streamed_mesh_matches_reference(rmesh, pmesh, kind, opt):
    rcb, pcb = _chunked_pair(kind)
    rcfg, pcfg = _cfgs(opt, iters=10)
    rcfg = dataclasses.replace(rcfg, tolerance=0.0)
    pcfg = dataclasses.replace(pcfg, tolerance=0.0)
    _, rr = RT.train_glm(rcb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                         mesh=rmesh)
    telemetry.reset()
    _, pr = T.train_glm(pcb, LOGISTIC, pcfg, mesh=pmesh)
    c = telemetry.snapshot()["counters"]
    assert pr.iterations == int(rr.iterations)
    np.testing.assert_allclose(pr.history(), _hist(rr), rtol=HIST_RTOL)
    np.testing.assert_allclose(_np(pr.w), np.asarray(rr.w), rtol=2e-3,
                               atol=2e-5)
    # one reduction per evaluation (L-BFGS's line-search trials included);
    # OWL-QN prices a whole ladder block of candidates per reduction
    if opt == "lbfgs":
        assert c["mesh.reductions"] == pr.evaluations
    else:
        assert c["mesh.reductions"] == c["solver.feature_streams"]


def test_streamed_mesh_normalization_matches_reference(rmesh, pmesh):
    rng = np.random.default_rng(7)
    X = rng.normal(3.0, 2.0, size=(504, 5)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=504) < 0.4).astype(np.float32)
    rnorm = RN.NormalizationContext.from_summary(
        RFS.compute(X, mesh=rmesh), RN.NormalizationType.STANDARDIZATION,
        intercept_index=4)
    pnorm = N.NormalizationContext.from_summary(
        FeatureSummary.compute(X, mesh=pmesh),
        N.NormalizationType.STANDARDIZATION, intercept_index=4)
    rcfg, pcfg = _cfgs("lbfgs", iters=15)
    rm, rr = RT.train_glm(RD.chunk_batch(RD.make_batch(X, y), 120),
                          RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                          mesh=rmesh, normalization=rnorm)
    pm, pr = T.train_glm(D.chunk_batch(D.make_batch(X, y, device=CPU), 120),
                         LOGISTIC, pcfg, mesh=pmesh, normalization=pnorm)
    assert pr.iterations == int(rr.iterations)
    np.testing.assert_allclose(pr.history(), _hist(rr), rtol=HIST_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               np.asarray(rm.coefficients.means),
                               rtol=2e-3, atol=2e-5)


def test_mesh_chunks_shard_pad_and_plan_per_ring_slot(pmesh, monkeypatch):
    from test_torch_streamed import emulate_rmatvec, emulate_tail

    rcb, pcb = _chunked_pair("dense", n=1000)
    assert pcb.mesh_chunk_rows(pmesh) == 256
    total = sum(float(sum(b.weights.sum() for b in bs))
                for _, bs in pcb.iter_device(mesh=pmesh))
    assert total == 1000.0
    mc = pcb.mesh_chunk(3, pmesh)
    assert float(mc.weights.local().sum()) == 250.0 and mc.X.n_rows == 256
    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_tail", emulate_tail)
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate_rmatvec)
    _, lad = _chunked_pair("ladder")
    before = KB.plan_builds()
    K.reset_launch_counts()
    _, res = T.train_glm(lad, LOGISTIC, OptimizerConfig(
        max_iters=4, reg=Reg.l2(), reg_weight=1.0), mesh=pmesh)
    assert KB.plan_builds() - before == 2 * 8  # (ring slot, mesh slot)
    counts = K.launch_counts()
    assert counts[KB.TAIL] > 0 and counts[KB.RMATVEC] > 0
    with K.scope("off"):
        _, plain = T.train_glm(lad, LOGISTIC, OptimizerConfig(
            max_iters=4, reg=Reg.l2(), reg_weight=1.0), mesh=pmesh)
    np.testing.assert_allclose(res.history(), plain.history(), rtol=1e-6)


def test_mesh_refusals(pmesh):
    _, pb = sparse_pair(n=64)
    one = D.make_batch(M.to_blocked_ell(pb.X, 16, device=CPU), pb.y,
                       device=CPU)
    cfg = OptimizerConfig(max_iters=2, reg=Reg.l2(), reg_weight=1.0)
    with pytest.raises(ValueError, match="single-device"):
        T.train_glm(one, LOGISTIC, cfg, mesh=pmesh)
    with pytest.raises(ValueError, match="shards but the mesh"):
        T.train_glm(D.shard_blocked_ell_batch(pb, 4, d_dense=16), LOGISTIC,
                    cfg, mesh=pmesh)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        T.train_glm(pb, LOGISTIC, cfg, mesh=object())
    with pytest.raises(ValueError, match="solves on its mesh"):
        T.train_glm(D.mesh_batch(pb, pmesh), LOGISTIC, cfg, device=CPU)
    with pytest.raises(ValueError, match="another mesh"):
        T.train_glm(D.mesh_batch(pb, pmesh), LOGISTIC, cfg,
                    mesh=PM.make_mesh(n_devices=8, device=CPU))
    single = D.chunk_blocked_ell(pb, 32, d_dense=16)
    with pytest.raises(ValueError, match="ONE device per chunk"):
        T.train_glm(single, LOGISTIC, cfg, mesh=pmesh)
    laid = D.chunk_blocked_ell(pb, 32, d_dense=16, n_shards=8)
    with pytest.raises(ValueError, match="laid for a 8-slot mesh"):
        T.train_glm(laid, LOGISTIC, cfg, device=CPU)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        D.chunk_blocked_ell(pb, 30, n_shards=8)
    with pytest.raises(ValueError, match="cannot pad a sharded"):
        D.pad_batch(D.shard_blocked_ell_batch(pb, 8, d_dense=16), 80)


def test_feature_summary_mesh_matches_reference(rmesh, pmesh):
    rng = np.random.default_rng(9)
    X = rng.normal(5.0, 0.5, size=(64, 5)).astype(np.float32)
    X[X < 5.0] = 0.0
    ind, val, _ = coo(9, 64, 40)
    for Xr, Xp in ((X, X), (RM.SparseRows(ind, val, 40),
                            M.SparseRows(ind, val, 40))):
        want = RFS.compute(Xr, mesh=rmesh)
        got = FeatureSummary.compute(Xp, mesh=pmesh)
        assert got.count == want.count
        for f in ("mean", "variance", "minimum", "maximum", "abs_max",
                  "norm_l1", "norm_l2"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(got.num_nonzeros, want.num_nonzeros)
    with pytest.raises(ValueError, match="do not divide"):
        FeatureSummary.compute(X[:63], mesh=pmesh)
