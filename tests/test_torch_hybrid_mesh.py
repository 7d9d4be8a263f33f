"""The port's sharded hybrid layouts (`ShardedHybridRows`,
`ShardedPermutedHybridRows`) on its in-process 8-slot CPU mesh against
the JAX package's global view of the same sharded layout.

On the same numpy-seeded rows (1,001 of them: the last slot carries
zero-weight padding rows): `shard_hybrid` (from padded COO rows and from
a `HybridRows`) and `shard_permuted_hybrid` bit for bit; each shard's
`local` view tiling the matrix (its matvec the global rows, the partial
Xᵀr summing to the global one); the mesh X passes (`data.dataset.
mesh_batch`: one layout per slot, the Xᵀr closed by the slot-ordered
reduction) at 1 and 4 lanes, f32 and bf16, within 1e-5 of the largest
output; `train_glm(mesh=)` (L-BFGS, OWL-QN, TRON; SIMPLE variances) and
`train_glm_grid(mesh=)` against the reference's global-view solves at
the reference's mesh bounds (value rtol 1e-5, coefficients atol 5e-4
with padding rows); one reduction per evaluation, one kernel plan per
slot; the refusals; and GAME's scoring of a sharded fixed shard, slot by
slot. Mirrors `tests/test_hybrid.py::TestShardedHybrid` and
`tests/test_permuted.py::TestShardedPermuted`.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var)
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402

CPU = "cpu"
LOGISTIC = L.TaskType.LOGISTIC_REGRESSION
RLOGISTIC = RL.TaskType.LOGISTIC_REGRESSION
# The reference's mesh-against-one-device bounds (tests/test_training.py:
# 34-35, 47, as tests/test_torch_mesh.py): f32 sums reordered over slots
# move the iterates by ulps.
VALUE_RTOL = 1e-5
W_ATOL_PADDED = 5e-4
PASS_RTOL = 1e-5
LAYOUTS = ("hybrid", "permuted")


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(n_devices=8, device=CPU)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def coo(seed=0, n=1001, d=300, k=6, zipf=True):
    """Padded COO rows with an intercept column last: zipf(1.4) columns
    (a filled hot block, buckets and tail), or uniform ones (a
    well-conditioned solve, as the reference's mesh tests use)."""
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


def sharded_pair(layout, S=8, n=1001, d=300, seed=0, d_dense=16,
                 zipf=True):
    """(reference sharded batch, port sharded batch): the same rows padded
    to S shards and laid out by each package's batch builder."""
    ind, val, y = coo(seed, n, d, zipf=zipf)
    rb = RD.make_batch(RM.SparseRows(ind, val, d), y)
    pb = D.make_batch(M.SparseRows(ind, val, d), y, device=CPU)
    if layout == "hybrid":
        return (RD.shard_hybrid_batch(rb, S, d_dense),
                D.shard_hybrid_batch(pb, S, d_dense))
    return (RD.shard_permuted_batch(rb, S, d_dense),
            D.shard_permuted_batch(pb, S, d_dense))


def host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_layout(ref, port):
    for f in dataclasses.fields(ref):
        r, p = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(r, tuple):
            assert len(r) == len(p), f.name
            for a, b in zip(r, p):
                np.testing.assert_array_equal(host(b), host(a),
                                              err_msg=f.name)
        elif isinstance(r, int):
            assert p == r, f.name
        else:
            np.testing.assert_array_equal(host(p), host(r), err_msg=f.name)
            assert host(p).dtype == host(r).dtype, f.name


def close(got, want, rtol=PASS_RTOL, msg=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * scale,
                               err_msg=msg)


def _in_space(X, v, to_layout: bool):
    """An original-space vector into a permuted layout's space (or back);
    as it is for a `ShardedHybridRows`."""
    if not hasattr(X, "perm_cols"):
        return v
    return X.from_model_space(v) if to_layout else X.to_model_space(v)


# ----------------------------------------------------------- the builders
@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("source", ["sparse", "hybrid", "permuted"])
def test_shard_builders_match_reference(S, source):
    ind, val, _ = coo(1, n=1000)
    d = 300
    if source == "permuted":
        ref = RM.shard_permuted_hybrid(RM.SparseRows(ind, val, d), S, 16)
        port = M.shard_permuted_hybrid(M.SparseRows(ind, val, d), S, 16)
    elif source == "sparse":
        ref = RM.shard_hybrid(RM.SparseRows(ind, val, d), S, 16)
        port = M.shard_hybrid(M.SparseRows(ind, val, d), S, 16)
    else:
        ref = RM.shard_hybrid(RM.to_hybrid(RM.SparseRows(ind, val, d), 16),
                              S)
        port = M.shard_hybrid(M.to_hybrid(M.SparseRows(ind, val, d), 16,
                                          device=CPU), S)
    assert_same_layout(ref, port)
    assert port.n_shards == S and port.n_local == 1000 // S
    assert port.shape == tuple(ref.shape)
    with pytest.raises(ValueError, match="do not divide"):
        (M.shard_permuted_hybrid if source == "permuted" else
         M.shard_hybrid)(M.SparseRows(ind[:999], val[:999], d), S, 16)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_local_views_tile_the_global_matrix(layout):
    """Each shard's `local` matvec gives its rows of the reference's
    global matvec; the shards' partial Xᵀr sum to its global Xᵀr."""
    rb, pb = sharded_pair(layout, S=4, n=1000)
    RX, PX = rb.X, pb.X
    rng = np.random.default_rng(2)
    d, nl = PX.n_features, PX.n_local
    w = rng.normal(size=d).astype(np.float32)
    r = rng.normal(size=PX.shape[0]).astype(np.float32)
    wr = RX.from_model_space(w) if layout == "permuted" else jnp.asarray(w)
    wp = _in_space(PX, torch.from_numpy(w), True)
    full = np.asarray(RM.matvec(RX, wr))
    total = 0.0
    for i in range(PX.n_shards):
        loc = PX.local(i)
        if layout == "hybrid":
            assert bool((loc.tail_rows[1:] >= loc.tail_rows[:-1]).all())
        close(M.matvec(loc, wp), full[i * nl:(i + 1) * nl])
        total = total + M.rmatvec(loc, torch.from_numpy(
            r[i * nl:(i + 1) * nl]))
    close(total, RM.rmatvec(RX, jnp.asarray(r)))


# ------------------------------------------------------- the mesh passes
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_x_passes_match_the_global_view(pmesh, layout, bf16):
    rb, pb = sharded_pair(layout)
    if bf16:
        rb, pb = RD.cast_features(rb), D.cast_features(pb)
        assert pb.X.dense.dtype == torch.bfloat16
        assert pb.X.tail_vals.dtype == torch.bfloat16
    mb = D.mesh_batch(pb, pmesh)
    assert isinstance(mb.X, PM.SlotRows) and len(mb.X.parts) == 8
    part = type(pb.X.local(0))
    assert all(isinstance(p, part) for p in mb.X.parts)
    RX = rb.X
    n, d = pb.X.shape
    rng = np.random.default_rng(3)
    for lanes in (0, 4):
        shape = (d, lanes) if lanes else (d,)
        w = rng.normal(size=shape).astype(np.float32)
        r = rng.normal(size=(n,) + shape[1:]).astype(np.float32)
        wr = (RX.from_model_space(w) if layout == "permuted"
              else jnp.asarray(w))
        mv = RM.matvec_lanes if lanes else RM.matvec
        rmv = RM.rmatvec_lanes if lanes else RM.rmatvec
        got_z = M.matvec(mb.X, _in_space(mb.X, torch.from_numpy(w), True))
        close(got_z, mv(RX, wr), msg=f"matvec {lanes}")
        for fn, rfn in ((M.rmatvec, rmv), (M.sq_rmatvec, RM.sq_rmatvec)):
            if lanes and fn is M.sq_rmatvec:
                continue
            parts = fn(mb.X, torch.from_numpy(r))
            assert isinstance(parts, PM.SlotParts) and len(parts) == 8
            (g,) = pmesh.psum([(p,) for p in parts])
            close(g, rfn(RX, jnp.asarray(r)), msg=f"{fn.__name__} {lanes}")


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


@pytest.mark.parametrize("layout,opt", [("hybrid", "lbfgs"),
                                        ("hybrid", "owlqn"),
                                        ("hybrid", "tron"),
                                        ("permuted", "lbfgs"),
                                        ("permuted", "tron")])
def test_train_glm_mesh_matches_the_global_view(pmesh, layout, opt):
    """The mesh solve against the reference's global-view solve of the
    same sharded layout (one device, no mesh) and the port's one-device
    solve of the one-device layout; one reduction per evaluation."""
    rb, pb = sharded_pair(layout, d=40, zipf=False, d_dense=8)
    rcfg, pcfg = _cfgs(opt)
    rm, rr = RT.train_glm(rb, RLOGISTIC, rcfg)
    telemetry.reset()
    pm, pr = T.train_glm(pb, LOGISTIC, pcfg, mesh=pmesh)
    reductions = telemetry.snapshot()["counters"]["mesh.reductions"]
    np.testing.assert_allclose(float(pr.value), float(rr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               np.asarray(rm.coefficients.means),
                               atol=W_ATOL_PADDED)
    ind, val, y = coo(0, d=40, zipf=False)
    build = M.to_hybrid if layout == "hybrid" else M.to_permuted_hybrid
    one = D.make_batch(build(M.SparseRows(ind, val, 40), 8, device=CPU), y,
                       device=CPU)
    om, orr = T.train_glm(one, LOGISTIC, pcfg, device=CPU)
    np.testing.assert_allclose(float(pr.value), float(orr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(pm.coefficients.means),
                               _np(om.coefficients.means),
                               atol=W_ATOL_PADDED)
    if opt == "owlqn":  # one reduction per f/g evaluation
        assert reductions == pr.evaluations
    assert pm.coefficients.means.device == pmesh.home


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_simple_variances_match_the_global_view(pmesh, layout):
    rb, pb = sharded_pair(layout, d=40, zipf=False, d_dense=8)
    rcfg, pcfg = _cfgs("lbfgs", iters=25)
    rm, _ = RT.train_glm(rb, RLOGISTIC, rcfg, variance=RVar.SIMPLE)
    pm, _ = T.train_glm(pb, LOGISTIC, pcfg, mesh=pmesh,
                        variance=Var.SIMPLE)
    np.testing.assert_allclose(_np(pm.coefficients.variances),
                               np.asarray(rm.coefficients.variances),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_glm_grid_mesh_matches_the_global_view(pmesh, layout):
    rb, pb = sharded_pair(layout, d=40, zipf=False, d_dense=8)
    rcfg, pcfg = _cfgs("lbfgs", iters=60)
    rcfg = dataclasses.replace(rcfg, reg_weight=0.0)
    pcfg = dataclasses.replace(pcfg, reg_weight=0.0)
    weights = [1e-1, 1.0, 10.0]
    ref = RT.train_glm_grid(rb, RLOGISTIC, rcfg, weights)
    got = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, mesh=pmesh)
    for (m_r, r_r), (m_g, r_g) in zip(ref, got):
        np.testing.assert_allclose(float(r_g.value), float(r_r.value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_allclose(_np(m_g.coefficients.means),
                                   np.asarray(m_r.coefficients.means),
                                   atol=W_ATOL_PADDED)


def test_permuted_mesh_solve_launches_the_rmatvec_per_slot(pmesh,
                                                           monkeypatch):
    """On the kernel route (the launches emulated by the plain version
    through each slot's plan) the sharded permuted hybrid builds one
    occurrence-only plan per slot and launches the rmatvec unrounded on
    every slot's buckets; the solve's bits are the plain versions'."""
    from test_torch_streamed import emulate_rmatvec

    rounds = set()

    def emulate(name, plan, ranges, r, lanes, square, out, round_r=True):
        rounds.add(bool(round_r))
        emulate_rmatvec(name, plan, ranges, r, lanes, square, out, round_r)

    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate)
    _, pb = sharded_pair("permuted", n=400, d=40, zipf=False, d_dense=8)
    pb = D.cast_features(pb)
    cfg = OptimizerConfig(max_iters=4, reg=Reg.l2(), reg_weight=1.0)
    before = KB.plan_builds()
    K.reset_launch_counts()
    _, res = T.train_glm(pb, LOGISTIC, cfg, mesh=pmesh)
    assert KB.plan_builds() - before == 8
    counts = K.launch_counts()
    assert set(counts) == {KB.RMATVEC} and counts[KB.RMATVEC] % 8 == 0
    assert rounds == {False}
    with K.scope("off"):
        _, plain = T.train_glm(pb, LOGISTIC, cfg, mesh=pmesh)
    np.testing.assert_allclose(res.history(), plain.history(), rtol=1e-6)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mismatched_shards_raise(pmesh, layout):
    _, pb = sharded_pair(layout, S=4, n=1000)
    with pytest.raises(ValueError, match="4 shards"):
        T.train_glm(pb, LOGISTIC, OptimizerConfig(max_iters=2),
                    mesh=pmesh)
    with pytest.raises(ValueError, match="cannot pad a sharded batch"):
        D.pad_batch(pb, 1004)


# ---------------------------------------------------------------- GAME
@pytest.mark.parametrize("layout", LAYOUTS)
def test_game_scores_a_sharded_fixed_shard_slot_by_slot(layout):
    """`game.scoring` scores a sharded fixed shard shard by shard on the
    model's device: the reference's global-view margins."""
    from photon_tpu_torch.convert import glm_from_arrays
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.model import FixedEffectModel, GameModel
    from photon_tpu_torch.game.scoring import coordinate_scores

    rb, pb = sharded_pair(layout, S=4, n=1000)
    w = np.random.default_rng(4).normal(size=300).astype(np.float32)
    model = GameModel({"fixed": FixedEffectModel(
        glm_from_arrays("logistic", w, device=CPU), "f")}, LOGISTIC)
    got = coordinate_scores(model, GameData.build(
        np.zeros(1000, np.float32), {"f": pb.X}))["fixed"]
    wr = (rb.X.from_model_space(w) if layout == "permuted"
          else jnp.asarray(w))
    close(got, RM.matvec(rb.X, wr))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_game_fixed_effect_on_the_mesh(pmesh, layout):
    """A GAME fixed effect on a sharded hybrid shard fits on the mesh (each
    slot its shard): one sweep of a fixed-effect-only model is the
    reference's global-view `train_glm` of the same layout."""
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator)

    rb, pb = sharded_pair(layout, n=1000, d=40, zipf=False, d_dense=8)
    rcfg, pcfg = _cfgs("lbfgs", iters=40)
    rm, rr = RT.train_glm(rb, RLOGISTIC, rcfg)
    pfit = GameEstimator(task=LOGISTIC, mesh=pmesh, n_sweeps=1,
                         coordinate_configs={
                             "fixed": FixedEffectConfig("f", pcfg)}).fit(
        GameData.build(_np(pb.y), {"f": pb.X}))[0]
    (st,) = pfit.descent.coordinate_stats["fixed"]
    assert int(st.iterations) == int(rr.iterations)
    np.testing.assert_allclose(float(st.value), float(rr.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(
        _np(pfit.model["fixed"].model.coefficients.means),
        np.asarray(rm.coefficients.means), atol=W_ATOL_PADDED)
