"""The port's sharded layouts in their one-device global view
(`ShardedBlockedEllRows`, `ShardedPermutedHybridRows`,
`ShardedHybridRows` moved whole to one device, no mesh) against the JAX
package's global view of the same layout.

On the same numpy-seeded padded COO rows (1,000 of them, 8 shards):

- every X pass (`matvec`, `rmatvec`, their 3-lane forms, `sq_rmatvec`)
  within rtol 1e-5 of the reference's global view (atol 1e-5 of the
  largest output), and within the reference's own 2e-4 of the one-device
  layout of the same rows (`tests/test_blocked_ell.py:354-375`);
  `nnz_stats` equal; `weighted_gram` of the hybrid within 1e-5 of the
  reference's, of the two permuted layouts (the reference densifies
  neither) within 1e-5 of an f64 Gram in their permuted space;
  `last_column_is_intercept` as one device's;
- the device form: `to` keeps the layout where it is, the blocked-ELL
  kernels launch once per shard and pass (emulated on the CPU through
  the plan, as `tests/test_torch_streamed.py`), and the shards' plans are
  built on the first pass and on none after;
- `train_glm` (L-BFGS, OWL-QN, TRON, on 40 uniform columns, as the
  reference's mesh tests) on each sharded batch with no mesh against the
  reference's global-view solve cut to 6 iterations (4 for TRON) where
  both still make progress: iterations equal, histories within rtol
  1e-5, coefficients within atol 1e-4, in original column order; run to
  convergence (at most 25 iterations) against the one-device solve within the
  reference's atol 5e-3 (`tests/test_hybrid.py:218-236`, whose OWL-QN
  regression — the fused route must not pad the laid-out shards — runs
  for all three layouts); `train_glm_grid` against the reference's;
- scoring (`score`, `predict_mean`, `score_models`) on a sharded layout,
  GAME's sequential fixed effect on a sharded shard against the
  reference's fit, and the refusals both packages keep.
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
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.statistics import FeatureSummary  # noqa: E402
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.glm import score_models  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402

CPU = "cpu"
LOGISTIC = L.TaskType.LOGISTIC_REGRESSION
RLOGISTIC = RL.TaskType.LOGISTIC_REGRESSION
S, N, D_FEAT, D_DENSE = 8, 1000, 300, 16
LAYOUTS = ("blocked_ell", "permuted", "hybrid")
BUILDERS = {"blocked_ell": ("shard_blocked_ell_batch", "to_blocked_ell"),
            "permuted": ("shard_permuted_batch", "to_permuted_hybrid"),
            "hybrid": ("shard_hybrid_batch", "to_hybrid")}
PASSES = ("matvec", "rmatvec", "matvec_lanes", "rmatvec_lanes",
          "sq_rmatvec")
# the reference's global-view bound and its sharded-against-one-device
# bounds (tests/test_blocked_ell.py:354-375, tests/test_hybrid.py:234-236)
PASS_RTOL, ONE_DEVICE_TOL = 1e-5, 2e-4
VALUE_RTOL, W_ATOL, W_ATOL_ONE_DEVICE = 1e-5, 1e-4, 5e-3
ITERS, SHORT_ITERS, TRON_ITERS, SOLVE_D, REG = 25, 6, 4, 40, 10.0


def coo(seed=0, n=N, d=D_FEAT, k=6, intercept=True, zipf=True,
        planted=True):
    """Padded COO rows with zipf(1.4) columns (a filled hot block, several
    occurrence buckets and ELL widths), or uniform ones (a
    well-conditioned solve, as the reference's mesh tests use); an
    intercept in column d - 1 when asked; labels from a planted model, or
    coin flips (`tests/test_hybrid.py`'s OWL-QN regression)."""
    rng = np.random.default_rng(seed)
    cols = ((rng.zipf(1.4, (n, k)) - 1) % (d - 1) if zipf
            else rng.integers(0, d - 1, (n, k)))
    val = rng.normal(size=(n, k)).astype(np.float32)
    if intercept:
        cols = np.concatenate([cols, np.full((n, 1), d - 1)], 1)
        val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    ind = cols.astype(np.int32)
    w = rng.normal(size=d).astype(np.float32) * 0.3
    z = (val * w[ind]).sum(1) if planted else np.zeros(n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    return ind, val, y


def batches(layout, seed=0, d=D_FEAT, d_dense=D_DENSE, **kw):
    """(reference sharded batch, port sharded batch, port one-device
    batch) of the same rows."""
    ind, val, y = coo(seed, d=d, **kw)
    shard, one = BUILDERS[layout]
    rb = getattr(RD, shard)(RD.make_batch(RM.SparseRows(ind, val, d), y), S,
                            d_dense)
    pb = getattr(D, shard)(D.make_batch(M.SparseRows(ind, val, d), y,
                                        device=CPU), S, d_dense)
    ob = D.make_batch(getattr(M, one)(M.SparseRows(ind, val, d), d_dense,
                                      device=CPU), y, device=CPU)
    return rb, pb, ob


def solve_batches(layout, seed):
    """`batches` of a well-conditioned problem (40 uniform columns, 8 of
    them hot: the reference's mesh-test shape), where a solve converges
    inside its iteration budget and the coefficients are well
    determined."""
    return batches(layout, seed=seed, d=SOLVE_D, d_dense=8, zipf=False)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _vec(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, rtol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _arg(name, X, rng):
    n, d = X.shape
    if name in ("matvec", "matvec_lanes"):
        return _vec(rng, (d,) if name == "matvec" else (d, 3))
    return _vec(rng, (n,) if name != "rmatvec_lanes" else (n, 3))


# ----------------------------------------------------------- the X passes
@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_global_view_passes_match_reference(layout, name):
    """Each pass of the port's global view, vectors in the layout's own
    space, within 1e-5 of the reference's global view of the same
    layout (the sharded builders lay both bit for bit)."""
    rb, pb, _ = batches(layout)
    P = pb.X.to(CPU)
    v = _arg(name, P, np.random.default_rng(1))
    got = getattr(M, name)(P, torch.from_numpy(v))
    want = getattr(RM, name)(rb.X, jnp.asarray(v))
    _close(got, want, PASS_RTOL, f"{layout} {name}")


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_global_view_passes_match_one_device(layout, name):
    """Each pass in model space against the one-device layout of the same
    rows, at the reference's 2e-4 (the sharded permutation ranks the tail
    columns by their largest per-shard count, so the two spaces differ)."""
    _, pb, ob = batches(layout)
    P, O = pb.X.to(CPU), ob.X
    v = torch.from_numpy(_arg(name, P, np.random.default_rng(2)))
    fn = getattr(M, name)
    if layout == "hybrid":
        got, want = fn(P, v), fn(O, v)
    elif name.startswith("matvec"):
        got, want = fn(P, P.from_model_space(v)), fn(O, O.from_model_space(v))
    else:
        got, want = P.to_model_space(fn(P, v)), O.to_model_space(fn(O, v))
    _close(got, want, ONE_DEVICE_TOL, f"{layout} {name} vs one device")


def _permuted_dense(ind, val, X) -> np.ndarray:
    """The rows as an f64 (n, d) matrix in ``X``'s permuted space."""
    n, d = X.shape
    A = np.zeros((n, d))
    np.add.at(A, (np.repeat(np.arange(n), ind.shape[1]), ind.reshape(-1)),
              val.reshape(-1).astype(np.float64))
    return A[:, _np(X.perm_cols)] if hasattr(X, "perm_cols") else A


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gram_nnz_and_intercept_of_the_global_view(layout):
    """`weighted_gram`: the hybrid's against the reference's global view;
    the permuted layouts' (no reference counterpart: the reference
    densifies neither) against an f64 Gram in their permuted space.
    `nnz_stats` as the reference counts it; `last_column_is_intercept`
    as one device's, with and without an intercept column."""
    ind, val, y = coo(3)
    rb, pb, ob = batches(layout, seed=3)
    P = pb.X.to(CPU)
    r = _vec(np.random.default_rng(4), N)
    got = M.weighted_gram(P, torch.from_numpy(r))
    if layout == "hybrid":
        want = RM.weighted_gram(rb.X, jnp.asarray(r))
    else:
        A = _permuted_dense(ind, val, P)
        want = (A * r[:, None].astype(np.float64)).T @ A
    _close(got, want, PASS_RTOL, f"{layout} weighted_gram")
    assert M.nnz_stats(P) == tuple(int(x) for x in RM.nnz_stats(rb.X))
    assert M.last_column_is_intercept(P) and \
        M.last_column_is_intercept(ob.X)
    _, no_icpt, one = batches(layout, seed=3, intercept=False)
    assert M.last_column_is_intercept(no_icpt.X) == \
        M.last_column_is_intercept(one.X) is False


# ------------------------------------------------- the device form, plans
def _layout_of(plan):
    for ref, pl in KB._PLANS.values():
        if pl is plan:
            return ref()
    raise AssertionError("no layout owns this plan")


def _emulate_tail(name, plan, ranges, w, lanes, out, zero_bytes):
    if zero_bytes:
        out.zero_()
    out += KB.tail_matvec_reference(_layout_of(plan), w)
    K.count_launch(name, ranges[2])


def _emulate_rmatvec(name, plan, ranges, r, lanes, square, out,
                     round_r=True):
    out.copy_(KB.bucket_rmatvec_reference(_layout_of(plan), r, square,
                                          round_r))
    K.count_launch(name, ranges[2])


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The blocked-ELL wrappers take their kernel path on the CPU, the
    launch emulated on the plan it was given."""
    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_tail", _emulate_tail)
    monkeypatch.setattr(KB, "_launch_rmatvec", _emulate_rmatvec)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_form_launches_per_shard_and_plans_once(layout,
                                                       emulated_kernels):
    """`to` on the layout's own device keeps it (and its shard views);
    a blocked-ELL pass launches the tail kernel and the rmatvec once per
    shard, a permuted hybrid's Xᵀr the rmatvec once per shard, the hybrid
    none; every shard's plan is built on the first pass and none on the
    second, and the kernel path gives the plain version's values."""
    _, pb, _ = batches(layout)
    P = pb.X.to(CPU)
    assert P is pb.X and P.to(torch.device(CPU)) is P
    rng = np.random.default_rng(5)
    w = torch.from_numpy(_vec(rng, D_FEAT))
    r = torch.from_numpy(_vec(rng, N))
    with K.scope("off"):
        plain = (M.matvec(P, w), M.rmatvec(P, r))
    builds = K.plan_builds()
    K.reset_launch_counts()
    first = (M.matvec(P, w), M.rmatvec(P, r))
    mid = K.plan_builds()
    launches = K.launch_counts()
    K.reset_launch_counts()
    second = (M.matvec(P, w), M.rmatvec(P, r))
    assert K.plan_builds() == mid
    assert K.launch_counts() == launches
    want = {"blocked_ell": {KB.TAIL: S, KB.RMATVEC: S},
            "permuted": {KB.RMATVEC: S}, "hybrid": {}}[layout]
    assert launches == want
    assert mid - builds == (S if want else 0)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b)
        _close(a, c, PASS_RTOL, f"{layout} kernel path vs plain")


# ---------------------------------------------------------------- solves
def _configs(opt, iters=None):
    """(reference, port) configs: L-BFGS with L2 weight REG, OWL-QN with an
    elastic net (the L1 term routes it), TRON with L2 weight REG cut to
    TRON_ITERS Newton steps; ``iters`` (tolerance 0) stops each where its
    iterates still make progress — at the f32 floor a rounding decides
    the stop (the reference's own sharded and one-device TRON solves of a
    zipf problem stop an iteration apart there, 1.05e-3 apart)."""
    if opt == "owlqn":
        kw = dict(reg=RReg.elastic_net(0.5), reg_weight=REG)
        pkw = dict(reg=Reg.elastic_net(0.5), reg_weight=REG)
    else:
        kw = dict(reg=RReg.l2(), reg_weight=REG)
        pkw = dict(reg=Reg.l2(), reg_weight=REG)
    if iters is not None:
        kw["tolerance"] = pkw["tolerance"] = 0.0
    else:
        iters = ITERS
    if opt == "tron":
        kw["optimizer"] = ROpt.TRON
        pkw["optimizer"] = OptimizerType.TRON
        iters = min(iters, TRON_ITERS)
    return (RConfig(max_iters=iters, **kw),
            OptimizerConfig(max_iters=iters, **pkw))


@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_glm_global_view_matches_reference(layout, opt):
    """`train_glm` on a sharded batch with no mesh, against the
    reference's global-view solve cut to SHORT_ITERS iterations (value
    rtol 1e-5, coefficients in original column order atol 1e-4), and,
    run to convergence (at most 25 iterations), against the port's
    one-device solve of the same rows (atol 5e-3)."""
    rb, pb, ob = solve_batches(layout, 6)
    rcfg, pcfg = _configs(opt, SHORT_ITERS)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    assert pres.iterations == int(rres.iterations)
    np.testing.assert_allclose(pres.history(), np.asarray(rres.history()),
                               rtol=VALUE_RTOL)
    _, pcfg = _configs(opt)
    pm_c, _ = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    om, _ = T.train_glm(ob, LOGISTIC, pcfg, device=CPU)
    np.testing.assert_allclose(pm_c.coefficients.means.numpy(),
                               om.coefficients.means.numpy(),
                               atol=W_ATOL_ONE_DEVICE)
    np.testing.assert_allclose(float(pres.value), float(rres.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(pm.coefficients.means.numpy(),
                               np.asarray(rm.coefficients.means),
                               atol=W_ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_owlqn_global_view_does_not_pad_the_shards(layout):
    """`tests/test_hybrid.py::test_single_device_global_view_owlqn` for
    every sharded layout: OWL-QN (the dense fused route's branch) on a
    sharded batch leaves the laid-out shards as they are and lands within
    atol 5e-3 of the solve of the plain rows."""
    ind, val, y = coo(7, planted=False)
    _, pb, _ = batches(layout, seed=7, planted=False)
    cfg = OptimizerConfig(max_iters=ITERS, reg=Reg.l1(), reg_weight=2.0,
                          regularize_intercept=True)
    m_sh, res = T.train_glm(pb, LOGISTIC, cfg, device=CPU)
    m_ref, _ = T.train_glm(D.make_batch(M.SparseRows(ind, val, D_FEAT), y,
                                        device=CPU), LOGISTIC, cfg,
                           device=CPU)
    assert not bool(res.failed)
    assert pb.X.shape[0] == N
    np.testing.assert_allclose(m_sh.coefficients.means.numpy(),
                               m_ref.coefficients.means.numpy(), atol=5e-3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_glm_grid_global_view_matches_reference(layout):
    """A 3-lane L2 `train_glm_grid` (SHORT_ITERS iterations) on a sharded
    batch with no mesh against the reference's global-view grid: each
    lane's final value within rtol 1e-5, its coefficients within atol
    1e-4."""
    rb, pb, _ = solve_batches(layout, 8)
    rcfg, pcfg = _configs("lbfgs", SHORT_ITERS)
    weights = [1.0, 3.0, 10.0]
    ref = RT.train_glm_grid(rb, RLOGISTIC, rcfg, weights)
    port = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    for (rm, rres), (pm, pres) in zip(ref, port):
        np.testing.assert_allclose(float(pres.value), float(rres.value),
                                   rtol=VALUE_RTOL)
        np.testing.assert_allclose(pm.coefficients.means.numpy(),
                                   np.asarray(rm.coefficients.means),
                                   atol=W_ATOL)


# --------------------------------------------------------------- callers
@pytest.mark.parametrize("layout", LAYOUTS)
def test_scoring_a_sharded_layout(layout):
    """A model's `score`, `predict_mean` and `score_models` on a sharded
    layout (coefficients in original column order) equal its scores on
    the plain rows within 1e-5."""
    ind, val, y = coo(9)
    _, pb, _ = batches(layout, seed=9)
    P = pb.X.to(CPU)
    Xs = M.SparseRows(torch.from_numpy(ind), torch.from_numpy(val), D_FEAT)
    rng = np.random.default_rng(10)
    from photon_tpu_torch.models.glm import (linear_regression,
                                             logistic_regression)

    m1 = logistic_regression(torch.from_numpy(_vec(rng, D_FEAT)))
    m2 = linear_regression(torch.from_numpy(_vec(rng, D_FEAT)))
    _close(m1.score(P, 0.5), m1.score(Xs, 0.5), PASS_RTOL, "score")
    _close(m1.predict_mean(P), m1.predict_mean(Xs), PASS_RTOL,
           "predict_mean")
    _close(score_models([m1, m2], P), score_models([m1, m2], Xs), PASS_RTOL,
           "score_models")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_feature_summary_refuses_a_sharded_layout(layout):
    """`FeatureSummary.compute` takes the original rows, not a re-layout
    (the reference refuses its sharded hybrid the same way)."""
    rb, pb, _ = batches(layout)
    with pytest.raises(TypeError, match="re-layout"):
        FeatureSummary.compute(pb.X, device=CPU)
    if layout == "hybrid":
        from photon_tpu.data.statistics import FeatureSummary as RSummary

        with pytest.raises(TypeError, match="re-layout"):
            RSummary.compute(rb.X)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_game_sequential_fixed_effect_on_a_sharded_shard(layout):
    """A GAME fit whose fixed shard is a sharded layout, with no mesh:
    the lane grid refuses the layout (the reference's
    `_grid_data_supported`), so the sequential path trains the fixed
    effect through `train_glm`'s global view. The reference's own
    `FixedEffectDataset.build` cannot take a sharded layout without a
    mesh (it casts the shard with ``jnp.asarray``, ROADMAP §C24), so the
    fit is held against the reference's `train_glm` global view of the
    same batch (one coordinate, one sweep, no offsets: the same solve;
    coefficients
    atol 1e-4) and against the port's fit of the one-device layout
    (objective history rtol 1e-5, coefficients atol 5e-3)."""
    from photon_tpu_torch.game import (FixedEffectConfig, GameData,
                                       GameEstimator)

    rb, pb, ob = solve_batches(layout, 11)
    rcfg, pcfg = _configs("lbfgs", SHORT_ITERS)
    rm, _ = RT.train_glm(rb, RLOGISTIC, rcfg)
    y = _np(pb.y)
    fits = []
    for X in (pb.X, ob.X):
        data = GameData.build(y, {"f": X}, {})
        est = GameEstimator(task=LOGISTIC, device=CPU, warm_start=False,
                            n_sweeps=1,
                            coordinate_configs={"fixed": FixedEffectConfig(
                                "f", pcfg)})
        assert not est._grid_data_supported(data) or X is ob.X
        fits.append(est.fit(data)[0])
    w = fits[0].model["fixed"].model.coefficients.means.numpy()
    np.testing.assert_allclose(fits[0].descent.objective_history,
                               fits[1].descent.objective_history,
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(w, np.asarray(rm.coefficients.means),
                               atol=W_ATOL)
    np.testing.assert_allclose(
        w, fits[1].model["fixed"].model.coefficients.means.numpy(),
        atol=W_ATOL_ONE_DEVICE)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_refusals_the_reference_keeps(layout):
    """A sharded batch is not padded (its shards are laid out), and a mesh
    of another slot count is refused naming the builder — in both
    packages."""
    rb, pb, _ = batches(layout)
    with pytest.raises(ValueError, match="cannot pad a sharded batch"):
        D.pad_batch(pb, N + S)
    with pytest.raises(ValueError, match="cannot pad a sharded batch"):
        RD.pad_batch(rb, N + S)
    cfg = OptimizerConfig(max_iters=2, reg=Reg.l2(), reg_weight=1.0)
    with pytest.raises(ValueError, match=BUILDERS[layout][0]):
        T.train_glm(pb, LOGISTIC, cfg,
                    mesh=PM.make_mesh(n_devices=4, device=CPU))


def test_a_mesh_ladder_scored_without_a_mesh_is_refused():
    """`game/scoring.py:125-129`: a chunk ladder laid for a mesh scores
    only on one."""
    from photon_tpu_torch.game.scoring import score_chunked_host

    ind, val, y = coo(12, n=512)
    cb = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, D_FEAT), y,
                                          device=CPU), 128, D_DENSE,
                             n_shards=2)
    with pytest.raises(ValueError, match="pass mesh="):
        score_chunked_host(cb.X, torch.zeros(D_FEAT), device=CPU)
