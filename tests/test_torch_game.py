"""The port's GAME training (fixed effect + per-entity random effects by
coordinate descent) against the JAX package.

On the same numpy-seeded data: the entity bucketing of
`RandomEffectDataset.build` (entity order, block heights, row ids,
padding, the projected X) with and without ``active_cap`` and with
INDEX_MAP and RANDOM projection; `RandomEffectCoordinate.train`'s
per-entity coefficients and iteration counts on L-BFGS, OWL-QN and TRON,
with priors and with SIMPLE and FULL variances, on dense and sparse
blocks; `GameEstimator.fit` over two sweeps (objective history, the fixed
coefficients and every random-effect table) for logistic, linear and
Poisson regression; locked and incremental coordinates; a config grid with
warm starts; an unseen entity scoring zero; a fit with validation data
and a cold (vectorized) reg-weight grid; and every path that is not
ported raising with its ROADMAP item. Loss histories within rtol 1e-5
with equal iterations, coefficients within rtol 1e-4 (atol 1e-5),
variances within rtol 1e-4. The port runs on the CPU.
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

from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.game import dataset as RGD  # noqa: E402
from photon_tpu.game import estimator as RGE  # noqa: E402
from photon_tpu.game import projector as RPJ  # noqa: E402
from photon_tpu.game import random_effect as RRE  # noqa: E402
from photon_tpu.game.scoring import score_game as ref_score_game  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import chunk_matrix  # noqa: E402
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game import estimator as GE  # noqa: E402
from photon_tpu_torch.game import projector as PJ  # noqa: E402
from photon_tpu_torch.game import random_effect as RE  # noqa: E402
from photon_tpu_torch.game.scoring import score_game  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var)
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402

CPU = "cpu"
HIST_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-5
VAR_RTOL = 1e-4


def raw_game(seed=0, n=600, task="logistic", users=24, items=14):
    """Numpy GAME data: a dense fixed shard (d 6, intercept last), a dense
    per-user shard (d 4, intercept last) and a sparse per-item shard
    (d 12, 3 nonzeros + the intercept, a padding slot); zipf-skewed entity
    popularity (so entities fall into several bucket heights, a few above
    any small active cap); labels from a planted model of ``task``."""
    rng = np.random.default_rng(seed)
    Xf = np.concatenate([rng.normal(size=(n, 5)),
                         np.ones((n, 1))], 1).astype(np.float32)
    Xu = np.concatenate([rng.normal(size=(n, 3)),
                         np.ones((n, 1))], 1).astype(np.float32)
    d_i = 12
    col = np.argsort(rng.uniform(size=(n, d_i - 1)), axis=1)[:, :3]
    ind = np.concatenate([col, np.zeros((n, 1), np.int64),
                          np.full((n, 1), d_i - 1)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1)),
                          np.ones((n, 1))], 1).astype(np.float32)
    uid = (rng.zipf(1.3, size=n) - 1) % users
    iid = np.asarray([f"i{k}" for k in (rng.zipf(1.5, size=n) - 1) % items])
    wf = (0.5 * rng.normal(size=6)).astype(np.float32)
    wu = (0.5 * rng.normal(size=(users, 4))).astype(np.float32)
    wi = (0.5 * rng.normal(size=(items, d_i))).astype(np.float32)
    ii = np.searchsorted(np.unique(iid), iid)
    margin = (Xf @ wf + np.einsum("nd,nd->n", Xu, wu[uid])
              + np.einsum("nk,nk->n", val, wi[ii[:, None], ind]))
    if task == "linear":
        y = margin + rng.normal(size=n)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(0.5 * margin, -3, 2)))
    else:
        y = rng.uniform(size=n) < 1 / (1 + np.exp(-margin))
    weights = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return dict(y=np.asarray(y, np.float32), Xf=Xf, Xu=Xu, ind=ind, val=val,
                d_i=d_i, uid=uid, iid=iid, weights=weights)


def game_pair(raw):
    """(reference GameData, port GameData) of the same raw arrays."""
    ref = RGD.GameData.build(
        raw["y"], shards={"fixed": raw["Xf"], "u": raw["Xu"],
                          "i": RM.SparseRows(raw["ind"], raw["val"],
                                             raw["d_i"])},
        entity_ids={"user": raw["uid"], "item": raw["iid"]},
        weights=raw["weights"])
    port = GD.GameData.build(
        raw["y"], shards={"fixed": raw["Xf"], "u": raw["Xu"],
                          "i": M.SparseRows(raw["ind"], raw["val"],
                                            raw["d_i"])},
        entity_ids={"user": raw["uid"], "item": raw["iid"]},
        weights=raw["weights"])
    return ref, port


def cfg_pair(opt="lbfgs", reg="l2", lam=1.0, iters=6, tol=1e-3, **kw):
    """(reference, port) optimizer configs. The tolerance stops each solve
    where its relative progress falls below 1e-3 — a decision that f32
    rounding cannot flip, unlike a stop at the f32 floor, where the two
    sides' last steps part (these small entity problems reach it within a
    few iterations)."""
    r = {"l2": (RReg.l2(), Reg.l2()), "l1": (RReg.l1(), Reg.l1()),
         "en": (RReg.elastic_net(0.5), Reg.elastic_net(0.5))}[reg]
    common = dict(max_iters=iters, reg_weight=lam, history=4, tolerance=tol,
                  **kw)
    return (RConfig(optimizer=ROpt(opt), reg=r[0], **common),
            OptimizerConfig(optimizer=OptimizerType(opt), reg=r[1],
                            **common))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# -------------------------------------------------------------- bucketing
@pytest.mark.parametrize("projection", [None, "index_map", "random"])
@pytest.mark.parametrize("active_cap", [None, 8])
@pytest.mark.parametrize("shard", ["u", "i"])
def test_bucketing_matches_reference(shard, active_cap, projection):
    """Entity keys and order, block heights, row ids, labels, weights,
    padding and the (projected) X equal the reference's."""
    ref, port = game_pair(raw_game())
    entity = "user" if shard == "u" else "item"
    rp = pp = None
    if projection is not None:
        kind = projection.upper()
        dim = 4 if shard == "u" else 6
        rp = RPJ.ProjectionConfig(RPJ.ProjectorType[kind], dim, seed=3)
        pp = PJ.ProjectionConfig(PJ.ProjectorType[kind], dim, seed=3)
    want = RGD.RandomEffectDataset.build(ref, entity, shard,
                                         active_cap=active_cap, seed=5,
                                         projection=rp)
    got = GD.RandomEffectDataset.build(port, entity, shard,
                                       active_cap=active_cap, seed=5,
                                       projection=pp, device=CPU)
    np.testing.assert_array_equal(got.entity_keys, want.entity_keys)
    np.testing.assert_array_equal(got.entity_dense, want.entity_dense)
    assert got.key_to_index == want.key_to_index
    assert (got.n_active, got.n_passive) == (want.n_active, want.n_passive)
    assert len(got.blocks) == len(want.blocks)
    assert len(got.blocks) >= (2 if active_cap is None else 1)
    for gb, wb in zip(got.blocks, want.blocks):
        assert gb.m == wb.m and gb.dim == wb.dim
        np.testing.assert_array_equal(gb.entity_index, wb.entity_index)
        for f in ("row_index", "y", "weights"):
            np.testing.assert_array_equal(_np(getattr(gb, f)),
                                          np.asarray(getattr(wb, f)))
        if isinstance(wb.X, tuple):
            for g, w in zip(gb.X, wb.X):
                np.testing.assert_array_equal(_np(g), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(gb.X), np.asarray(wb.X),
                                       rtol=1e-6, atol=1e-6)
        assert (gb.proj is None) == (wb.proj is None)
        if wb.proj is not None:
            np.testing.assert_array_equal(gb.proj.proj_idx, wb.proj.proj_idx)
            np.testing.assert_array_equal(gb.proj.proj_mask,
                                          wb.proj.proj_mask)
    # the lane-minor storage is the entity-major block, transposed
    b = got.blocks[0]
    if b.lanes.dense is not None:
        np.testing.assert_array_equal(_np(b.lanes.dense.permute(2, 0, 1)),
                                      _np(b.X))


# ------------------------------------------------------ per-entity solves
def _re_pair(shard, ropt, popt, variance="none", projection=None,
             normalization=None, n=600, **build_kw):
    ref, port = game_pair(raw_game(n=n))
    entity = "user" if shard == "u" else "item"
    rds = RGD.RandomEffectDataset.build(ref, entity, shard,
                                        projection=projection and projection[0],
                                        **build_kw)
    pds = GD.RandomEffectDataset.build(port, entity, shard,
                                       projection=projection and projection[1],
                                       device=CPU, **build_kw)
    rn = pn = None
    if normalization is not None:
        from photon_tpu.data import normalization as RN
        from photon_tpu_torch.data import normalization as N

        X = port.shards[shard]
        rX = ref.shards[shard]
        rn = RN.NormalizationContext.build(rX, RN.NormalizationType(
            normalization))
        pn = N.NormalizationContext.build(X, N.NormalizationType(
            normalization))
    rc = RRE.RandomEffectCoordinate(rds, RL.TaskType.LOGISTIC_REGRESSION,
                                    ropt, variance=RVar(variance),
                                    normalization=rn)
    pc = RE.RandomEffectCoordinate(pds, L.TaskType.LOGISTIC_REGRESSION,
                                   popt, variance=Var(variance),
                                   normalization=pn)
    offsets = (0.3 * np.random.default_rng(7).normal(size=ref.n)).astype(
        np.float32)
    return rc, pc, offsets


def assert_same_re(rm, rs, pm, ps, var=False):
    np.testing.assert_array_equal(ps.iterations_per_entity,
                                  np.asarray(rs.iterations_per_entity))
    assert (ps.n_converged, ps.n_failed, ps.total_iterations) == (
        rs.n_converged, rs.n_failed, rs.total_iterations)
    np.testing.assert_allclose(_np(pm.coefficients),
                               np.asarray(rm.coefficients), rtol=W_RTOL,
                               atol=W_ATOL)
    assert (pm.variances is None) == (rm.variances is None)
    if var:
        np.testing.assert_allclose(_np(pm.variances),
                                   np.asarray(rm.variances), rtol=VAR_RTOL)


@pytest.mark.parametrize("variance", ["none", "simple", "full"])
@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
@pytest.mark.parametrize("shard", ["u", "i"])
def test_per_entity_solves_match_reference(shard, opt, variance):
    """Every entity's coefficients and iteration count (and variances)
    equal the reference's vmapped single solves — on dense (users) and
    sparse (items) blocks, with a warm start."""
    # OWL-QN on an elastic net: an L2 part keeps every Hessian regular
    # (a feature absent from an entity's rows has only the L2 term)
    reg = "en" if opt == "owlqn" else "l2"
    ropt, popt = cfg_pair("lbfgs" if opt == "owlqn" else opt, reg=reg,
                          lam=0.5 if reg == "en" else 1.0)
    rc, pc, offsets = _re_pair(shard, ropt, popt, variance)
    d = rc.dataset.dim
    warm = np.full((rc.dataset.n_entities, d), 0.05, np.float32)
    rwarm = dataclasses.replace(
        rc.train(offsets)[0], coefficients=jnp.asarray(warm))
    pwarm = dataclasses.replace(
        pc.train(offsets)[0], coefficients=torch.from_numpy(warm))
    rm, rs = rc.train(offsets, warm_start=rwarm)
    pm, ps = pc.train(offsets, warm_start=pwarm)
    assert_same_re(rm, rs, pm, ps, var=variance != "none")


@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
@pytest.mark.parametrize("shard", ["u", "i"])
def test_per_entity_priors_match_reference(shard, opt):
    """A previous run's model (coefficients and SIMPLE variances) as
    per-entity priors aligned by key; one entity unseen in the prior."""
    reg = "en" if opt == "owlqn" else "l2"
    ropt, popt = cfg_pair("lbfgs" if opt == "owlqn" else opt, reg=reg,
                          lam=0.5 if reg == "en" else 1.0)
    rc, pc, offsets = _re_pair(shard, ropt, popt, "simple")
    rprev, _ = rc.train(offsets)
    pprev, _ = pc.train(offsets)
    keep = np.arange(1, rprev.n_entities)  # entity 0 unseen in the prior
    keys = rprev.entity_keys[keep]
    rprior = dataclasses.replace(
        rprev, coefficients=rprev.coefficients[keep],
        variances=rprev.variances[keep], entity_keys=keys,
        key_to_index={k: i for i, k in enumerate(keys.tolist())})
    pprior = dataclasses.replace(
        pprev, coefficients=pprev.coefficients[keep],
        variances=pprev.variances[keep], entity_keys=keys,
        key_to_index={k: i for i, k in enumerate(keys.tolist())})
    offs2 = offsets[::-1].copy()
    rm, rs = rc.train(offs2, prior=rprior)
    pm, ps = pc.train(offs2, prior=pprior)
    assert_same_re(rm, rs, pm, ps, var=True)
    # the precisions are 1 / each side's variances
    np.testing.assert_allclose(
        RE.align_entity_priors(pprior, pc.dataset.entity_keys,
                               pc.dataset.dim)[1],
        RRE.align_entity_priors(rprior, rc.dataset.entity_keys,
                                rc.dataset.dim)[1], rtol=VAR_RTOL)


@pytest.mark.parametrize("projection", ["index_map", "random"])
def test_projected_solves_match_reference(projection):
    """Solves in each bucket's projected space, projected back to the full
    space (INDEX_MAP with SIMPLE variances)."""
    kind = projection.upper()
    rp = RPJ.ProjectionConfig(RPJ.ProjectorType[kind], 6, seed=3)
    pp = PJ.ProjectionConfig(PJ.ProjectorType[kind], 6, seed=3)
    ropt, popt = cfg_pair()
    var = "simple" if projection == "index_map" else "none"
    rc, pc, offsets = _re_pair("i", ropt, popt, var, projection=(rp, pp))
    rm, rs = rc.train(offsets)
    pm, ps = pc.train(offsets)
    assert_same_re(rm, rs, pm, ps, var=var != "none")
    # a second solve warm-started through the projection, both sides from
    # the same start (the reference's first model)
    pstart = dataclasses.replace(pm, coefficients=torch.from_numpy(
        np.asarray(rm.coefficients)))
    rm2, rs2 = rc.train(offsets[::-1].copy(), warm_start=rm)
    pm2, ps2 = pc.train(offsets[::-1].copy(), warm_start=pstart)
    assert_same_re(rm2, rs2, pm2, ps2, var=var != "none")


def test_normalized_entity_solves_match_reference():
    ropt, popt = cfg_pair()
    rc, pc, offsets = _re_pair("u", ropt, popt, "simple",
                               normalization="standardization")
    rm, rs = rc.train(offsets)
    pm, ps = pc.train(offsets)
    assert_same_re(rm, rs, pm, ps, var=True)


def test_lane_chunks_do_not_change_results(monkeypatch):
    """A bucket solved in chunks of 3 entities gives every entity the
    result of one whole-bucket solve."""
    ropt, popt = cfg_pair()
    _, pc, offsets = _re_pair("u", ropt, popt, "simple")
    m1, s1 = pc.train(offsets)
    monkeypatch.setattr(RE, "LANE_ELEMS", 3 * max(b.m for b in
                                                  pc.dataset.blocks))
    assert RE.lane_chunk(pc.dataset.blocks[-1].m,
                         pc.dataset.blocks[-1].n_entities) <= 3
    m2, s2 = pc.train(offsets)
    np.testing.assert_array_equal(s1.iterations_per_entity,
                                  s2.iterations_per_entity)
    np.testing.assert_allclose(_np(m2.coefficients), _np(m1.coefficients),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(m2.variances), _np(m1.variances),
                               rtol=1e-6)


# --------------------------------------------------------- the estimator
def estimator_pair(task="logistic", fixed_opt="lbfgs", re_opt="lbfgs",
                   n_sweeps=2, **kw):
    fr, fp = cfg_pair(fixed_opt, iters=8,
                      reg="l1" if fixed_opt == "owlqn" else "l2",
                      lam=2.0 if fixed_opt == "owlqn" else 1.0)
    ur, up = cfg_pair(re_opt, lam=2.0)
    ir, ip = cfg_pair(re_opt, lam=3.0, iters=5)
    ref = RGE.GameEstimator(
        task=RL.TaskType(task), n_sweeps=n_sweeps, coordinate_configs={
            "fixed": RGE.FixedEffectConfig("fixed", fr),
            "per_user": RGE.RandomEffectConfig("user", "u", ur),
            "per_item": RGE.RandomEffectConfig("item", "i", ir)}, **kw)
    port = GE.GameEstimator(
        task=L.TaskType(task), n_sweeps=n_sweeps, device=CPU,
        coordinate_configs={
            "fixed": GE.FixedEffectConfig("fixed", fp),
            "per_user": GE.RandomEffectConfig("user", "u", up),
            "per_item": GE.RandomEffectConfig("item", "i", ip)},
        **{k: (Var(v.value) if isinstance(v, RVar) else v)
           for k, v in kw.items()})
    return ref, port


def assert_same_fit(rr, pr):
    np.testing.assert_allclose(pr.descent.objective_history,
                               rr.descent.objective_history, rtol=HIST_RTOL)
    for name, rmod in rr.model.coordinates.items():
        pmod = pr.model.coordinates[name]
        if isinstance(rmod, RGE.GameModel.__mro__[0]) or hasattr(rmod,
                                                                  "model"):
            np.testing.assert_allclose(_np(pmod.model.weights),
                                       np.asarray(rmod.model.weights),
                                       rtol=W_RTOL, atol=W_ATOL)
            rv = rmod.model.coefficients.variances
            if rv is not None:
                np.testing.assert_allclose(
                    _np(pmod.model.coefficients.variances), np.asarray(rv),
                    rtol=VAR_RTOL)
        else:
            np.testing.assert_array_equal(pmod.entity_keys, rmod.entity_keys)
            np.testing.assert_allclose(_np(pmod.coefficients),
                                       np.asarray(rmod.coefficients),
                                       rtol=W_RTOL, atol=W_ATOL)
            if rmod.variances is not None:
                np.testing.assert_allclose(_np(pmod.variances),
                                           np.asarray(rmod.variances),
                                           rtol=VAR_RTOL)
    for name, rstats in rr.descent.coordinate_stats.items():
        pstats = pr.descent.coordinate_stats[name]
        assert len(pstats) == len(rstats)
        for p, r in zip(pstats, rstats):
            if hasattr(r, "total_iterations"):
                assert p.total_iterations == r.total_iterations
            else:
                assert int(p.iterations) == int(r.iterations)


@pytest.mark.parametrize("task", ["logistic", "linear", "poisson"])
def test_two_sweep_fit_matches_reference(task):
    ref, port = game_pair(raw_game(task=task))
    rest, pest = estimator_pair(task)
    (rr,) = rest.fit(ref)
    (pr,) = pest.fit(port)
    assert len(pr.descent.objective_history) == 6
    assert_same_fit(rr, pr)
    # scoring what fit returns
    np.testing.assert_allclose(_np(score_game(pr.model, port)),
                               np.asarray(ref_score_game(rr.model, ref)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("opts", [("owlqn", "tron"), ("tron", "owlqn")])
def test_fit_with_other_solvers_and_variances_matches_reference(opts):
    ref, port = game_pair(raw_game(seed=2))
    rest, pest = estimator_pair(fixed_opt=opts[0], re_opt=opts[1],
                                variance=RVar.SIMPLE)
    (rr,) = rest.fit(ref)
    (pr,) = pest.fit(port)
    assert_same_fit(rr, pr)


def test_locked_and_incremental_match_reference():
    """A first fit's models: the fixed effect locked (scored only), the
    per-user effect incremental (its first model the prior of every
    sweep)."""
    ref, port = game_pair(raw_game(seed=4))
    rest, pest = estimator_pair(variance=RVar.SIMPLE)
    (rr,) = rest.fit(ref)
    (pr,) = pest.fit(port)
    rest2, pest2 = estimator_pair(variance=RVar.SIMPLE,
                                  locked=frozenset({"fixed"}),
                                  incremental=frozenset({"per_user"}))
    (rr2,) = rest2.fit(ref, initial_models=dict(rr.model.coordinates))
    (pr2,) = pest2.fit(port, initial_models=dict(pr.model.coordinates))
    assert_same_fit(rr2, pr2)
    assert "fixed" not in pr2.descent.coordinate_stats or \
        not pr2.descent.coordinate_stats["fixed"]
    assert pr2.model.coordinates["fixed"] is pr.model.coordinates["fixed"]


def grid_fits(raw, points):
    """(reference fits, port fits, port estimator) of one config grid
    over (user L2 weight, item cap) points, each warm-started from the
    previous, datasets and coordinates cached."""
    ref, port = game_pair(raw)
    rest, pest = estimator_pair(n_sweeps=1)
    rgrid, pgrid = [], []
    for lam, cap in points:
        for grid, est in ((rgrid, rest), (pgrid, pest)):
            base = est.coordinate_configs
            grid.append({
                "per_user": dataclasses.replace(
                    base["per_user"], optimizer=dataclasses.replace(
                        base["per_user"].optimizer, reg_weight=lam)),
                "per_item": dataclasses.replace(base["per_item"],
                                                active_cap=cap)})
    return (rest.fit(ref, config_grid=rgrid),
            pest.fit(port, config_grid=pgrid), pest, port)


def test_config_grid_with_warm_starts_matches_reference():
    """Three grid points varying the user L2 weight and the item cap:
    each warm-started from the previous, datasets and coordinates cached.
    The weights keep the chained solves well conditioned (the case below
    holds the ill-conditioned one)."""
    rres, pres, pest, port = grid_fits(raw_game(seed=6),
                                       ((1.0, None), (3.0, None), (3.0, 8)))
    assert len(pres) == 3
    for rr, pr in zip(rres, pres):
        assert_same_fit(rr, pr)
    assert len(pest._caches_for(port)[0]) == 4  # fixed, user, item, item@8
    assert pest.best_model(pres) is min(
        pres, key=lambda r: r.descent.objective_history[-1])


def test_config_grid_at_half_weight_within_the_reference_spread():
    """The grid with the user L2 weight at 0.5, where the chained solves
    are ill conditioned: a one-ulp change of the row weights moves the
    reference's own tables by up to 7.4e-6 here, about what f32 rounding
    moves them by. Iterations stay equal and histories within rtol 1e-5;
    each table lies within the stated tolerance of the reference's plus
    twice that one-ulp spread of the reference."""
    raw = raw_game(seed=6)
    points = ((0.5, None), (1.0, None), (0.5, 8))
    rres, pres, _, _ = grid_fits(raw, points)
    nudged = dict(raw, weights=np.nextafter(raw["weights"],
                                            np.float32(np.inf)))
    rres2, _, _, _ = grid_fits(nudged, points)
    spreads = []
    for rr, rr2, pr in zip(rres, rres2, pres):
        np.testing.assert_allclose(pr.descent.objective_history,
                                   rr.descent.objective_history,
                                   rtol=HIST_RTOL)
        for name, rmod in rr.model.coordinates.items():
            pmod, rmod2 = pr.model.coordinates[name], rr2.model.coordinates[
                name]
            if hasattr(rmod, "model"):
                a, a2, b = (np.asarray(rmod.model.weights),
                            np.asarray(rmod2.model.weights),
                            _np(pmod.model.weights))
            else:
                a, a2, b = (np.asarray(rmod.coefficients),
                            np.asarray(rmod2.coefficients),
                            _np(pmod.coefficients))
            spread = float(np.abs(a2 - a).max())
            spreads.append(spread)
            np.testing.assert_allclose(b, a, rtol=W_RTOL,
                                       atol=W_ATOL + 2 * spread,
                                       err_msg=name)
        for name, rstats in rr.descent.coordinate_stats.items():
            pstats = pr.descent.coordinate_stats[name]
            assert len(pstats) == len(rstats)
            for p, r in zip(pstats, rstats):
                if hasattr(r, "total_iterations"):
                    assert p.total_iterations == r.total_iterations
                else:
                    assert int(p.iterations) == int(r.iterations)
    assert max(spreads) > 0.0  # the nudge reached the reference


def test_unseen_entity_scores_zero():
    ref, port = game_pair(raw_game(seed=8))
    _, pest = estimator_pair(n_sweeps=1)
    (pr,) = pest.fit(port)
    new = GD.GameData.build(
        port.y[:3], shards={k: (v[:3] if isinstance(v, np.ndarray) else
                                M.SparseRows(v.indices[:3], v.values[:3],
                                             v.n_features))
                            for k, v in port.shards.items()},
        entity_ids={"user": np.asarray([10_000, port.entity_ids["user"][1],
                                        10_001]),
                    "item": np.asarray(["nope", "nope2", "nope3"])})
    from photon_tpu_torch.game.scoring import coordinate_scores

    s = coordinate_scores(pr.model, new)
    assert float(s["per_user"][0]) == 0.0 and float(s["per_user"][2]) == 0.0
    assert float(s["per_user"][1]) != 0.0
    assert np.all(_np(s["per_item"]) == 0.0)


# --------------------------------------------------------- what raises
def test_paths_not_ported_raise_with_their_item():
    """A mesh that is not a `parallel.mesh.Mesh` raises (meshes, item 10,
    are ported: tests/test_torch_game_mesh.py); validation data (item 7),
    the straggler re-solve and the cold reg-weight grid that the reference
    vectorizes (item 6) now fit, held against the reference."""
    ref, port = game_pair(raw_game(n=200))
    rest, pest = estimator_pair(n_sweeps=1)

    def raises(item, fn):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue A item {item}\\b"):
            fn()

    (rv,) = rest.fit(ref, validation=ref)
    (pv,) = pest.fit(port, validation=port)
    assert_same_fit(rv, pv)
    np.testing.assert_allclose(pv.validation_score, rv.validation_score,
                               rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        dataclasses.replace(pest, mesh=object()).fit(port)

    # a host-chunked fixed shard (item 5, now ported) fits, as the same
    # shard resident does (test_torch_streamed.py holds it against the
    # reference)
    chunked = dataclasses.replace(port, shards={
        **port.shards, "fixed": chunk_matrix(port.shards["fixed"], 64)})
    (streamed,) = pest.fit(chunked)
    (resident,) = pest.fit(port)
    np.testing.assert_allclose(streamed.descent.objective_history,
                               resident.descent.objective_history,
                               rtol=HIST_RTOL)
    # the straggler re-solve (item 6, now ported) fits as the reference's
    # (SIMPLE variances, as test_straggler_resolve_matches_reference's fit)
    fits = []
    for est, data, var in ((rest, ref, RVar.SIMPLE),
                           (pest, port, Var.SIMPLE)):
        straggle = {k: (dataclasses.replace(c, straggler_budget=2)
                        if hasattr(c, "straggler_budget") else c)
                    for k, c in est.coordinate_configs.items()}
        fits += dataclasses.replace(est, coordinate_configs=straggle,
                                    variance=var).fit(data)
    assert_same_fit(*fits)
    # a reg-weight grid without warm starts: the reference vectorizes it,
    # every grid point a lane of one coordinate descent
    grids = []
    for est in (rest, pest):
        base = est.coordinate_configs
        grids.append([{"fixed": dataclasses.replace(
            base["fixed"], optimizer=dataclasses.replace(
                base["fixed"].optimizer, reg_weight=w))} for w in (0.5, 1.0)])
    rcold = dataclasses.replace(rest, warm_start=False)
    cold = dataclasses.replace(pest, warm_start=False)
    assert cold.would_vectorize(grids[1])
    rres = rcold.fit(ref, config_grid=grids[0])
    pres = cold.fit(port, config_grid=grids[1])
    assert len(pres) == 2
    for rr, pr in zip(rres, pres):
        assert_same_fit(rr, pr)


@pytest.mark.parametrize("case", ["lbfgs-u", "lbfgs-i", "owlqn-u", "owlqn-i",
                                  "tron-u", "tron-i", "estimator"])
def test_straggler_resolve_matches_reference(case):
    """``straggler_budget=2``: every chunk's first pass stops at 2
    iterations and the lanes neither converged nor failed re-solve as one
    gathered block to ``max_iters`` from the capped pass's coefficients,
    with their priors; per-entity iterations (the two passes added),
    convergence, coefficients and SIMPLE variances equal the reference's,
    on dense (users) and sparse (items) blocks, through
    `RandomEffectCoordinate.train` and through `GameEstimator.fit`."""
    from photon_tpu_torch import telemetry

    telemetry.reset()
    if case == "estimator":
        rest, pest = estimator_pair(n_sweeps=1, variance=RVar.SIMPLE)
        ref, port = game_pair(raw_game(n=200))
        fits = []
        for est, data in ((rest, ref), (pest, port)):
            cfgs = {k: (dataclasses.replace(c, straggler_budget=2)
                        if hasattr(c, "straggler_budget") else c)
                    for k, c in est.coordinate_configs.items()}
            fits += dataclasses.replace(est, coordinate_configs=cfgs).fit(
                data)
        assert_same_fit(*fits)
    else:
        opt, shard = case.split("-")
        reg = "en" if opt == "owlqn" else "l2"
        ropt, popt = cfg_pair("lbfgs" if opt == "owlqn" else opt, reg=reg,
                              lam=0.5 if reg == "en" else 1.0, iters=10)
        rc, pc, offsets = _re_pair(shard, ropt, popt, "simple", n=200,
                                   max_blocks=1)
        d = rc.dataset.dim
        rng = np.random.default_rng(3)
        prev = (0.3 * rng.normal(size=(rc.dataset.n_entities, d))).astype(
            np.float32)
        var = rng.uniform(0.2, 2.0, size=prev.shape).astype(np.float32)
        keys = rc.dataset.entity_keys
        k2i = {k: i for i, k in enumerate(keys.tolist())}
        from photon_tpu.game.model import RandomEffectModel as RREM
        from photon_tpu_torch.game.model import RandomEffectModel as REM

        common = dict(entity_name=rc.dataset.entity_name,
                      feature_shard=rc.dataset.shard_name, entity_keys=keys,
                      key_to_index=k2i)
        rprior = RREM(task=RL.TaskType.LOGISTIC_REGRESSION,
                      coefficients=jnp.asarray(prev),
                      variances=jnp.asarray(var), **common)
        pprior = REM(task=L.TaskType.LOGISTIC_REGRESSION,
                     coefficients=torch.from_numpy(prev),
                     variances=torch.from_numpy(var), **common)
        rc = dataclasses.replace(rc, straggler_budget=2)
        pc = dataclasses.replace(pc, straggler_budget=2)
        rm, rs = rc.train(offsets, prior=rprior)
        pm, ps = pc.train(offsets, prior=pprior)
        assert_same_re(rm, rs, pm, ps, var=True)
    counters = telemetry.snapshot()["counters"]
    assert counters["game_re.straggler_entities"] > 0
    assert counters["game_re.tail_resolves"] > 0
    assert "game_re.iters_saved" in counters


@pytest.mark.parametrize("case", ["warm", "cold", "forced", "off", "skewed",
                                  "fixed_only", "locked", "normalized"])
def test_would_vectorize_gives_the_reference_answer(case):
    ref, port = game_pair(raw_game(n=200))
    rest, pest = estimator_pair(n_sweeps=1)
    kw = {"warm": {}, "cold": {"warm_start": False},
          "forced": {"vectorized_grid": True},
          "off": {"vectorized_grid": False, "warm_start": False},
          "skewed": {"warm_start": False}, "fixed_only": {"warm_start": False},
          "locked": {"warm_start": False, "locked": frozenset({"fixed"})},
          "normalized": {"warm_start": False}}[case]
    rest = dataclasses.replace(rest, **kw)
    pest = dataclasses.replace(pest, **kw)
    if case == "fixed_only":
        rest = dataclasses.replace(rest, coordinate_configs={
            "fixed": rest.coordinate_configs["fixed"]})
        pest = dataclasses.replace(pest, coordinate_configs={
            "fixed": pest.coordinate_configs["fixed"]})
    if case == "normalized":
        from photon_tpu.data.normalization import NormalizationType as RNT
        from photon_tpu_torch.data.normalization import NormalizationType as NT

        rest = dataclasses.replace(rest, normalization={
            "fixed": RNT.STANDARDIZATION})
        pest = dataclasses.replace(pest, normalization={
            "fixed": NT.STANDARDIZATION})
    weights = (1e-3, 100.0) if case == "skewed" else (0.5, 1.0)

    def grid(est):
        base = est.coordinate_configs["fixed"]
        return [{"fixed": dataclasses.replace(base, optimizer=dataclasses.
                                              replace(base.optimizer,
                                                      reg_weight=w))}
                for w in weights]

    for data_r, data_p in ((None, None), (ref, port)):
        assert pest.would_vectorize(grid(pest), data=data_p) == \
            rest.would_vectorize(grid(rest), data=data_r)


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    _, port = game_pair(raw_game(n=100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GE.GameEstimator(task=L.TaskType.LOGISTIC_REGRESSION,
                         coordinate_configs={"fixed": GE.FixedEffectConfig(
                             "fixed")}).fit(port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GD.RandomEffectDataset.build(port, "user", "u")


@pytest.mark.parametrize("square", [False, True])
def test_sparse_entity_passes_sum_each_lane_by_column(square):
    """A sparse block's lane Xᵀr (or (X∘X)ᵀr) sums each column by a
    segmented scan over the lane's slots sorted by column: each lane
    equals its entity's own `SparseRows` pass (duplicate columns in a
    row, columns a lane never touches), a lane slice gives its lanes'
    bits, and the lane Gram matrices equal the dense ones."""
    rng = np.random.default_rng(21)
    m, k, E, d = 7, 3, 5, 9
    ind = rng.integers(0, d - 2, size=(m, k, E))  # columns d-2, d-1 unused
    ind[:, 1] = ind[:, 0]  # every row repeats its first column
    val = rng.normal(size=(m, k, E)).astype(np.float32)
    X = M.EntityBlocks(None, torch.from_numpy(ind), torch.from_numpy(val), d)
    R = torch.from_numpy(rng.normal(size=(m, E)).astype(np.float32))
    got = X.rmatvec_lanes(R, square=square)
    v = val.astype(np.float64) ** (2 if square else 1)
    for e in range(E):
        one = M.SparseRows(torch.from_numpy(ind[:, :, e].copy()),
                           torch.from_numpy(val[:, :, e].copy()), d)
        fn = M.sq_rmatvec if square else M.rmatvec
        np.testing.assert_allclose(got[:, e].numpy(),
                                   fn(one, R[:, e].contiguous()).numpy(),
                                   rtol=1e-6, atol=1e-6)
        want = np.zeros(d)
        np.add.at(want, ind[:, :, e].ravel(),
                  (v[:, :, e] * R[:, e].numpy()[:, None]).ravel())
        np.testing.assert_allclose(got[:, e].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    assert np.all(got[d - 2:].numpy() == 0.0)
    part = X.lanes(1, 4).rmatvec_lanes(R[:, 1:4].contiguous(), square=square)
    assert torch.equal(part, got[:, 1:4])
    dense = np.zeros((m, d, E), np.float32)
    for s in range(k):
        np.add.at(dense, (np.arange(m)[:, None], ind[:, s], np.arange(E)),
                  val[:, s])
    gram = X.weighted_gram_lanes(R)
    np.testing.assert_allclose(
        gram.numpy(), np.einsum("mde,me,mfe->edf", dense, R.numpy(), dense),
        rtol=1e-5, atol=1e-5)
