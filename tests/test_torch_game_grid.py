"""The port's validation-driven model selection and vectorized GAME grids
against the JAX package.

On the same numpy-seeded data (the GAME fixture of `test_torch_game.py`
and a held-out draw beside it):

- `GameEstimator.fit(validation=...)` on the sequential (warm-started)
  path: each grid point's ``validation_score`` within 1e-5 of the
  reference's and the same `best_model`, under AUC and SHARDED_AUC;
- the one-program fixed-effect grid (`_fit_fixed_grid`) on dense,
  `SparseRows` and `BlockedEllRows` shards (the kernels' plain versions
  on the CPU): per-lane iterations equal, objectives and loss histories
  within rtol 1e-5, coefficients within rtol 1e-4 (atol 1e-4),
  validation scores within 1e-5;
- the lane-axis GAME grid (`game.grid.fit_game_grid`) over two sweeps with
  SIMPLE variances, on L2 lanes (the user weight) and on an L1 lane set
  (OWL-QN on the fixed effect): per lane the objective history within
  rtol 1e-5, the fixed coefficients and every entity table within rtol
  1e-4 (atol 1e-5), variances within rtol 1e-4, iterations equal, and the
  validation scores within 1e-5;
- `evaluate_glm_grid`'s pick and scores;
- an `EntityBlocks` with G lanes per entity against the same block with
  each lane's entity alone (its rows shared, not copied).

The entity solves stop at a relative progress of 1e-3, as in
`test_torch_game.py`: these small problems reach the f32 floor within a
few iterations, where two f32 paths stop or step on rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_game as TG  # noqa: E402  (aliases jax.core first)
from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.evaluation import evaluator as REV  # noqa: E402
from photon_tpu.game import dataset as RGD  # noqa: E402
from photon_tpu.game import estimator as RGE  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import losses as RL  # noqa: E402

from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.evaluation import evaluator as PEV  # noqa: E402
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game import estimator as GE  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402

CPU = "cpu"
VAL_ATOL = 1e-5
W_RTOL = 1e-4
# the fixed-effect grid's coefficients: its lightest lane (L2 0.3 over 80
# features) leaves a poorly determined coefficient moving by a few 1e-5
# in its last L-BFGS step under another summation order (histories agree
# within 1e-5); the lane grid's own tests hold coefficients to 1e-3
FIXED_GRID_ATOL = 1e-4
_np = TG._np


def _evaluators(kind: str):
    return (REV.Evaluator(REV.EvaluatorType[kind]),
            PEV.Evaluator(PEV.EvaluatorType[kind]))


def _with_weight(base, name: str, w: float) -> dict:
    cfg = base[name]
    return {name: dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, reg_weight=w))}


def _grids(rest, pest, name: str, weights) -> tuple:
    return ([_with_weight(rest.coordinate_configs, name, w) for w in weights],
            [_with_weight(pest.coordinate_configs, name, w) for w in weights])


def _assert_same_selection(rest, pest, rres, pres):
    np.testing.assert_allclose([r.validation_score for r in pres],
                               [r.validation_score for r in rres],
                               rtol=0, atol=VAL_ATOL)
    pbest, rbest = pest.best_model(pres), rest.best_model(rres)
    assert [r is pbest for r in pres] == [r is rbest for r in rres]


def _vectorized_lanes(fn):
    telemetry.reset()
    out = fn()
    return out, telemetry.snapshot()["counters"].get(
        "game.grid_vectorized_lanes", 0)


# ------------------------------------------------- the sequential path
@pytest.mark.parametrize("kind", ["AUC", "SHARDED_AUC"])
def test_sequential_fit_with_validation_matches_reference(kind):
    ref, port = TG.game_pair(TG.raw_game(seed=10, n=400))
    rval, pval = TG.game_pair(TG.raw_game(seed=11, n=300))
    rest, pest = TG.estimator_pair(n_sweeps=1)
    rev, pev = _evaluators(kind)
    rest = dataclasses.replace(rest, evaluator=rev)
    pest = dataclasses.replace(pest, evaluator=pev)
    rgrid, pgrid = _grids(rest, pest, "per_user", (0.5, 2.0, 8.0))
    assert not pest.would_vectorize(pgrid)  # warm starts: sequential
    rres = rest.fit(ref, validation=rval, config_grid=rgrid)
    pres, lanes = _vectorized_lanes(
        lambda: pest.fit(port, validation=pval, config_grid=pgrid))
    assert lanes == 0
    for rr, pr in zip(rres, pres):
        TG.assert_same_fit(rr, pr)
    _assert_same_selection(rest, pest, rres, pres)
    # no validation: the objective decides, as before
    assert pest.best_model(pest.fit(port, config_grid=pgrid[:1])) is not None


# ------------------------------------------- the fixed-effect grid path
def sparse_fixed(seed: int, n: int, d: int = 80, k: int = 6,
                 w_true=None):
    """Zipf sparse rows (intercept last) and labels from ``w_true`` (drawn
    from ``seed`` when None); returns (ind, val, y, w_true)."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(1.4, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    ind = np.concatenate([col, np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    if w_true is None:
        w_true = (rng.normal(size=d) / np.sqrt(np.arange(1, d + 1))).astype(
            np.float32)
    margin = np.einsum("nk,nk->n", val, w_true[ind])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return ind, val, y, w_true


def _fixed_data(layout: str, ind, val, y, d: int = 80):
    if layout == "dense":
        X = np.zeros((len(y), d), np.float32)
        np.add.at(X, (np.arange(len(y))[:, None], ind), val)
        shards = (X, X)
    elif layout == "sparse":
        shards = (RM.SparseRows(ind, val, d), M.SparseRows(ind, val, d))
    else:
        shards = (RM.to_blocked_ell(RM.SparseRows(ind, val, d), 16),
                  M.to_blocked_ell(M.SparseRows(ind, val, d), 16,
                                   device=CPU))
    return (RGD.GameData.build(y, shards={"fixed": shards[0]}),
            GD.GameData.build(y, shards={"fixed": shards[1]}))


@pytest.mark.parametrize("layout", ["dense", "sparse", "bell"])
def test_fixed_grid_matches_reference(layout):
    ind, val, y, w_true = sparse_fixed(20, 500)
    ref, port = _fixed_data(layout, ind, val, y)
    vind, vval, vy, _ = sparse_fixed(21, 300, w_true=w_true)
    rval, pval = _fixed_data(layout, vind, vval, vy)
    rcfg, pcfg = TG.cfg_pair(iters=15)
    rest = RGE.GameEstimator(
        task=RL.TaskType.LOGISTIC_REGRESSION, n_sweeps=1, warm_start=False,
        coordinate_configs={"fixed": RGE.FixedEffectConfig("fixed", rcfg)})
    pest = GE.GameEstimator(
        task=L.TaskType.LOGISTIC_REGRESSION, n_sweeps=1, warm_start=False,
        device=CPU,
        coordinate_configs={"fixed": GE.FixedEffectConfig("fixed", pcfg)})
    rgrid, pgrid = _grids(rest, pest, "fixed", (0.3, 3.0, 30.0))
    rres = rest.fit(ref, validation=rval, config_grid=rgrid)
    pres, lanes = _vectorized_lanes(
        lambda: pest.fit(port, validation=pval, config_grid=pgrid))
    assert lanes == 3
    for rr, pr in zip(rres, pres):
        assert pr.configs["fixed"].optimizer.reg_weight == \
            rr.configs["fixed"].optimizer.reg_weight
        np.testing.assert_allclose(pr.descent.objective_history,
                                   rr.descent.objective_history,
                                   rtol=TG.HIST_RTOL)
        (rs,), (ps,) = (rr.descent.coordinate_stats["fixed"],
                        pr.descent.coordinate_stats["fixed"])
        assert int(ps.iterations) == int(rs.iterations)
        np.testing.assert_allclose(ps.history(), TG._np(rs.loss_history)[
            ~np.isnan(TG._np(rs.loss_history))], rtol=TG.HIST_RTOL)
        np.testing.assert_allclose(
            _np(pr.model["fixed"].model.weights),
            np.asarray(rr.model["fixed"].model.weights), rtol=W_RTOL,
            atol=FIXED_GRID_ATOL)
    _assert_same_selection(rest, pest, rres, pres)


# ------------------------------------------------- the lane-axis grid
@pytest.mark.parametrize("lanes", ["l2", "l1"])
def test_game_grid_matches_reference(lanes):
    """Two sweeps, SIMPLE variances, every grid point a lane: L2 lanes on
    the per-user weight, or an L1 lane set on the fixed effect (every
    fixed lane on OWL-QN)."""
    ref, port = TG.game_pair(TG.raw_game(seed=12, n=400))
    rval, pval = TG.game_pair(TG.raw_game(seed=13, n=300))
    rest, pest = TG.estimator_pair(
        n_sweeps=2, variance=RVar.SIMPLE, warm_start=False,
        fixed_opt="owlqn" if lanes == "l1" else "lbfgs")
    name, weights = (("per_user", (1.0, 2.0, 4.0)) if lanes == "l2"
                     else ("fixed", (0.5, 2.0, 8.0)))
    rgrid, pgrid = _grids(rest, pest, name, weights)
    assert pest.would_vectorize(pgrid, data=port)
    rres = rest.fit(ref, validation=rval, config_grid=rgrid)
    pres, n_lanes = _vectorized_lanes(
        lambda: pest.fit(port, validation=pval, config_grid=pgrid))
    assert n_lanes == 3
    for rr, pr in zip(rres, pres):
        TG.assert_same_fit(rr, pr)
        for st in pr.descent.coordinate_stats["per_item"]:
            assert int(st.iterations_per_entity.sum()) == st.total_iterations
    _assert_same_selection(rest, pest, rres, pres)


def test_evaluate_glm_grid_matches_reference():
    ind, val, y, w_true = sparse_fixed(30, 400)
    vind, vval, vy, _ = sparse_fixed(31, 300, w_true=w_true)
    rcfg, pcfg = TG.cfg_pair(iters=10, tol=0.0, lam=0.0)
    weights = (0.1, 1.0, 10.0)
    rX, pX = (RM.SparseRows(ind, val, 80), M.SparseRows(ind, val, 80))
    rgrid = RT.train_glm_grid(RD.make_batch(rX, y),
                              RL.TaskType.LOGISTIC_REGRESSION, rcfg, weights)
    pgrid = T.train_glm_grid(make_batch(pX, y, device=CPU),
                             L.TaskType.LOGISTIC_REGRESSION, pcfg, weights,
                             device=CPU)
    for kind in ("AUC", "LOGISTIC_LOSS"):
        rev, pev = _evaluators(kind)
        rbest, rscores = RT.evaluate_glm_grid(
            rgrid, RD.make_batch(RM.SparseRows(vind, vval, 80), vy), rev)
        pbest, pscores = T.evaluate_glm_grid(
            pgrid, make_batch(M.SparseRows(vind, vval, 80), vy, device=CPU),
            pev)
        assert pbest == rbest
        np.testing.assert_allclose(pscores, rscores, rtol=0, atol=VAL_ATOL)


# ------------------------------------------------ entity lanes of a grid
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_grid_entity_lanes_share_their_entity_rows(form):
    """With G lanes per entity, lane e·G + g is entity e's rows times lane
    (e, g)'s coefficients: equal to the one-lane-per-entity block on each
    entity, one grid point at a time."""
    rng = np.random.default_rng(40)
    m, d, k, E, G = 8, 6, 3, 5, 3
    if form == "dense":
        blk = M.EntityBlocks(torch.from_numpy(
            rng.normal(size=(m, d, E)).astype(np.float32)), None, None, d)
    else:
        blk = M.EntityBlocks(
            None, torch.from_numpy(rng.integers(0, d, size=(m, k, E)).astype(
                np.int32)),
            torch.from_numpy(rng.normal(size=(m, k, E)).astype(np.float32)),
            d)
    grid = blk.grid(G)
    W = torch.from_numpy(rng.normal(size=(d, E * G)).astype(np.float32))
    R = torch.from_numpy(rng.normal(size=(m, E * G)).astype(np.float32))
    z = grid.matvec_lanes(W).reshape(m, E, G)
    for g in range(G):
        Wg = W.reshape(d, E, G)[:, :, g].contiguous()
        Rg = R.reshape(m, E, G)[:, :, g].contiguous()
        np.testing.assert_allclose(z[:, :, g], blk.matvec_lanes(Wg),
                                   rtol=1e-6, atol=1e-6)
        for square in (False, True):
            got = grid.rmatvec_lanes(R, square=square).reshape(d, E, G)
            np.testing.assert_allclose(got[:, :, g],
                                       blk.rmatvec_lanes(Rg, square=square),
                                       rtol=1e-6, atol=1e-6)
    sub = grid.lanes(1, 3)
    assert sub.lanes_per_entity == G
    np.testing.assert_allclose(
        sub.matvec_lanes(W[:, G:3 * G].contiguous()),
        grid.matvec_lanes(W)[:, G:3 * G], rtol=1e-6, atol=1e-6)
