"""The port's priors, normalization, FULL variances and the SparseRows X
passes against the JAX package.

On the same numpy-seeded data (a few hundred rows, d <= 32): the
`PriorDistribution` constructors, `NormalizationContext.build` for each
type on dense X and `SparseRows` (and the coefficient, row and variance
space conversions), the objective's value, gradient, Hessian-vector
product, Hessian diagonal and full Hessian with normalization folded in
and with a full-covariance prior, the `SparseRows` passes (single and
lanes) and `weighted_gram`, `train_glm` with diagonal and full priors,
with normalization on L-BFGS, OWL-QN and TRON, and with FULL variances,
and `train_glm_grid` with normalization. Loss histories within rtol 1e-5
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

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.data import normalization as RN  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import prior as RP  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data import normalization as N  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var)
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import prior as P  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402

CPU = "cpu"
HIST_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-5
VAR_RTOL = 1e-4
NTYPES = [t.value for t in N.NormalizationType]


def dense_xy(seed=0, n=300, d=16, task="logistic", spread=200.0):
    """Dense rows with columns of unlike scales (``spread`` from the
    smallest to the largest) and means (intercept last), and labels from a
    planted model of ``task``. The solves without normalization take a
    small spread: on an ill-conditioned X f32 rounding alone parts two
    TRON solves within a few CG steps."""
    rng = np.random.default_rng(seed)
    scale = np.geomspace(1.0 / np.sqrt(spread), np.sqrt(spread),
                         d - 1).astype(np.float32)
    shift = rng.normal(size=d - 1).astype(np.float32)
    X = (rng.normal(size=(n, d - 1)) * scale + shift).astype(np.float32)
    X = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
    w = (rng.normal(size=d) / (1.0 + np.abs(np.concatenate(
        [scale, [1.0]]) * 2.0))).astype(np.float32)
    margin = X @ w
    if task == "linear":
        y = (margin + rng.normal(size=n)).astype(np.float32)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(margin, -3, 2))).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(
            np.float32)
    return X, y


def sparse_rows(seed=1, n=300, d=32, k=6):
    """Padded COO rows (two padding slots, intercept last; no column twice
    in a row, where (X∘X)ᵀ and the Gram's diagonal would part) with unlike
    column scales, and planted logistic labels."""
    rng = np.random.default_rng(seed)
    col = np.argsort(rng.uniform(size=(n, d - 1)), axis=1)[:, :k]
    val = (rng.normal(size=(n, k)) * (1.0 + col % 5)).astype(np.float32)
    col[:, -2:], val[:, -2:] = 0, 0.0
    ind = np.concatenate([col, np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    w = (0.3 * rng.normal(size=d)).astype(np.float32)
    margin = np.einsum("nk,nk->n", val, w[ind])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return ind, val, d, y


def batches(X, y, offsets=None):
    """(reference batch, port batch) of dense X or (ind, val, d) rows."""
    if isinstance(X, tuple):
        ind, val, d = X
        rX, pX = RM.SparseRows(ind, val, d), M.SparseRows(
            torch.from_numpy(ind), torch.from_numpy(val), d)
    else:
        rX, pX = X, X
    return (RD.make_batch(rX, y, offsets=offsets),
            D.make_batch(pX, y, offsets=offsets, device=CPU))


def contexts(X, kind):
    """(reference context, port context) of one normalization type."""
    rX = RM.SparseRows(*X) if isinstance(X, tuple) else X
    pX = M.SparseRows(*X) if isinstance(X, tuple) else X
    return (RN.NormalizationContext.build(rX, RN.NormalizationType(kind)),
            N.NormalizationContext.build(pX, N.NormalizationType(kind)))


def close(got, want, rtol=1e-5, atol_frac=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_frac * max(1.0, float(np.abs(want).max(initial=0.0))))


def _close_folded(got, want):
    close_base(got, want, atol_frac=1e-5)


close_base = close


# ------------------------------------------------------------------ prior
def test_prior_constructors_match_reference():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=12).astype(np.float32)
    var = rng.uniform(0.0, 2.0, size=12).astype(np.float32)
    var[3] = 0.0
    var[5] = -1.0
    H = rng.normal(size=(12, 12)).astype(np.float32)
    H = H @ H.T
    pairs = [
        (P.PriorDistribution.from_coefficients(mu),
         RP.PriorDistribution.from_coefficients(mu)),
        (P.PriorDistribution.from_coefficients(mu, var, scale=0.5),
         RP.PriorDistribution.from_coefficients(mu, var, scale=0.5)),
        (P.PriorDistribution.from_variances(mu, var, scale=2.0),
         RP.PriorDistribution.from_variances(mu, var, scale=2.0)),
        (P.PriorDistribution.from_variances(mu[None].repeat(3, 0),
                                            var[None].repeat(3, 0)),
         RP.PriorDistribution.from_variances(mu[None].repeat(3, 0),
                                             var[None].repeat(3, 0))),
        (P.PriorDistribution.from_hessian(mu, H, scale=0.3),
         RP.PriorDistribution.from_hessian(mu, H, scale=0.3)),
    ]
    for got, want in pairs:
        assert got.dim == want.dim
        for f in ("mean", "precision_diag", "precision_full"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="not both"):
        P.PriorDistribution(mu, mu, H)
    with pytest.raises(ValueError, match="variances"):
        P.PriorDistribution.from_variances(mu, None)
    with pytest.raises(ValueError, match="shape"):
        P.PriorDistribution.from_variances(mu, var[:5])


# ---------------------------------------------------------- normalization
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("kind", NTYPES)
def test_normalization_context_matches_reference(kind, layout):
    """Factors and shifts bit for bit (the same numpy statistics), and the
    coefficient, row and variance conversions with them."""
    if layout == "dense":
        X, _ = dense_xy()
    else:
        ind, val, d, _ = sparse_rows()
        X = (ind, val, d)
    rc, pc = contexts(X, kind)
    assert pc.norm_type.value == rc.norm_type.value
    assert pc.is_identity == rc.is_identity
    assert pc.intercept_index == rc.intercept_index
    for f in ("factors", "shifts"):
        a, b = getattr(pc, f), getattr(rc, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    d = X.shape[1] if layout == "dense" else X[2]
    rng = np.random.default_rng(5)
    W = rng.normal(size=(4, d)).astype(np.float32)
    np.testing.assert_array_equal(pc.rows_to_original_space(W),
                                  rc.rows_to_original_space(W))
    np.testing.assert_array_equal(pc.rows_to_normalized_space(W),
                                  rc.rows_to_normalized_space(W))
    np.testing.assert_array_equal(pc.to_original_space(torch.from_numpy(
        W[0])), rc.to_original_space(W[0]))
    np.testing.assert_array_equal(pc.to_normalized_space(W[1]),
                                  rc.to_normalized_space(W[1]))
    v = np.abs(W)
    np.testing.assert_array_equal(pc.variances_to_original_space(v),
                                  rc.variances_to_original_space(v))


def test_normalization_refusals():
    X, _ = dense_xy()
    with pytest.raises(ValueError, match="intercept"):
        N.NormalizationContext.build(
            X, N.NormalizationType.STANDARDIZATION, intercept_index=None)
    with pytest.raises(ValueError, match="intercept_index"):
        N.NormalizationContext(N.NormalizationType.STANDARDIZATION,
                               shifts=np.zeros(3, np.float32))
    ind, val, d, _ = sparse_rows()
    bell = M.to_blocked_ell(M.SparseRows(ind, val, d), 8, device=CPU)
    with pytest.raises(TypeError, match="BlockedEllRows"):
        N.NormalizationContext.build(bell,
                                     N.NormalizationType.STANDARDIZATION)
    assert N.NormalizationContext.build(
        X, N.NormalizationType.NONE).is_identity


# ------------------------------------------------------------- objective
def _objective_pair(d, norm_pair=None, full=False, diag=False, seed=3):
    """(reference, port) objectives with an L2 weight, the intercept out
    of the mask, normalization and/or priors."""
    rng = np.random.default_rng(seed)
    cfg = dict(reg_weight=0.7, regularize_intercept=False)
    rcfg = RConfig(reg=RReg.l2(), **cfg)
    pcfg = OptimizerConfig(reg=Reg.l2(), **cfg)
    mu = rng.normal(size=d).astype(np.float32)
    kw_r, kw_p = {}, {}
    if diag:
        tau = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
        kw_r.update(prior_mean=jnp.asarray(mu), prior_precision=jnp.asarray(
            tau))
        kw_p.update(prior_mean=mu, prior_precision=tau)
    if full:
        A = rng.normal(size=(d, d)).astype(np.float32)
        Pm = (A @ A.T / d).astype(np.float32)
        kw_r.update(prior_mean=jnp.asarray(mu), prior_full_precision=Pm)
        kw_p.update(prior_mean=mu, prior_full_precision=Pm)
    rn = pn = None
    if norm_pair is not None:
        rn, pn = norm_pair
    ro = RT.make_objective(RL.TaskType.LOGISTIC_REGRESSION, rcfg, d,
                           normalization=rn, **kw_r)
    po = T.make_objective(L.TaskType.LOGISTIC_REGRESSION, pcfg, d,
                          normalization=pn, device=CPU, **kw_p)
    return ro, po


@pytest.mark.parametrize("case", ["standardization", "scale_max", "full_prior",
                                  "diag_prior_std", "sparse_std"])
def test_objective_with_normalization_and_priors_matches_reference(case):
    if case == "sparse_std":
        ind, val, d, y = sparse_rows()
        X = (ind, val, d)
    else:
        X, y = dense_xy()
        d = X.shape[1]
    norm = {"standardization": "standardization",
            "scale_max": "scale_with_max_magnitude",
            "diag_prior_std": "standardization",
            "sparse_std": "standardization"}.get(case)
    pair = contexts(X, norm) if norm else None
    ro, po = _objective_pair(d, pair, full=case == "full_prior",
                             diag=case == "diag_prior_std")
    offsets = np.random.default_rng(9).normal(size=len(y)).astype(np.float32)
    rb, pb = batches(X, y, offsets)
    rng = np.random.default_rng(4)
    w = (0.2 * rng.normal(size=d)).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    wr, wp = jnp.asarray(w), torch.from_numpy(w)
    vr, vp = jnp.asarray(v), torch.from_numpy(v)
    # The shift fold subtracts s·Σr from Xᵀr: sums over 300 rows of
    # values near 60 that cancel to ~100, so each side keeps f32's error
    # of the uncancelled sum (~1e-4 absolute): 1e-5 of the largest output.
    close = _close_folded
    fr, gr = ro.value_and_grad(wr, rb)
    fp, gp = po.value_and_grad(wp, pb)
    close(fp, fr)
    close(gp, gr)
    close(po.margin(wp, pb), ro.margin(wr, rb))
    close(po.direction_margin(vp, pb), ro.direction_margin(vr, rb))
    close(torch.stack(po.ray_reg_coeffs(wp, vp)),
          np.stack([np.asarray(c) for c in ro.ray_reg_coeffs(wr, vr)]))
    close(po.hvp(wp, pb, vp), ro.hvp(wr, rb, vr))
    close(po.hess_diag(wp, pb), ro.hess_diag(wr, rb))
    close(po.full_hessian(wp, pb), ro.full_hessian(wr, rb))
    # the Hessian's diagonal is hess_diag, and H·v the HVP
    H = po.full_hessian(wp, pb)
    close(torch.diagonal(H), po.hess_diag(wp, pb).numpy())
    close(H @ vp, po.hvp(wp, pb, vp).numpy())


# ------------------------------------------------------------- X passes
def test_sparse_rows_passes_match_reference():
    ind, val, d, _ = sparse_rows(n=200)
    rX = RM.SparseRows(ind, val, d)
    pX = M.SparseRows(torch.from_numpy(ind), torch.from_numpy(val), d)
    rng = np.random.default_rng(2)
    r = rng.normal(size=200).astype(np.float32)
    W = rng.normal(size=(d, 3)).astype(np.float32)
    R = rng.normal(size=(200, 3)).astype(np.float32)
    close(M.rmatvec(pX, torch.from_numpy(r)), RM.rmatvec(rX, jnp.asarray(r)))
    close(M.sq_rmatvec(pX, torch.from_numpy(r)),
          RM.sq_rmatvec(rX, jnp.asarray(r)))
    close(M.matvec_lanes(pX, torch.from_numpy(W)),
          RM.matvec_lanes(rX, jnp.asarray(W)))
    close(M.rmatvec_lanes(pX, torch.from_numpy(R)),
          RM.rmatvec_lanes(rX, jnp.asarray(R)))
    for g in range(3):  # lanes = single passes
        close(M.rmatvec_lanes(pX, torch.from_numpy(R))[:, g],
              M.rmatvec(pX, torch.from_numpy(R[:, g].copy())).numpy())


@pytest.mark.parametrize("layout", ["dense", "dense_bf16", "sparse",
                                    "blocked_ell"])
def test_weighted_gram_matches_reference(layout):
    rng = np.random.default_rng(6)
    r = rng.uniform(0.1, 1.0, size=300).astype(np.float32)
    if layout.startswith("dense"):
        X, _ = dense_xy(d=12)
        rX, pX = X, torch.from_numpy(X)
        if layout == "dense_bf16":
            rX, pX = jnp.asarray(X, jnp.bfloat16), pX.to(torch.bfloat16)
    else:
        ind, val, d, _ = sparse_rows()
        rX, pX = RM.SparseRows(ind, val, d), M.SparseRows(
            torch.from_numpy(ind), torch.from_numpy(val), d)
        if layout == "blocked_ell":
            rX, pX = RM.to_blocked_ell(rX, 8), M.to_blocked_ell(pX, 8,
                                                                device=CPU)
    close(M.weighted_gram(pX, torch.from_numpy(r)),
          RM.weighted_gram(rX, jnp.asarray(r)))


def test_weighted_gram_refuses_wide_sparse_rows():
    d = M.MAX_GRAM_FEATURES + 1
    X = M.SparseRows(torch.zeros((4, 2), dtype=torch.int32),
                     torch.ones((4, 2)), d)
    with pytest.raises(ValueError, match="MAX_GRAM_FEATURES"):
        M.weighted_gram(X, torch.ones(4))


@pytest.mark.parametrize("layout", ["dense", "sparse", "blocked_ell"])
def test_last_column_is_intercept_matches_reference(layout):
    X, _ = dense_xy()
    ind, val, d, _ = sparse_rows()
    for with_icpt in (True, False):
        if layout == "dense":
            Xi = X if with_icpt else X[:, :-1]
            got, want = (M.last_column_is_intercept(torch.from_numpy(Xi)),
                         RM.last_column_is_intercept(Xi))
        else:
            v = val if with_icpt else np.where(ind == d - 1, 2.0, val).astype(
                np.float32)
            rX, pX = RM.SparseRows(ind, v, d), M.SparseRows(ind, v, d)
            if layout == "blocked_ell":
                rX = RM.to_blocked_ell(rX, 4)
                pX = M.to_blocked_ell(pX, 4, device=CPU)
            got, want = (M.last_column_is_intercept(pX),
                         RM.last_column_is_intercept(rX))
        assert got == want == with_icpt


def test_pad_batch_with_offsets_total_weight_match_reference():
    X, y = dense_xy(n=37)
    ind, val, d, ys = sparse_rows(n=37)
    for Xs, yy in ((X, y), ((ind, val, d), ys)):
        rb, pb = batches(Xs, yy)
        rp, pp = RD.pad_batch(rb, 64), D.pad_batch(pb, 64)
        assert pp.n == rp.n == 64
        for f in ("y", "weights", "offsets"):
            np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                          np.asarray(getattr(rp, f)))
        w = torch.linspace(-1, 1, Xs[2] if isinstance(Xs, tuple) else 16)
        close(M.matvec(pp.X, w), RM.matvec(rp.X, jnp.asarray(w.numpy())))
        assert D.total_weight(pp) == RD.total_weight(rp)
        off = np.arange(37, dtype=np.float32)
        np.testing.assert_array_equal(
            D.with_offsets(pb, off).offsets.numpy(),
            np.asarray(RD.with_offsets(rb, off).offsets))
    bell = M.to_blocked_ell(M.SparseRows(ind, val, d), 4, device=CPU)
    pb = D.make_batch(bell, ys, device=CPU)
    rbell = RD.make_batch(RM.to_blocked_ell(RM.SparseRows(ind, val, d), 4),
                          ys)
    wv = np.linspace(-1, 1, d).astype(np.float32)
    close(M.matvec(D.pad_batch(pb, 50).X, torch.from_numpy(wv)),
          RM.matvec(RD.pad_batch(rbell, 50).X, jnp.asarray(wv)))


# ------------------------------------------------------------- train_glm
def _cfgs(opt="lbfgs", iters=5, reg="l2", lam=1.0, **kw):
    r = {"l2": (RReg.l2(), Reg.l2()), "l1": (RReg.l1(), Reg.l1()),
         "en": (RReg.elastic_net(0.5), Reg.elastic_net(0.5))}[reg]
    common = dict(max_iters=iters, reg_weight=lam, tolerance=1e-9,
                  history=5, **kw)
    return (RConfig(optimizer=ROpt(opt), reg=r[0], **common),
            OptimizerConfig(optimizer=OptimizerType(opt), reg=r[1], **common))


def assert_same_solve(rm, rres, pm, pres):
    assert int(pres.iterations) == int(rres.iterations)
    np.testing.assert_allclose(pres.history(), np.asarray(rres.history()),
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(pm.coefficients.means.numpy(),
                               np.asarray(rm.coefficients.means),
                               rtol=W_RTOL, atol=W_ATOL)
    rv, pv = rm.coefficients.variances, pm.coefficients.variances
    assert (rv is None) == (pv is None)
    if rv is not None:
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv),
                                   rtol=VAR_RTOL)


@pytest.mark.parametrize("opt,reg", [("lbfgs", "l2"), ("tron", "l2"),
                                     ("lbfgs", "l1")])
@pytest.mark.parametrize("kind", ["standardization",
                                  "scale_with_standard_deviation"])
def test_train_glm_with_normalization_matches_reference(kind, opt, reg):
    """Normalized-space solves (L-BFGS, TRON, OWL-QN for the L1 case) with
    SIMPLE variances, returned in original space, with an original-space
    warm start."""
    X, y = dense_xy()
    rn, pn = contexts(X, kind)
    rcfg, pcfg = _cfgs(opt, reg=reg, lam=2.0 if reg == "l1" else 1.0)
    w0 = np.full(X.shape[1], 0.01, np.float32)
    rb, pb = batches(X, y)
    var = "simple" if reg == "l2" else "none"
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            w0=jnp.asarray(w0), normalization=rn,
                            variance=RVar(var))
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg, w0=w0,
                           normalization=pn, variance=Var(var), device=CPU)
    assert_same_solve(rm, rres, pm, pres)


def test_train_glm_sparse_rows_with_normalization_matches_reference():
    ind, val, d, y = sparse_rows()
    rn, pn = contexts((ind, val, d), "standardization")
    rb, pb = batches((ind, val, d), y)
    rcfg, pcfg = _cfgs()
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            normalization=rn, variance=RVar.SIMPLE)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           normalization=pn, variance=Var.SIMPLE, device=CPU)
    assert_same_solve(rm, rres, pm, pres)


@pytest.mark.parametrize("prior", ["coefficients", "variances", "hessian"])
@pytest.mark.parametrize("opt", ["lbfgs", "tron"])
def test_train_glm_with_priors_matches_reference(prior, opt):
    """A previous solve's posterior as the prior (diagonal, or full from
    its FULL Hessian), with FULL variances on the new solve."""
    X, y = dense_xy(d=12, spread=4.0)
    rb, pb = batches(X, y)
    rng = np.random.default_rng(8)
    mu = (0.3 * rng.normal(size=12)).astype(np.float32)
    var = rng.uniform(0.05, 0.5, size=12).astype(np.float32)
    A = rng.normal(size=(12, 12)).astype(np.float32)
    H = (A @ A.T).astype(np.float32)
    make = {"coefficients": lambda m: m.from_coefficients(mu, var),
            "variances": lambda m: m.from_variances(mu, var, scale=0.5),
            "hessian": lambda m: m.from_hessian(mu, H, scale=0.1)}[prior]
    # TRON reaches the f32 floor in 5 iterations here, where the two
    # sides' last steps part along flat directions: stop before it
    rcfg, pcfg = _cfgs(opt, lam=0.5, iters=3 if opt == "tron" else 5)
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            prior=make(RP.PriorDistribution),
                            variance=RVar.FULL)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           prior=make(P.PriorDistribution),
                           variance=Var.FULL, device=CPU)
    assert_same_solve(rm, rres, pm, pres)


@pytest.mark.parametrize("task", ["linear", "poisson"])
def test_train_glm_full_variances_matches_reference(task):
    X, y = dense_xy(d=10, task=task, spread=4.0)
    rb, pb = batches(X, y)
    rcfg, pcfg = _cfgs()
    rm, rres = RT.train_glm(rb, RL.TaskType(task), rcfg, variance=RVar.FULL)
    pm, pres = T.train_glm(pb, L.TaskType(task), pcfg, variance=Var.FULL,
                           device=CPU)
    assert_same_solve(rm, rres, pm, pres)


def test_train_glm_diagonal_prior_with_normalization_matches_reference():
    X, y = dense_xy()
    rn, pn = contexts(X, "standardization")
    rng = np.random.default_rng(12)
    mu = (0.1 * rng.normal(size=16)).astype(np.float32)
    tau = rng.uniform(0.5, 3.0, size=16).astype(np.float32)
    rb, pb = batches(X, y)
    rcfg, pcfg = _cfgs()
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            prior_mean=jnp.asarray(mu),
                            prior_precision=jnp.asarray(tau),
                            normalization=rn)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           prior_mean=mu, prior_precision=tau,
                           normalization=pn, device=CPU)
    assert_same_solve(rm, rres, pm, pres)


def test_train_glm_blocked_ell_with_normalization_matches_reference():
    """A permuted layout: the factors and shifts gather into its space."""
    ind, val, d, y = sparse_rows()
    rn, pn = contexts((ind, val, d), "scale_with_max_magnitude")
    rb = RD.make_batch(RM.to_blocked_ell(RM.SparseRows(ind, val, d), 8), y)
    pb = D.make_batch(M.to_blocked_ell(M.SparseRows(ind, val, d), 8,
                                       device=CPU), y, device=CPU)
    rcfg, pcfg = _cfgs()
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            normalization=rn, variance=RVar.SIMPLE)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           normalization=pn, variance=Var.SIMPLE, device=CPU)
    assert_same_solve(rm, rres, pm, pres)


def test_train_glm_prior_refusals_match_reference():
    X, y = dense_xy(d=8)
    _, pb = batches(X, y)
    _, pcfg = _cfgs()
    mu = np.zeros(8, np.float32)
    full = P.PriorDistribution.from_hessian(mu, np.eye(8, dtype=np.float32))
    _, pn = contexts(X, "standardization")
    with pytest.raises(ValueError, match="normalization"):
        T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg, prior=full,
                    normalization=pn, device=CPU)
    with pytest.raises(ValueError, match="prior OR"):
        T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg, prior=full,
                    prior_mean=mu, device=CPU)
    ind, val, d, ys = sparse_rows()
    bell = D.make_batch(M.to_blocked_ell(M.SparseRows(ind, val, d), 8,
                                         device=CPU), ys, device=CPU)
    with pytest.raises(ValueError, match="BlockedEllRows"):
        T.train_glm(bell, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                    prior=P.PriorDistribution.from_hessian(
                        np.zeros(d, np.float32), np.eye(d, dtype=np.float32)),
                    device=CPU)


# --------------------------------------------------------- train_glm_grid
@pytest.mark.parametrize("route", ["lbfgs", "tron", "owlqn", "simple"])
def test_train_glm_grid_with_normalization_matches_reference(route):
    """Every lane's objective folds the normalization in (the lane
    L-BFGS, TRON and OWL-QN), or — with SIMPLE variances — the general
    runner does; models come back in original space."""
    X, y = dense_xy()
    rn, pn = contexts(X, "standardization")
    rb, pb = batches(X, y)
    opt = "tron" if route == "tron" else "lbfgs"
    reg = "l1" if route == "owlqn" else "l2"
    # the 3.0 TRON lane reaches the f32 floor in 5 iterations: stop before
    rcfg, pcfg = _cfgs(opt, reg=reg, iters=3 if opt == "tron" else 5)
    weights = [0.3, 1.0, 3.0]
    var = "simple" if route == "simple" else "none"
    want = RT.train_glm_grid(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                             weights, normalization=rn, variance=RVar(var))
    got = T.train_glm_grid(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg, weights,
                           normalization=pn, variance=Var(var), device=CPU)
    for (rm, rres), (pm, pres) in zip(want, got):
        assert_same_solve(rm, rres, pm, pres)


def test_train_glm_grid_with_a_diagonal_prior_and_full_variances():
    X, y = dense_xy(d=10, spread=4.0)
    rb, pb = batches(X, y)
    rcfg, pcfg = _cfgs()
    mu = np.linspace(-0.2, 0.2, 10).astype(np.float32)
    var = np.linspace(0.1, 1.0, 10).astype(np.float32)
    want = RT.train_glm_grid(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                             [0.5, 2.0], variance=RVar.FULL,
                             prior=RP.PriorDistribution.from_variances(mu,
                                                                       var))
    got = T.train_glm_grid(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           [0.5, 2.0], variance=Var.FULL,
                           prior=P.PriorDistribution.from_variances(mu, var),
                           device=CPU)
    for (rm, rres), (pm, pres) in zip(want, got):
        assert_same_solve(rm, rres, pm, pres)


def test_train_glm_grid_refusals_match_reference():
    X, y = dense_xy(d=8)
    _, pb = batches(X, y)
    _, pcfg = _cfgs()
    _, pn = contexts(X, "standardization")
    with pytest.raises(ValueError, match="full-covariance"):
        T.train_glm_grid(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg, [1.0],
                         prior=P.PriorDistribution.from_hessian(
                             np.zeros(8, np.float32),
                             np.eye(8, dtype=np.float32)), device=CPU)
    with pytest.raises(ValueError, match="per-lane w0"):
        T.train_glm_grid(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                         [1.0, 2.0], w0=np.zeros((2, 8), np.float32),
                         normalization=pn, device=CPU)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [0, 3])
def test_square_in_row_chunks_equals_the_whole_block(dtype, lanes,
                                                     monkeypatch):
    """(X∘X)ᵀr squares X a row chunk at a time (here chunks of 64 rows
    squared 128 at a time over 1,000 rows): the product of the whole
    squared block summed in the same chunks, for a vector and for lanes,
    on dense X and on a `BlockedEllRows` hot block (to f32 rounding: the
    CPU's batched products need not repeat their bits across batch
    counts)."""
    monkeypatch.setattr(M, "_MM_CHUNK", 64)
    monkeypatch.setattr(M, "_SQ_ROWS", 128)
    rng = np.random.default_rng(13)
    X = torch.from_numpy(rng.normal(size=(1000, 24)).astype(
        np.float32)).to(dtype)
    r = torch.from_numpy(rng.normal(size=(1000,) + ((lanes,) if lanes
                                                     else ())).astype(
        np.float32))
    got = M.sq_rmatvec(X, r)
    want = M._mm_f32((X * X).t(), r.to(dtype))
    close(got, want.numpy())
    ind, val, d, _ = sparse_rows(n=1000)
    bell = M.to_blocked_ell(M.SparseRows(ind, val, d), 8, device=CPU)
    bell = bell.astype(dtype)
    got = M.sq_rmatvec(bell, r)[:bell.d_sel]
    want = M._mm_f32((bell.dense * bell.dense).t(), r.to(dtype))
    close(got, want.numpy())
    rX = RM.to_blocked_ell(RM.SparseRows(ind, val, d), 8)
    if dtype == torch.bfloat16:
        rX = RD.cast_features(RD.make_batch(rX, np.zeros(1000,
                                                         np.float32))).X
    if not lanes:
        close(M.sq_rmatvec(bell, r), RM.sq_rmatvec(rX, jnp.asarray(
            r.numpy())))
