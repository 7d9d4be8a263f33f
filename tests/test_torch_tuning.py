"""The port's tuning package against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both: the generic closure
solvers (`minimize_lbfgs`, `minimize_tron`) on a logistic closure and on
the GP's padded marginal likelihood, the search candidates (bit for bit),
the padded NLL and its gradient, a GP carried across by
`convert.gp_from_arrays` (predict, joint draws, EI, LCB, q-EI and the
greedy picks), `fit_gp` (the quality of its optimum, the fall-back to the
prior hyperparameters when the factor is not positive definite), `tune`
(sobol and random bit for bit; gp against random on the reference test's
bowl) and `tune_glm_reg` end to end.
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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data.dataset import make_batch as r_make_batch  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.lbfgs import minimize_lbfgs as r_lbfgs  # noqa: E402
from photon_tpu.optim.regularization import l2 as r_l2  # noqa: E402
from photon_tpu.optim.tron import minimize_tron as r_tron  # noqa: E402
from photon_tpu.tuning import acquisition as RA  # noqa: E402
from photon_tpu.tuning import gp as RG  # noqa: E402
from photon_tpu.tuning import search as RS  # noqa: E402
from photon_tpu.tuning import tuner as RT  # noqa: E402

from photon_tpu_torch.convert import gp_from_arrays  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs  # noqa: E402
from photon_tpu_torch.optim.regularization import l2  # noqa: E402
from photon_tpu_torch.optim.tron import minimize_tron  # noqa: E402
from photon_tpu_torch.tuning import acquisition as PA  # noqa: E402
from photon_tpu_torch.tuning import gp as PG  # noqa: E402
from photon_tpu_torch.tuning import search as PS  # noqa: E402
from photon_tpu_torch.tuning import tuner as PT  # noqa: E402

CPU = "cpu"


def _hist(h) -> np.ndarray:
    h = np.asarray(h)
    return h[~np.isnan(h)]


# ------------------------------------------------------- the closure solvers
def _logistic(seed: int = 3, n: int = 240, d: int = 6, lam: float = 0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    s = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)

    def jvg(w):
        z = s * (jnp.asarray(X) @ w)
        f = jnp.sum(jnp.logaddexp(0.0, -z)) + 0.5 * lam * w @ w
        g = jnp.asarray(X).T @ (-s * jax.nn.sigmoid(-z)) + lam * w
        return f, g

    def jhvp(w, v):
        p = jax.nn.sigmoid(jnp.asarray(X) @ w * s)
        return jnp.asarray(X).T @ (p * (1 - p) * (jnp.asarray(X) @ v)) \
            + lam * v

    Xt, st = torch.from_numpy(X), torch.from_numpy(s)

    def tvg(w):
        z = st * (Xt @ w)
        f = torch.sum(torch.logaddexp(torch.zeros_like(z), -z)) \
            + 0.5 * lam * w @ w
        g = Xt.T @ (-st * torch.sigmoid(-z)) + lam * w
        return f, g

    def thvp(w, v):
        p = torch.sigmoid(Xt @ w * st)
        return Xt.T @ (p * (1 - p) * (Xt @ v)) + lam * v

    return d, jvg, jhvp, tvg, thvp


def _gp_problem(k: int, d: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(k, d)).astype(np.float32)
    y = np.sin(4 * X[:, 0]) + X[:, 1:].sum(1)
    Xp, yp, mask, _, _ = PG.pad_observations(X, y)
    theta0 = np.zeros(d + 2, np.float32)
    theta0[-1] = -4.0
    return X, y, Xp, yp, mask, theta0


def test_minimize_lbfgs_logistic_closure_matches_reference():
    d, jvg, _, tvg, _ = _logistic()
    want = r_lbfgs(jvg, jnp.zeros(d, jnp.float32), max_iters=50,
                   tolerance=1e-7, history=5)
    got = minimize_lbfgs(tvg, torch.zeros(d), max_iters=50, tolerance=1e-7,
                         history=5)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.history(), _hist(want.loss_history),
                               rtol=1e-5)
    assert bool(got.converged) == bool(want.converged)
    # every iteration pays its trials (the search stops at the accepted
    # one) and one evaluation at the accepted point
    assert 1 + 2 * got.iterations <= got.evaluations \
        <= 1 + 13 * got.iterations
    assert got.evaluations < 1 + 3 * got.iterations


def test_minimize_lbfgs_gp_nll_matches_reference():
    # five observations: both packages' f32 Cholesky factors agree to the
    # last bits over the whole solve (a larger history parts at ~1e-4
    # after a few iterations along the noise floor's flat direction; the
    # fit_gp test below holds those by the optimum's quality)
    _, _, Xp, yp, mask, theta0 = _gp_problem(5)
    vg = RG._nll_builder(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(mask),
                         "matern52")
    want = r_lbfgs(vg, jnp.asarray(theta0), max_iters=60, tolerance=1e-9)
    got = minimize_lbfgs(
        PG.nll_value_and_grad(*map(torch.from_numpy, (Xp, yp, mask))),
        torch.from_numpy(theta0), max_iters=60, tolerance=1e-9)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.history(), _hist(want.loss_history),
                               rtol=1e-5)


def test_minimize_tron_logistic_closure_matches_reference():
    d, jvg, jhvp, tvg, thvp = _logistic(seed=5)
    want = r_tron(jvg, jhvp, jnp.zeros(d, jnp.float32), max_iters=30,
                  tolerance=1e-7, cg_max_iters=10)
    got = minimize_tron(tvg, thvp, torch.zeros(d), max_iters=30,
                        tolerance=1e-7, cg_max_iters=10)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.history(), _hist(want.loss_history),
                               rtol=1e-5)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-4)
    assert got.hvps > got.iterations


def test_minimize_tron_gp_nll_matches_reference():
    # Hessian-vector products of the NLL: forward-over-reverse in JAX,
    # double backward through the Cholesky in the port. The RBF kernel's
    # NLL: the Matérn kernel's sqrt(d² + 1e-12) puts a 1/(d² + 1e-12)^1.5
    # factor on the Gram's diagonal (d² = 0 up to rounding) into second
    # derivatives, so its HVPs are rounding noise in both packages
    _, _, Xp, yp, mask, theta0 = _gp_problem(5)
    jX, jy, jm = map(jnp.asarray, (Xp, yp, mask))
    vg = RG._nll_builder(jX, jy, jm, "rbf")

    def jnll(t):
        return vg(t)[0]

    def jhvp(w, v):
        return jax.jvp(jax.grad(jnll), (w,), (v,))[1]

    tX, ty, tm = map(torch.from_numpy, (Xp, yp, mask))

    def thvp(w, v):
        with torch.enable_grad():
            t = w.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(PG.gp_nll(t, tX, ty, tm, "rbf"), t,
                                       create_graph=True)
            (h,) = torch.autograd.grad(g, t, grad_outputs=v)
        return h

    want = r_tron(vg, jhvp, jnp.asarray(theta0), max_iters=12,
                  tolerance=1e-9, cg_max_iters=5)
    got = minimize_tron(PG.nll_value_and_grad(tX, ty, tm, "rbf"), thvp,
                        torch.from_numpy(theta0), max_iters=12,
                        tolerance=1e-9, cg_max_iters=5)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.history(), _hist(want.loss_history),
                               rtol=1e-5)


# ------------------------------------------------------- search candidates
@pytest.mark.parametrize("method", ["sobol", "random", "grid"])
def test_candidates_bit_equal(method):
    for dim in (1, 3):
        rs = RS.SearchSpace([RS.SearchRange(1e-4, 1e4, log_scale=True)]
                            + [RS.SearchRange(0.0, 2.0)] * (dim - 1))
        ps = PS.SearchSpace([PS.SearchRange(1e-4, 1e4, log_scale=True)]
                            + [PS.SearchRange(0.0, 2.0)] * (dim - 1))
        for seed in (0, 7):
            a = RS.candidates(rs, 37, method, seed=seed, points_per_dim=4)
            b = PS.candidates(ps, 37, method, seed=seed, points_per_dim=4)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(rs.from_unit(a), ps.from_unit(b))
            np.testing.assert_array_equal(rs.to_unit(rs.from_unit(a)),
                                          ps.to_unit(ps.from_unit(b)))
    with pytest.raises(ValueError, match="unknown candidate method"):
        PS.candidates(ps, 4, "halton")


# ------------------------------------------------------------ the GP
@pytest.mark.parametrize("kernel", ["matern52", "rbf"])
@pytest.mark.parametrize("k", [5, 13])
def test_padded_nll_and_gradient_match_reference(kernel, k):
    _, _, Xp, yp, mask, theta0 = _gp_problem(k, d=3, seed=k)
    rng = np.random.default_rng(k)
    vg = RG._nll_builder(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(mask),
                         kernel)
    pvg = PG.nll_value_and_grad(*map(torch.from_numpy, (Xp, yp, mask)),
                                kernel)
    for theta in (theta0, theta0 + rng.normal(scale=0.5, size=theta0.shape)
                  .astype(np.float32)):
        f_r, g_r = vg(jnp.asarray(theta))
        f_p, g_p = pvg(torch.from_numpy(theta))
        np.testing.assert_allclose(float(f_p), float(f_r), rtol=1e-5)
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g_r).max()))
    # the padded count's 2π term: the NLL is the unpadded one plus
    # 0.5·(n_pad − n)·log 2π
    Xr, yr = Xp[:k], yp[:k]
    f_unpadded = PG.gp_nll(torch.from_numpy(theta0), torch.from_numpy(Xr),
                           torch.from_numpy(yr), torch.ones(k), kernel)
    f_pad = PG.gp_nll(torch.from_numpy(theta0),
                      *map(torch.from_numpy, (Xp, yp, mask)), kernel)
    np.testing.assert_allclose(
        float(f_pad), float(f_unpadded)
        + 0.5 * (Xp.shape[0] - k) * np.log(2 * np.pi), rtol=1e-6)


@pytest.fixture(scope="module")
def fitted():
    """A reference GP fitted on 11 observations in 2-d, carried across;
    its candidate pool and incumbent."""
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(11, 2)).astype(np.float32)
    y = np.cos(3 * X[:, 0]) - X[:, 1] ** 2
    ref = RG.fit_gp(X, y)
    port = gp_from_arrays({f.name: (np.asarray(getattr(ref, f.name))
                                    if not isinstance(getattr(ref, f.name),
                                                      (str, float))
                                    else getattr(ref, f.name))
                           for f in dataclasses.fields(ref)}, device=CPU)
    pool = rng.uniform(size=(40, 2)).astype(np.float32)
    return ref, port, pool, float(y.min())


def test_predict_and_joint_draws_match_reference(fitted):
    ref, port, pool, _ = fitted
    m_r, s_r = ref.predict(pool)
    m_p, s_p = port.predict(pool)
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_r), atol=1e-4)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=1e-4)
    Z_r = ref.sample_joint(pool[:12], 64, seed=5)
    Z_p = port.sample_joint(pool[:12], 64, seed=5)
    assert Z_p.shape == (64, 12)
    np.testing.assert_allclose(Z_p, Z_r, atol=1e-4)


def _posterior_f64(gp, pool) -> tuple:
    """The posterior mean and stddev of a reference GP's own fields in
    f64 (scipy's triangular solve)."""
    import scipy.linalg

    X, L = np.asarray(gp.X, np.float64), np.asarray(gp.L, np.float64)
    il = np.asarray(gp.inv_lengthscales, np.float64)
    a, b = pool.astype(np.float64) * il, X * il
    d2 = np.maximum((a * a).sum(-1)[:, None] - 2 * a @ b.T
                    + (b * b).sum(-1)[None], 0.0)
    s = np.sqrt(5.0) * np.sqrt(d2 + 1e-12)
    Kq = gp.amplitude * (1 + s + s * s / 3) * np.exp(-s) \
        * np.asarray(gp.mask, np.float64)[None]
    v = scipy.linalg.solve_triangular(L, Kq.T, lower=True)
    var = np.maximum(gp.amplitude + gp.noise - (v * v).sum(0), 1e-6)
    return (Kq @ np.asarray(gp.alpha, np.float64) * gp.y_std + gp.y_mean,
            np.sqrt(var) * gp.y_std)


def test_acquisitions_match_reference(fitted):
    from scipy.stats import norm

    ref, port, pool, best = fitted
    # both packages' f32 posteriors sit ~1e-5 from the f64 one on this
    # GP: EI and LCB are held to 1e-5 beyond the reference's own distance
    # from f64, and to each other within twice that
    mean, std = _posterior_f64(ref, pool)
    z = (best - mean) / std
    acq = {"ei": (PA.expected_improvement(port, pool, best).numpy(),
                  np.asarray(RA.expected_improvement(ref, pool, best)),
                  std * (z * norm.cdf(z) + norm.pdf(z))),
           "lcb": (PA.lower_confidence_bound(port, pool, 1.5).numpy(),
                   np.asarray(RA.lower_confidence_bound(ref, pool, 1.5)),
                   -(mean - 1.5 * std))}
    for name, (p, r, exact) in acq.items():
        ref_err = np.abs(r - exact).max()
        assert np.abs(p - exact).max() <= ref_err + 1e-5, name
        np.testing.assert_allclose(p, r, atol=2 * ref_err + 1e-5)
    for q in (1, 3):
        assert PA.qei(port, pool[:q], best, seed=2) == pytest.approx(
            RA.qei(ref, pool[:q], best, seed=2), abs=1e-5)
    for costs in (None, np.full(40, 37.5)):
        assert PA.qei_greedy(port, pool, best, 6, seed=9, costs=costs) \
            == RA.qei_greedy(ref, pool, best, 6, seed=9, costs=costs)
    # q beyond the pool: the whole pool, no repeats
    assert sorted(PA.qei_greedy(port, pool[:5], best, 12, seed=1)) == \
        [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="positive"):
        PA.qei_greedy(port, pool, best, 2, costs=np.zeros(40))


@pytest.mark.parametrize("k", [7, 12, 24])
def test_fit_gp_optimum_no_worse_than_reference(k):
    X, y, Xp, yp, mask, theta0 = _gp_problem(k, seed=k)
    th_r = np.asarray(RG._fit_theta(
        jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(mask),
        jnp.asarray(theta0), kernel="matern52", max_iters=60))
    tX, ty, tm = map(torch.from_numpy, (Xp, yp, mask))
    th_p = PG.fit_theta(tX, ty, tm, torch.from_numpy(theta0))
    nll_r = float(PG.gp_nll(torch.from_numpy(th_r), tX, ty, tm))
    nll_p = float(PG.gp_nll(th_p, tX, ty, tm))
    assert nll_p <= nll_r + 1e-3 * abs(nll_r)
    gp = PG.fit_gp(X, y, device=CPU)
    assert gp.X.shape[0] == Xp.shape[0] and float(gp.mask.sum()) == k
    mean, _ = gp.predict(X)
    np.testing.assert_allclose(mean.numpy(), y, atol=0.05)


def test_cholesky_nan_semantics_and_prior_fallback(monkeypatch):
    bad = np.asarray([[1.0, 2.0], [2.0, 1.0]], np.float32)  # not PD
    lower = np.tril_indices(2)
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
                    [lower]).all()
    assert np.isnan(PG._cholesky(torch.from_numpy(bad)).numpy()[lower]).all()
    f, g = PG.nll_value_and_grad(
        torch.zeros(2, 1), torch.ones(2), torch.ones(2))(
            torch.tensor([0.0, 0.0, float("nan")]))
    assert torch.isnan(f) and torch.isnan(g).all()
    # a diverged fit falls back to the prior hyperparameters θ0 in both
    # packages: the same posterior
    X, y, *_ = _gp_problem(6)
    monkeypatch.setattr(RG, "_fit_theta",
                        lambda *a, **k: jnp.full((4,), jnp.nan))
    monkeypatch.setattr(PG, "fit_theta",
                        lambda *a, **k: torch.full((4,), float("nan")))
    ref, port = RG.fit_gp(X, y), PG.fit_gp(X, y, device=CPU)
    assert port.amplitude == pytest.approx(ref.amplitude, rel=1e-6) == 1.0
    assert port.noise == pytest.approx(ref.noise, rel=1e-6)
    np.testing.assert_allclose(port.L.numpy(), np.asarray(ref.L), atol=1e-5)
    # α = K⁻¹y through the two packages' f32 triangular solves
    np.testing.assert_allclose(port.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=1e-4)


def test_gp_placement_follows_device():
    X, y, *_ = _gp_problem(9)
    gp = PG.fit_gp(X, y, device=CPU)
    assert gp.device.type == "cpu" and gp.L.device.type == "cpu"
    mean, std = gp.predict(X[:3], device=CPU)
    assert mean.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PG.fit_gp(X, y)


# ------------------------------------------------------------ the tuner
def _bowl(x) -> float:
    return float((x[0] - 0.3) ** 2 + (np.log10(x[1]) - 0.0) ** 2)


def _spaces():
    return (RS.SearchSpace([RS.SearchRange(0.0, 1.0),
                            RS.SearchRange(1e-3, 1e3, log_scale=True)]),
            PS.SearchSpace([PS.SearchRange(0.0, 1.0),
                            PS.SearchRange(1e-3, 1e3, log_scale=True)]))


@pytest.mark.parametrize("method", ["sobol", "random"])
def test_tune_sobol_random_bit_equal(method):
    rs, ps = _spaces()
    for batch_size in (1, 3):
        a = RT.tune(_bowl, rs, n_iters=10, method=method, seed=4,
                    batch_size=batch_size)
        b = PT.tune(_bowl, ps, n_iters=10, method=method, seed=4,
                    batch_size=batch_size, device=CPU)
        np.testing.assert_array_equal(a.xs, b.xs)
        np.testing.assert_array_equal(a.ys, b.ys)
        np.testing.assert_array_equal(a.best_x, b.best_x)
        np.testing.assert_array_equal(a.history(), b.history())


def test_tune_gp_beats_random_on_bowl():
    _, space = _spaces()
    budget = 18
    gp_best = [PT.tune(_bowl, space, n_iters=budget, method="gp", seed=s,
                       device=CPU).best_y for s in range(3)]
    rnd_best = [PT.tune(_bowl, space, n_iters=budget, method="random",
                        seed=s, device=CPU).best_y for s in range(3)]
    assert np.mean(gp_best) < np.mean(rnd_best)
    assert np.mean(gp_best) < 0.05  # found the basin


def test_tune_gp_batches_and_warm_start():
    _, space = _spaces()
    seen = []

    def evaluate_batch(X):
        seen.append(len(X))
        return [_bowl(x) for x in X]

    r = PT.tune(None, space, n_iters=9, n_seed=3, batch_size=3,
                evaluate_batch=evaluate_batch, seed=2, device=CPU)
    assert seen == [3, 3, 3] and r.xs.shape == (9, 2)
    liar = PT.tune(_bowl, space, n_iters=6, n_seed=3, batch_size=3,
                   batch_method="liar", seed=2, device=CPU)
    assert liar.ys.shape == (6,)
    warm = PT.tune(_bowl, space, n_iters=4, method="gp", device=CPU,
                   initial_observations=[(np.array([0.3, 1.0]), 0.0)])
    assert warm.best_y == 0.0 and warm.ys.shape == (5,)
    for bad in (dict(n_iters=0), dict(batch_size=0),
                dict(method="grid"), dict(batch_method="x")):
        kw = dict(n_iters=4, device=CPU)
        kw.update(bad)
        with pytest.raises(ValueError):
            PT.tune(_bowl, space, **kw)
    with pytest.raises(ValueError, match="evaluate"):
        PT.tune(None, space, n_iters=2, device=CPU)


def _glm_data(seed: int = 21, n: int = 300, d: int = 8):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)

    def draw(m):
        X = rng.normal(size=(m, d)).astype(np.float32)
        X[:, -1] = 1.0
        y = (X @ w + rng.normal(size=m) > 0).astype(np.float32)
        return X, y

    return draw(n), draw(n // 2)


def test_tune_glm_reg_end_to_end_against_reference():
    (Xt, yt), (Xv, yv) = _glm_data()
    cfg_r = RConfig(max_iters=40, reg=r_l2(), history=5)
    cfg_p = OptimizerConfig(max_iters=40, reg=l2(), history=5)
    _, w_r, res_r = RT.tune_glm_reg(
        r_make_batch(Xt, yt), RTask.LOGISTIC_REGRESSION, cfg_r,
        r_make_batch(Xv, yv), n_iters=8, batch_size=4, seed=1)
    model, w_p, res_p = PT.tune_glm_reg(
        make_batch(Xt, yt, device=CPU), TaskType.LOGISTIC_REGRESSION, cfg_p,
        make_batch(Xv, yv, device=CPU), n_iters=8, batch_size=4, seed=1)
    # the Sobol seed round proposes the same weights in both packages, and
    # their validation metrics (negated AUC) agree
    n_seed = 5
    np.testing.assert_array_equal(res_p.xs[:n_seed], res_r.xs[:n_seed])
    np.testing.assert_allclose(res_p.ys[:n_seed], res_r.ys[:n_seed],
                               atol=1e-4)
    assert res_p.ys.shape == (8,) and (np.diff(res_p.history()) <= 0).all()
    assert 1e-4 <= w_p <= 1e4 and res_p.best_y <= res_r.ys[:n_seed].min()
    assert model.coefficients.means.device.type == "cpu"
    assert res_p.best_y == pytest.approx(res_r.best_y, abs=0.02)
