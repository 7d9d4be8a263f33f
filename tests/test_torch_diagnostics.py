"""The port's diagnostics against the JAX package's, on the CPU.

Hosmer–Lemeshow (chi², p, dof and the bin sums, weighted, with padding
rows and ties), both feature importances on a dense X and on `SparseRows`
(and the refusal of a `BlockedEllRows`), and the bootstrap: the port's
replicate solves fed the reference's own Poisson counts, per-replicate
coefficients, converged flags, moments and confidence bounds.
"""
import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import diagnostics as RDG  # noqa: E402
from photon_tpu.data.dataset import make_batch as r_make_batch  # noqa: E402
from photon_tpu.data.matrix import SparseRows as RSparse  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim import regularization as rreg  # noqa: E402

from photon_tpu_torch import diagnostics as PDG  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.data.matrix import (SparseRows,  # noqa: E402
                                          to_blocked_ell)
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim import regularization as preg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402

CPU = "cpu"


# --------------------------------------------------------- Hosmer–Lemeshow
def _hl_case(n: int, seed: int, pad: int = 0, ties: bool = False,
             weighted: bool = False):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.02, 0.98, n).astype(np.float32)
    if ties:
        p = np.round(p * 8) / 8
        p = np.clip(p, 0.05, 0.95).astype(np.float32)
    y = (rng.uniform(size=n) < p).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, n) if weighted else np.ones(n)) \
        .astype(np.float32)
    if pad:
        w[rng.choice(n, pad, replace=False)] = 0.0
    return p, y, w


def _hl_chi2_f64(p, y, w, n_bins: int) -> float:
    """The Hosmer–Lemeshow χ² in f64 numpy (the reference's binning)."""
    o = np.argsort(p, kind="stable")
    p, y, w = (a[o].astype(np.float64) for a in (p, y, w))
    cw = np.cumsum(w) - 0.5 * w
    b = np.clip((cw / w.sum() * n_bins).astype(int), 0, n_bins - 1)
    b = np.where(w > 0, b, n_bins)
    obs, exp, mass = (np.bincount(b, v, n_bins + 1)[:n_bins]
                      for v in (w * y, w * p, w))
    den = exp * (1 - exp / np.maximum(mass, 1e-12))
    return float(np.where(mass > 0, (obs - exp) ** 2
                          / np.maximum(den, 1e-12), 0.0).sum())


@pytest.mark.parametrize("case", [
    dict(n=1000, seed=0), dict(n=777, seed=1, pad=77),
    dict(n=513, seed=2, ties=True, weighted=True),
    dict(n=4096, seed=3, weighted=True, pad=100)])
@pytest.mark.parametrize("n_bins", [10, 7])
def test_hosmer_lemeshow_matches_reference(case, n_bins):
    p, y, w = _hl_case(**case)
    want = RDG.hosmer_lemeshow(jnp.asarray(p), jnp.asarray(y),
                               jnp.asarray(w), n_bins=n_bins)
    got = PDG.hosmer_lemeshow(torch.from_numpy(p), torch.from_numpy(y),
                              torch.from_numpy(w), n_bins=n_bins)
    for name in ("observed_pos", "expected_pos", "bin_weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)
    assert float(got.dof) == float(want.dof)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-5)
    # the p-value magnifies χ²'s last bits: the reference's own p sits up
    # to 1.1e-5 from the f64 one on these cases, so the port's is held to
    # 1e-5 of the f64 p, and to the reference's within 1e-5 beyond the
    # reference's own distance from it
    from scipy.special import gammaincc

    p64 = gammaincc(float(want.dof) / 2, _hl_chi2_f64(p, y, w, n_bins) / 2)
    np.testing.assert_allclose(float(got.p_value), p64, rtol=1e-5)
    ref_err = abs(float(want.p_value) - p64)
    assert abs(float(got.p_value) - float(want.p_value)) <= \
        1e-5 * float(want.p_value) + ref_err
    assert bool(got.well_calibrated) == bool(want.well_calibrated)
    # padding is invisible: the same test on the real rows alone
    real = w > 0
    alone = PDG.hosmer_lemeshow(p[real], y[real], w[real], n_bins=n_bins,
                                device=CPU)
    np.testing.assert_allclose(alone.bin_weight.numpy(),
                               got.bin_weight.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(alone.chi2), float(got.chi2),
                               rtol=1e-5)


def test_hosmer_lemeshow_heavy_row_leaves_bins_empty():
    p = np.linspace(0.1, 0.9, 20).astype(np.float32)
    y = (np.arange(20) % 2).astype(np.float32)
    w = np.ones(20, np.float32)
    w[10] = 1000.0  # one row heavier than every decile
    want = RDG.hosmer_lemeshow(p, y, w)
    got = PDG.hosmer_lemeshow(p, y, w, device=CPU)
    assert float(got.dof) == float(want.dof) < 8.0
    np.testing.assert_allclose(got.bin_weight.numpy(),
                               np.asarray(want.bin_weight), rtol=1e-6)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-5)


# ------------------------------------------------------- feature importance
def _importance_case(seed: int = 4, n: int = 300, d: int = 12, k: int = 4):
    rng = np.random.default_rng(seed)
    ind = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < 0.2] = 0.0  # padding slots
    dense = np.zeros((n, d), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n), k), ind.reshape(-1)),
              val.reshape(-1))
    w = rng.normal(size=d).astype(np.float32)
    wts = rng.uniform(0.0, 2.0, n).astype(np.float32)
    return ind, val, dense, w, wts


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("weighted", [False, True])
def test_importances_match_reference(layout, weighted):
    ind, val, dense, w, wts = _importance_case()
    wts = wts if weighted else None
    if layout == "dense":
        rX, pX = jnp.asarray(dense), torch.from_numpy(dense)
    else:
        rX = RSparse(jnp.asarray(ind), jnp.asarray(val), dense.shape[1])
        pX = SparseRows(torch.from_numpy(ind), torch.from_numpy(val),
                        dense.shape[1])
    for rfn, pfn in ((RDG.expected_magnitude_importance,
                      PDG.expected_magnitude_importance),
                     (RDG.variance_importance, PDG.variance_importance)):
        want = rfn(w, rX, weights=wts, names=[f"f{j}" for j in range(12)])
        got = pfn(w, pX, weights=wts, names=[f"f{j}" for j in range(12)])
        np.testing.assert_allclose(got.importance, want.importance,
                                   rtol=1e-6)
        assert got.top(3)[0][0] == want.top(3)[0][0]
        np.testing.assert_array_equal(np.sort(got.order), np.arange(12))
    # the SparseRows moments repeat bit for bit
    if layout == "sparse":
        a = PDG.variance_importance(w, pX, weights=wts).importance
        b = PDG.variance_importance(w, pX, weights=wts).importance
        np.testing.assert_array_equal(a, b)


def test_importance_refuses_blocked_ell():
    ind, val, dense, w, _ = _importance_case()
    X = to_blocked_ell(SparseRows(ind, val, 12), 4, device=CPU)
    for fn in (PDG.expected_magnitude_importance, PDG.variance_importance):
        with pytest.raises(TypeError, match="original SparseRows"):
            fn(w, X)
    # a numpy X lands on the device asked for
    got = PDG.expected_magnitude_importance(w, dense, device=CPU)
    want = RDG.expected_magnitude_importance(w, jnp.asarray(dense))
    np.testing.assert_allclose(got.importance, want.importance, rtol=1e-6)


# --------------------------------------------------------------- bootstrap
def _boot_problem(seed: int = 8, n: int = 256, d: int = 6):
    rng = np.random.default_rng(seed)
    X = np.c_[rng.normal(size=(n, d - 1)), np.ones(n)].astype(np.float32)
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w_true))) \
        .astype(np.float32)
    return X, y


@pytest.mark.parametrize("reg,extra", [
    ("l2", dict(reg_weight=1.0)),
    ("l1", dict(reg_weight=2.0, regularize_intercept=False)),
])
def test_bootstrap_on_reference_counts(reg, extra):
    # the solves stop at 1e-4: at 1e-6 one replicate of six reaches the
    # f32 floor, where both packages stop on rounding along a flat valley
    # (final values 1e-7 apart, a coefficient 7e-4 apart)
    X, y = _boot_problem()
    B, seed = 6, 5
    cfg_r = RConfig(max_iters=60, tolerance=1e-4, reg=getattr(rreg, reg)(),
                    **extra)
    cfg_p = OptimizerConfig(max_iters=60, tolerance=1e-4,
                            reg=getattr(preg, reg)(), **extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RDG.bootstrap_glm(r_make_batch(X, y),
                                 RTask.LOGISTIC_REGRESSION, cfg_r,
                                 n_replicates=B, seed=seed)
    # the reference's own Poisson draw, as `bootstrap_glm` makes it
    counts = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0,
                                           (B, len(y))), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = PDG.bootstrap_from_weights(
            make_batch(X, y, device=CPU), TaskType.LOGISTIC_REGRESSION,
            cfg_p, counts)
    assert got.coefficients.shape == (B, X.shape[1])
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-4)
    np.testing.assert_array_equal(got.converged, want.converged)
    for name in ("mean", "std", "ci_lower", "ci_upper"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-4, err_msg=name)
    assert got.contains(got.mean).all()


def test_bootstrap_glm_draws_and_warns():
    X, y = _boot_problem(n=128)
    batch = make_batch(X, y, device=CPU)
    cfg = OptimizerConfig(max_iters=50, reg=preg.l2(), reg_weight=1.0)
    a = PDG.bootstrap_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                          n_replicates=3, seed=11,
                          metric_fn=lambda w, b: torch.sum(b.weights))
    b = PDG.bootstrap_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                          n_replicates=3, seed=11)
    np.testing.assert_array_equal(a.coefficients, b.coefficients)
    counts = PDG.bootstrap.poisson_counts(3, 128, seed=11, device=CPU)
    np.testing.assert_array_equal(a.metrics, counts.sum(1).numpy())
    assert b.metrics is None and a.converged.all()
    # padding rows keep weight 0 in every replicate
    w = np.ones(128, np.float32)
    w[:10] = 0.0
    padded = make_batch(X, y, weights=w, device=CPU)
    c = PDG.bootstrap_glm(padded, TaskType.LOGISTIC_REGRESSION, cfg,
                          n_replicates=2, seed=1,
                          metric_fn=lambda w_, rb: torch.sum(rb.weights[:10]))
    assert (c.metrics == 0).all()
    # a cap that stops every replicate early: the CIs come with a warning
    with pytest.warns(UserWarning, match="NO replicate converged"):
        PDG.bootstrap_glm(batch, TaskType.LOGISTIC_REGRESSION,
                          OptimizerConfig(max_iters=1, reg=preg.l2(),
                                          reg_weight=1.0),
                          n_replicates=2)
