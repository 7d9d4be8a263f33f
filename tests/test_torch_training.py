"""The port's single-device GLM training path against the JAX package.

On the same numpy-seeded data: the losses and their derivatives per task,
the `Objective` margin API, `wolfe_line_search` on the same φ, the L-BFGS
two-loop recursion, and `train_glm` end to end on a `BlockedEllRows`
(f32 and bf16 storage) and on dense X — iteration count equal, loss
history, final coefficients and SIMPLE variances within the stated
tolerances. The port runs on the CPU here (its kernels' plain versions);
the reference runs its XLA path, which its own tests pin bitwise to its
Pallas kernels, and once with ``kernels="on"`` (Pallas interpret mode).
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

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402
from photon_tpu.optim import lbfgs as RLB  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.linesearch import (  # noqa: E402
    wolfe_line_search as ref_wolfe)

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.convert import glm_from_arrays  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import (cast_features,  # noqa: E402
                                           chunk_batch, make_batch)
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var, compute_variances)
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402
from photon_tpu_torch.optim import lbfgs as LB  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.linesearch import wolfe_line_search  # noqa: E402

CPU = "cpu"
TASKS = [t.value for t in L.TaskType]
# Loss history: both sides take the same steps; each loss is a sum over
# ~1,000 rows added in another order (XLA vs PyTorch), a few ulp apart,
# and the small differences feed the next step. On this planted-signal
# problem the solve stays well conditioned, so 1e-5 holds for 10
# iterations (on an ill-conditioned one, bf16 rounding of w can amplify
# them — see PERF.md).
HIST_RTOL = 1e-5
# Coefficients: the same drift, on values of order 1, along directions
# in which the loss is flat (a loss that agrees to 1e-5 pins w less
# tightly).
W_ATOL = 1e-3
# SIMPLE variances, 1 / the Hessian diagonal: at the SAME w the two sides
# agree to a few ulp (sums over ~1,000 rows in another order). At each
# side's own final w, f32 storage adds the w drift above; bf16 storage
# rounds w to bf16 before the margin and weight·d2 to bf16 before the hot
# block's product, and a last-bit difference in w can flip either
# rounding — a 2^-8 step on the rows a column touches.
SAME_W_VAR_RTOL = 1e-5
VAR_RTOL = {False: 1e-4, True: 1e-2}


def problem(seed=0, n=1024, d=2000, k=12, d_dense=32, bf16=False):
    """(reference batch, port batch on the CPU): zipf rows as the bench
    makes them (intercept last, two padding slots per row) and labels
    drawn from a planted logistic model."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(1.4, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    col[:, -2:], val[:, -2:] = 0, 0.0
    ind = np.concatenate([col, np.full((n, 1), d - 1)], axis=1).astype(
        np.int32)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], axis=1)
    rng = np.random.default_rng(seed + 1)
    w_true = (rng.normal(size=d) / np.sqrt(np.arange(1, d + 1))).astype(
        np.float32)
    margin = np.einsum("nk,nk->n", val, w_true[ind])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    ref = RD.make_batch(RM.to_blocked_ell(RM.SparseRows(ind, val, d),
                                          d_dense), y)
    port = make_batch(M.to_blocked_ell(M.SparseRows(ind, val, d), d_dense,
                                       device=CPU), y, device=CPU)
    if bf16:
        ref, port = RD.cast_features(ref), cast_features(port)
    return ref, port


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("task", TASKS)
def test_losses_match_reference(task):
    """Elementwise f32: the two libraries' exp/log1p/sigmoid agree to an
    ulp or two."""
    rng = np.random.default_rng(0)
    z = (3.0 * rng.normal(size=257)).astype(np.float32)
    z[:3] = (0.0, 1.0, -1.0)  # the hinge's kinks
    if task == "poisson":
        y = rng.poisson(2.0, size=257).astype(np.float32)
    elif task == "linear":
        y = rng.normal(size=257).astype(np.float32)
    else:
        y = (rng.uniform(size=257) < 0.5).astype(np.float32)
    for ref_fn, port_fn in zip(RL.loss_fns(RL.TaskType(task)),
                               L.loss_fns(L.TaskType(task))):
        want = np.asarray(ref_fn(jnp.asarray(z), jnp.asarray(y)))
        got = port_fn(torch.from_numpy(z), torch.from_numpy(y))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_mean_fn_matches_reference(task):
    z = np.linspace(-4, 4, 33, dtype=np.float32)
    want = np.asarray(RL.mean_fn(RL.TaskType(task))(jnp.asarray(z)))
    got = L.mean_fn(L.TaskType(task))(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)


# -------------------------------------------------------------- objective
def _objectives(d, seed=3, mask=True, prior=True):
    """The same objective on both sides: L2 0.5, the intercept unmasked,
    a diagonal prior (in permuted space: the margin API works there)."""
    rng = np.random.default_rng(seed)
    m = np.ones(d, np.float32)
    m[-1] = 0.0
    mu = (0.1 * rng.normal(size=d)).astype(np.float32)
    tau = rng.uniform(0.0, 2.0, size=d).astype(np.float32)
    kw_r = dict(l2=np.float32(0.5))
    kw_p = dict(l2=0.5)
    if mask:
        kw_r["reg_mask"], kw_p["reg_mask"] = jnp.asarray(m), torch.from_numpy(m)
    if prior:
        kw_r.update(prior_mean=jnp.asarray(mu),
                    prior_precision=jnp.asarray(tau))
        kw_p.update(prior_mean=torch.from_numpy(mu),
                    prior_precision=torch.from_numpy(tau))
    return (RObjective(RL.TaskType.LOGISTIC_REGRESSION, **kw_r),
            Objective(L.TaskType.LOGISTIC_REGRESSION, **kw_p))


@pytest.mark.parametrize("bf16", [False, True])
def test_objective_margin_api_matches_reference(bf16):
    """Every term is a sum over ~1,000 rows or 2,000 coefficients in
    another order: rtol 1e-5 relative to the term's scale."""
    rb, pb = problem(bf16=bf16)
    d = pb.X.n_features
    ro, po = _objectives(d)
    rng = np.random.default_rng(4)
    w, p = (0.1 * rng.normal(size=(2, d))).astype(np.float32)
    wr, pr_ = jnp.asarray(w), jnp.asarray(p)
    wp, pp = torch.from_numpy(w), torch.from_numpy(p)

    def close(got, want):
        got = [g.numpy() for g in got] if isinstance(got, tuple) \
            else got.numpy()
        want = [np.asarray(x) for x in want] if isinstance(want, tuple) \
            else np.asarray(want)
        for g, x in (zip(got, want) if isinstance(got, list)
                     else [(got, want)]):
            np.testing.assert_allclose(g, x, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(x).max()))

    zr, zp = ro.margin(wr, rb), po.margin(wp, pb)
    close(zp, zr)
    dzr, dzp = ro.direction_margin(pr_, rb), po.direction_margin(pp, pb)
    close(dzp, dzr)
    ray_p, ray_r = po.ray_reg_coeffs(wp, pp), ro.ray_reg_coeffs(wr, pr_)
    close(ray_p, ray_r)
    for a in (0.0, 0.3, 2.0):
        close(po.phi_at_ray(zp, dzp, torch.tensor(a), ray_p, pb),
              ro.phi_at_ray(zr, dzr, jnp.float32(a), ray_r, rb))
    close(po.value_at_margin(wp, zp, pb), ro.value_at_margin(wr, zr, rb))
    close(po.grad_at_margin(wp, zp, pb), ro.grad_at_margin(wr, zr, rb))
    close(po.value_and_grad_at_margin(wp, zp, pb),
          ro.value_and_grad_at_margin(wr, zr, rb))
    close(po.value_and_grad(wp, pb), ro.value_and_grad(wr, rb))
    close(po.hess_diag(wp, pb), ro.hess_diag(wr, rb))


def test_objective_parts_still_to_port_raise():
    """Nothing of the one-device objective is still to come: the
    chunk-partial API (streamed training, ROADMAP queue A item 5) is
    ported, its partials summed over a batch's row chunks giving
    `value_and_grad` (test_torch_streamed.py holds them against the
    reference), and the full Hessian (its parity lives in
    test_torch_prior_norm.py) is the Hessian the HVP applies."""
    _, pb = problem(n=64, d=200)
    po = Objective(L.TaskType.LOGISTIC_REGRESSION, l2=1.0)
    w = torch.zeros(200)
    v = torch.linspace(-1.0, 1.0, 200)
    H = po.full_hessian(w, pb)
    np.testing.assert_allclose((H @ v).numpy(), po.hvp(w, pb, v).numpy(),
                               rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 7)).astype(np.float32)
    y = (rng.uniform(size=64) < 0.5).astype(np.float32)
    wd = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    acc = None
    for lo in (0, 40):
        part = make_batch(X[lo:lo + 40], y[lo:lo + 40], device=CPU)
        _, parts = po.chunk_value_grad_partials(wd, part)
        acc = parts if acc is None else po.add_partials(acc, parts)
    f, g = po.finish_value_grad(wd, acc)
    f_all, g_all = po.value_and_grad(wd, make_batch(X, y, device=CPU))
    np.testing.assert_allclose(float(f), float(f_all), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_all.numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ line search
def _phis(kind):
    """The same 1-D φ(a) = (f, f') for both sides."""
    if kind == "quadratic":          # minimum at a = 0.7
        def f(a, lib):
            return (a - 0.7) ** 2 - 0.49, 2.0 * (a - 0.7)
    elif kind == "far":              # minimum far out: bracketing doubles
        def f(a, lib):
            return (a - 5.0) ** 2 - 25.0, 2.0 * (a - 5.0)
    elif kind == "steep":            # overshoot: zoom with cubic steps
        def f(a, lib):
            return lib.exp(3.0 * a) - 4.0 * a, 3.0 * lib.exp(3.0 * a) - 4.0
    else:                            # non-finite past a = 0.5
        def f(a, lib):
            big = lib.where(a > 0.5, float("inf"), 0.0)
            return (a - 2.0) ** 2 - 4.0 + big, 2.0 * (a - 2.0)
    return f


@pytest.mark.parametrize("a_init", [1.0, 0.05])
@pytest.mark.parametrize("kind", ["quadratic", "far", "steep", "nonfinite"])
def test_wolfe_line_search_matches_reference(kind, a_init):
    """Same trial points on both sides: alpha, f(alpha) and ok agree to
    f32 rounding."""
    f = _phis(kind)
    f0, d0 = f(0.0, np)
    want = ref_wolfe(lambda a: f(a, jnp), np.float32(f0), np.float32(d0),
                     a_init)
    got = wolfe_line_search(lambda a: f(a, torch),
                            torch.tensor(f0, dtype=torch.float32),
                            torch.tensor(d0, dtype=torch.float32), a_init)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7)
    assert bool(got[2]) == bool(want[2])


def test_two_loop_matches_reference():
    """A half-full circular buffer (3 of 5 slots): f32 dots over 500
    entries, rtol 1e-5."""
    rng = np.random.default_rng(6)
    m, d, idx, count = 5, 500, 4, 3
    S, Y = (rng.normal(size=(2, m, d))).astype(np.float32)
    rho = rng.uniform(0.1, 1.0, size=m).astype(np.float32)
    g = rng.normal(size=d).astype(np.float32)
    sy, yy = np.float32(0.7), np.float32(1.3)
    want = RLB.two_loop(jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y),
                        jnp.asarray(rho), jnp.int32(idx), jnp.int32(count),
                        jnp.asarray(sy), jnp.asarray(yy))
    got = LB.two_loop(torch.from_numpy(g), torch.from_numpy(S),
                      torch.from_numpy(Y), torch.from_numpy(rho), idx, count,
                      torch.tensor(sy), torch.tensor(yy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


# -------------------------------------------------------------- train_glm
def _configs(iters=10, lam=1.0, **kw):
    return (RConfig(max_iters=iters, tolerance=0.0, reg=RReg.l2(),
                    reg_weight=lam, history=5, **kw),
            OptimizerConfig(max_iters=iters, tolerance=0.0, reg=Reg.l2(),
                            reg_weight=lam, history=5, **kw))


def _assert_same_solve(rm, rres, pm, pres, w_atol=W_ATOL):
    assert pres.iterations == int(rres.iterations)
    np.testing.assert_allclose(pres.history(), rres.history(),
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(pm.coefficients.means.numpy(),
                               np.asarray(rm.coefficients.means),
                               atol=w_atol)
    assert bool(pres.converged) == bool(rres.converged)
    assert bool(pres.failed) == bool(rres.failed)


@pytest.mark.parametrize("bf16", [False, True])
def test_train_glm_matches_reference(bf16):
    rb, pb = problem(bf16=bf16)
    rcfg, pcfg = _configs()
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            variance=RVar.SIMPLE)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           variance=Var.SIMPLE, device=CPU)
    assert pres.iterations == 10
    _assert_same_solve(rm, rres, pm, pres)
    want_var = np.asarray(rm.coefficients.variances)
    np.testing.assert_allclose(pm.coefficients.variances.numpy(), want_var,
                               rtol=VAR_RTOL[bf16])
    # the variance pass itself, at the reference's final w
    X = pb.X
    obj = T.make_objective(L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           X.n_features, intercept_index=X.last_col_pos,
                           device=CPU)
    w_ref = X.from_model_space(
        torch.from_numpy(np.array(rm.coefficients.means)))
    var = X.to_model_space(compute_variances(obj, w_ref, pb, Var.SIMPLE))
    np.testing.assert_allclose(var.numpy(), want_var, rtol=SAME_W_VAR_RTOL)
    # the reference's trained model, carried over, scores the layout in
    # original column order as the reference does (sums of ~13 terms)
    carried = glm_from_arrays("logistic", np.asarray(rm.coefficients.means),
                              device=CPU)
    np.testing.assert_allclose(carried.predict_mean(pb.X).numpy(),
                               np.asarray(rm.predict_mean(rb.X)), rtol=1e-5,
                               atol=1e-6)


def test_train_glm_matches_reference_pallas_interpret():
    """The reference with its Pallas kernels (interpret mode) on the
    bf16 layout: the same solve as its XLA path, so the same tolerances."""
    rb, pb = problem(seed=2, n=512, d=1000, bf16=True)
    rcfg, pcfg = _configs(iters=5)
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION,
                            dataclasses.replace(rcfg, kernels="on"))
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           device=CPU)
    _assert_same_solve(rm, rres, pm, pres)


def test_train_glm_unregularized_intercept_and_stopping_rule():
    """``regularize_intercept=False`` masks the intercept's permuted
    position; with a tolerance the reference's stopping rule ends both
    solves at the same iteration."""
    rb, pb = problem(seed=1, n=512, d=1000)
    rcfg = RConfig(max_iters=60, tolerance=1e-4, reg=RReg.l2(),
                   reg_weight=1.0, history=5, regularize_intercept=False)
    pcfg = OptimizerConfig(max_iters=60, tolerance=1e-4, reg=Reg.l2(),
                           reg_weight=1.0, history=5,
                           regularize_intercept=False)
    rm, rres = RT.train_glm(rb, RL.TaskType.LOGISTIC_REGRESSION, rcfg)
    pm, pres = T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           device=CPU)
    assert bool(rres.converged) and pres.iterations < 60
    # ~20 iterations to a relative-f tolerance of 1e-4: along the
    # objective's flattest directions that pins w only to a few 1e-4
    _assert_same_solve(rm, rres, pm, pres, w_atol=5e-3)


def test_train_glm_dense_matches_reference():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 24)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=400)
         < 1 / (1 + np.exp(-X @ rng.normal(size=24)))).astype(np.float32)
    rcfg, pcfg = _configs(iters=8, lam=0.5)
    rm, rres = RT.train_glm(RD.make_batch(X, y),
                            RL.TaskType.LOGISTIC_REGRESSION, rcfg,
                            variance=RVar.SIMPLE)
    pm, pres = T.train_glm(make_batch(X, y, device=CPU),
                           L.TaskType.LOGISTIC_REGRESSION, pcfg,
                           variance=Var.SIMPLE, device=CPU)
    _assert_same_solve(rm, rres, pm, pres)
    np.testing.assert_allclose(pm.coefficients.variances.numpy(),
                               np.asarray(rm.coefficients.variances),
                               rtol=VAR_RTOL[False])


def test_train_glm_kernels_on_with_cpu_tensors_raises():
    _, pb = problem(n=64, d=200)
    _, pcfg = _configs(iters=2)
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION,
                    dataclasses.replace(pcfg, kernels="on"), device=CPU)
    assert K.launch_counts() == {}


def test_train_glm_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    _, pb = problem(n=64, d=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, _configs(iters=2)[1])


@pytest.mark.parametrize("what", ["mesh", "chunked"])
def test_train_glm_parts_still_to_port_raise(what):
    """Meshes are ported (tests/test_torch_mesh.py holds them against the
    reference's 8-device mesh); a one-device `BlockedEllRows` under a mesh
    raises the reference's ValueError (the mesh form is
    `shard_blocked_ell_batch`), and a mesh that is not a
    `parallel.mesh.Mesh` a TypeError. A streamed batch (a host
    `ChunkedBatch`, item 5, now ported) solves, and takes the resident
    solve's steps (test_torch_streamed.py holds it against the
    reference); priors, normalization and FULL variances are ported."""
    _, pb = problem(n=64, d=200)
    cfg = _configs(iters=2)[1]
    if what == "mesh":
        from photon_tpu_torch.parallel.mesh import make_mesh

        with pytest.raises(ValueError, match="single-device"):
            T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, cfg,
                        mesh=make_mesh(n_devices=8, device=CPU))
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            T.train_glm(pb, L.TaskType.LOGISTIC_REGRESSION, cfg, device=CPU,
                        mesh=object())
        return
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 10)).astype(np.float32)
    y = (rng.uniform(size=64) < 0.5).astype(np.float32)
    resident = make_batch(X, y, device=CPU)
    _, want = T.train_glm(resident, L.TaskType.LOGISTIC_REGRESSION, cfg,
                          device=CPU)
    _, got = T.train_glm(chunk_batch(resident, 24),
                         L.TaskType.LOGISTIC_REGRESSION, cfg, device=CPU)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.history(), want.history(), rtol=HIST_RTOL)


def test_glm_from_arrays_scores_like_the_reference():
    rb, pb = problem(seed=4, n=256, d=800)
    rng = np.random.default_rng(8)
    w = (0.2 * rng.normal(size=800)).astype(np.float32)
    var = rng.uniform(0.1, 1.0, size=800).astype(np.float32)
    from photon_tpu.models.glm import logistic_regression

    ref_model = logistic_regression(jnp.asarray(w), jnp.asarray(var))
    port_model = glm_from_arrays("logistic", np.asarray(w), np.asarray(var),
                                 device=CPU)
    np.testing.assert_array_equal(port_model.coefficients.variances.numpy(),
                                  var)
    np.testing.assert_allclose(port_model.score(pb.X).numpy(),
                               np.asarray(ref_model.score(rb.X)),
                               rtol=1e-5, atol=1e-5)
