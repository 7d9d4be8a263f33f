"""The port's OWL-QN and TRON against the JAX package.

On the same numpy-seeded data: the pseudo-gradient, the Hessian-vector
products, `minimize_owlqn` on a dense problem (L1 and elastic net, the
intercept in the mask or not), and `train_glm` with L1 (OWL-QN) and with
TRON on dense X and on `BlockedEllRows` — iteration count equal, loss
history within 1e-5, the same exactly-zero coefficients for L1. The port
runs on the CPU (its kernels' plain versions); the reference's dense
OWL-QN runs its fused Pallas kernel in interpret mode, as it does by
itself off the TPU.
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
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402
from photon_tpu.optim import owlqn as ROW  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch.convert import glm_from_arrays  # noqa: E402
from photon_tpu_torch.data.dataset import cast_features, make_batch  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402
from photon_tpu_torch.optim import owlqn as OW  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType  # noqa: E402
# the blocked-ELL problem of the L-BFGS parity tests: zipf rows as the
# bench makes them, planted logistic labels; (reference batch, port batch)
from test_torch_training import problem as bell_problem  # noqa: E402

CPU = "cpu"
LOGISTIC, RLOGISTIC = L.TaskType.LOGISTIC_REGRESSION, RL.TaskType.LOGISTIC_REGRESSION
# Loss history: both sides take the same steps; each loss is an f32 sum
# over ~1,000–2,000 rows added in another order, a few ulp apart, and the
# differences feed the next step. These planted-signal problems stay well
# conditioned, so 1e-5 holds over the iteration budgets below.
HIST_RTOL = 1e-5
# Coefficients: the same drift, along directions in which the loss is
# flat, on values of order 1.
W_ATOL = 1e-3
# Elementwise work on (d,) vectors: an ulp or two.
ELEM_RTOL = 1e-6


def dense_problem(seed=0, n=2048, d=32):
    """Dense rows (intercept last) with labels from a planted sparse
    logistic model: a third of the true coefficients are zero."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    w_true = rng.normal(size=d).astype(np.float32)
    w_true[::3] = 0.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w_true))).astype(
        np.float32)
    return X, y


def _configs(reg, lam, iters=10, **kw):
    rreg, preg = {"l1": (RReg.l1(), Reg.l1()),
                  "l2": (RReg.l2(), Reg.l2()),
                  "en": (RReg.elastic_net(0.5), Reg.elastic_net(0.5))}[reg]
    common = dict(max_iters=iters, tolerance=0.0, reg_weight=lam, history=5,
                  **kw)
    ropt = common.pop("optimizer", None)
    return (RConfig(reg=rreg, optimizer=ROpt[ropt] if ropt else
                    ROpt.LBFGS, **common),
            OptimizerConfig(reg=preg, optimizer=OptimizerType[ropt] if ropt
                            else OptimizerType.LBFGS, **common))


def _assert_same_solve(rm, rres, pm, pres, zeros=False, w_atol=W_ATOL):
    assert pres.iterations == int(rres.iterations)
    np.testing.assert_allclose(pres.history(), rres.history(),
                               rtol=HIST_RTOL)
    wr = np.asarray(rm.coefficients.means)
    wp = pm.coefficients.means.numpy()
    np.testing.assert_allclose(wp, wr, atol=w_atol)
    if zeros:
        assert (wr == 0).any() and not (wr == 0).all()
        np.testing.assert_array_equal(wp == 0, wr == 0)
    assert bool(pres.converged) == bool(rres.converged)
    assert bool(pres.failed) == bool(rres.failed)


# ------------------------------------------------------------------ OWL-QN
def test_pseudo_gradient_matches_reference():
    """On w with exact zeros, a mask with zeros, and g on both sides of
    ±λ: elementwise f32, an ulp or so."""
    rng = np.random.default_rng(1)
    d = 301
    w = rng.normal(size=d).astype(np.float32)
    w[::3] = 0.0
    g = (3.0 * rng.normal(size=d)).astype(np.float32)
    g[1::3] = np.float32(1.5)  # exactly λ at w = 0 on some coordinates
    mask = np.ones(d, np.float32)
    mask[::5] = 0.0
    want = ROW.pseudo_gradient(jnp.asarray(w), jnp.asarray(g),
                               np.float32(1.5), jnp.asarray(mask))
    got = OW.pseudo_gradient(torch.from_numpy(w), torch.from_numpy(g), 1.5,
                             torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ELEM_RTOL, atol=1e-7)
    assert (got.numpy() == 0).sum() == (np.asarray(want) == 0).sum() > 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reg", ["l1", "en"])
def test_minimize_owlqn_matches_reference(reg, masked):
    """The same dense problem through both solvers on the fused objective;
    ``masked`` leaves the intercept out of both penalties."""
    X, y = dense_problem(seed=2)
    d = X.shape[1]
    lam = 30.0
    l1 = lam if reg == "l1" else 0.5 * lam
    l2 = 0.0 if reg == "l1" else 0.5 * lam
    mask = np.ones(d, np.float32)
    if masked:
        mask[-1] = 0.0
    rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
    ro = RObjective(RLOGISTIC, l2=np.float32(l2), fused=True,
                    reg_mask=jnp.asarray(mask) if masked else None)
    po = Objective(LOGISTIC, l2=l2, fused=True,
                   reg_mask=torch.from_numpy(mask) if masked else None)
    rres = ROW.minimize_owlqn(lambda w: ro.value_and_grad(w, rb),
                              jnp.zeros(d, jnp.float32), np.float32(l1),
                              max_iters=30, tolerance=1e-6, history=10,
                              reg_mask=ro.reg_mask)
    pres = OW.minimize_owlqn(lambda w: po.value_and_grad(w, pb),
                             torch.zeros(d), l1, max_iters=30,
                             tolerance=1e-6, history=10,
                             reg_mask=po.reg_mask)
    assert pres.iterations == int(rres.iterations) > 3
    np.testing.assert_allclose(pres.history(), np.asarray(rres.history()),
                               rtol=HIST_RTOL)
    wr, wp = np.asarray(rres.w), pres.w.numpy()
    np.testing.assert_allclose(wp, wr, atol=W_ATOL)
    assert 0 < (wr == 0).sum() < d
    np.testing.assert_array_equal(wp == 0, wr == 0)
    if masked:
        assert wp[-1] != 0.0  # the unpenalized intercept stays in
    assert bool(pres.converged) == bool(rres.converged)


def test_owlqn_keeps_the_accepted_trial():
    """The port does not evaluate f and g again at the accepted point: no
    two evaluations in a row are at the same w, the count is the port's
    own, and the history still equals the reference's, which does
    evaluate again."""
    X, y = dense_problem(seed=4)
    d = X.shape[1]
    rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
    ro = RObjective(RLOGISTIC, fused=True)
    po = Objective(LOGISTIC, fused=True)
    points = []

    def vg(w):
        points.append(w.clone())
        return po.value_and_grad(w, pb)

    pres = OW.minimize_owlqn(vg, torch.zeros(d), 30.0, max_iters=6,
                             tolerance=0.0, history=10)
    rres = ROW.minimize_owlqn(lambda w: ro.value_and_grad(w, rb),
                              jnp.zeros(d, jnp.float32), np.float32(30.0),
                              max_iters=6, tolerance=0.0, history=10)
    assert pres.evaluations == len(points) > pres.iterations
    assert not any(torch.equal(a, b) for a, b in zip(points, points[1:]))
    assert torch.equal(pres.w, points[-1])  # the last trial, accepted
    assert pres.iterations == int(rres.iterations)
    np.testing.assert_allclose(pres.history(), np.asarray(rres.history()),
                               rtol=HIST_RTOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("reg", ["l1", "en"])
def test_train_glm_owlqn_dense_matches_reference(reg, bf16):
    """The reference's objective is then fused (Pallas interpret, its
    batch padded to 4,096 rows); the port's is fused too, unpadded. Six
    iterations end before the f32 floor, where with tolerance 0 the last
    line search fails on noise at an iteration that noise picks."""
    X, y = dense_problem(seed=0, n=1500, d=128)
    rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
    if bf16:
        rb, pb = RD.cast_features(rb), cast_features(pb)
    rcfg, pcfg = _configs(reg, 30.0, iters=6, regularize_intercept=False)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    assert pres.evaluations > pres.iterations > 3
    _assert_same_solve(rm, rres, pm, pres, zeros=True)


def test_train_glm_sets_fused_for_dense_owlqn_only():
    X, y = dense_problem(seed=6, n=256)
    pb = make_batch(X, y, device=CPU)
    seen = []
    real = T.solve

    def spy(obj, batch, w0, config):
        seen.append(obj.fused)
        return real(obj, batch, w0, config)

    _, bell = bell_problem(n=256, d=400)
    T.solve, saved = spy, T.solve
    try:
        for batch, reg, opt in ((pb, "l1", None), (pb, "l2", None),
                                (pb, "l2", "TRON"), (bell, "l1", None)):
            kw = {"optimizer": opt} if opt else {}
            T.train_glm(batch, LOGISTIC, _configs(reg, 1.0, iters=2,
                                                  **kw)[1], device=CPU)
    finally:
        T.solve = saved
    assert seen == [True, False, False, False]


@pytest.mark.parametrize("bf16", [False, True])
def test_train_glm_owlqn_blocked_ell_matches_reference(bf16):
    """OWL-QN on the permuted layout: the unfused value_and_grad through
    the blocked-ELL X passes; the intercept's permuted position is left
    out of the L1 term."""
    rb, pb = bell_problem(seed=3, bf16=bf16)
    rcfg, pcfg = _configs("l1", 2.0, iters=8, regularize_intercept=False)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    _assert_same_solve(rm, rres, pm, pres, zeros=True)


def test_glm_from_arrays_carries_exact_zeros():
    """An L1 model's coefficients cross bit for bit, zeros included, and
    score as the reference scores them."""
    X, y = dense_problem(seed=7, n=512)
    rb = RD.make_batch(X, y)
    rm, _ = RT.train_glm(rb, RLOGISTIC, _configs("l1", 30.0, iters=10)[0])
    wr = np.asarray(rm.coefficients.means)
    assert 0 < (wr == 0).sum() < wr.size
    carried = glm_from_arrays("logistic", wr, device=CPU)
    wp = carried.coefficients.means.numpy()
    np.testing.assert_array_equal(wp.view(np.uint32), wr.view(np.uint32))
    pb = make_batch(X, y, device=CPU)
    np.testing.assert_allclose(carried.predict_mean(pb.X).numpy(),
                               np.asarray(rm.predict_mean(rb.X)),
                               rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------------- TRON
@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_hvp_matches_reference(layout):
    """hvp and hvp_at_margin (with and without the direction's margin):
    sums over ~1,000–2,000 rows in another order, rtol 1e-5 of the
    product's scale."""
    if layout == "dense":
        X, y = dense_problem(seed=8)
        rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
        d = X.shape[1]
    else:
        rb, pb = bell_problem(seed=8)
        d = pb.X.n_features
    rng = np.random.default_rng(9)
    w, v = (0.1 * rng.normal(size=(2, d))).astype(np.float32)
    mask = np.ones(d, np.float32)
    mask[-1] = 0.0
    tau = rng.uniform(0.0, 2.0, size=d).astype(np.float32)
    ro = RObjective(RLOGISTIC, l2=np.float32(0.5), reg_mask=jnp.asarray(mask),
                    prior_precision=jnp.asarray(tau))
    po = Objective(LOGISTIC, l2=0.5, reg_mask=torch.from_numpy(mask),
                   prior_precision=torch.from_numpy(tau))
    wr, vr = jnp.asarray(w), jnp.asarray(v)
    wp, vp = torch.from_numpy(w), torch.from_numpy(v)
    want = np.asarray(ro.hvp(wr, rb, vr))
    atol = 1e-5 * np.abs(want).max()
    zr, zp = ro.margin(wr, rb), po.margin(wp, pb)
    for got in (po.hvp(wp, pb, vp), po.hvp_at_margin(wp, zp, pb, vp),
                po.hvp_at_margin(wp, zp, pb, vp,
                                 dz_v=po.direction_margin(vp, pb))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(
        po.hvp_at_margin(wp, zp, pb, vp).numpy(),
        np.asarray(ro.hvp_at_margin(wr, zr, rb, vr)), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("layout", ["dense", "f32", "bf16"])
def test_train_glm_tron_matches_reference(layout):
    """Budgets that end before the f32 floor. On the sparse layout reg 10
    keeps each Newton system well conditioned, so CG converges inside its
    budget: at reg 1 its rarely-touched columns leave CG unconverged at
    the cap, and sums in another order move the step by up to 1e-2 on
    both sides alike."""
    if layout == "dense":
        X, y = dense_problem(seed=0, d=128)
        rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
        lam, iters = 1.0, 6
    else:
        rb, pb = bell_problem(seed=2, bf16=layout == "bf16")
        lam, iters = 10.0, 4
    rcfg, pcfg = _configs("l2", lam, iters=iters, optimizer="TRON",
                          cg_max_iters=20)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    assert pres.hvps > pres.iterations > 2
    _assert_same_solve(rm, rres, pm, pres)


def test_tron_cg_budget_and_tolerance_stop():
    """A one-step CG budget and a tolerance: both solves stop at the same
    iteration by the reference's rules."""
    X, y = dense_problem(seed=12)
    rcfg, pcfg = _configs("l2", 1.0, iters=60, optimizer="TRON",
                          cg_max_iters=1)
    rcfg = dataclasses.replace(rcfg, tolerance=1e-5)
    pcfg = dataclasses.replace(pcfg, tolerance=1e-5)
    rm, rres = RT.train_glm(RD.make_batch(X, y), RLOGISTIC, rcfg)
    pm, pres = T.train_glm(make_batch(X, y, device=CPU), LOGISTIC, pcfg,
                           device=CPU)
    assert bool(rres.converged) and pres.iterations < 60
    assert pres.hvps == pres.iterations
    _assert_same_solve(rm, rres, pm, pres, w_atol=5e-3)
