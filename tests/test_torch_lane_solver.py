"""The port's lane-minor grid solvers and `train_glm_grid` against the JAX
package.

On the same numpy-seeded data: the lock-step Wolfe search (per-lane
quadratic, steep and logistic φ, seeded done lanes, a lane that never
satisfies Wolfe; one φ evaluation when a = 1 is accepted by every lane),
the two-loop recursion over a history with holes and the rotating push
(f32 and bf16 storage, sᵀy cached from the unrounded pair), the
lock-step Steihaug CG, and `train_glm_grid` end to end — L2 sweeps on
L-BFGS and TRON, L1 and elastic-net sweeps on OWL-QN, a per-lane (G, d)
start, skewed weights converging independently, SIMPLE variances and a
diagonal prior on the general runner, bf16 history — on dense X and a
`BlockedEllRows`: per-lane iterations equal, loss histories within rtol
1e-5. Each lane also matches the port's own single-lane `train_glm`. The
port runs on the CPU (its kernels' plain versions).
"""
import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import dataclasses  # noqa: E402
import logging  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.models.variance import (  # noqa: E402
    VarianceComputationType as RVar)
from photon_tpu.ops import lane_objective as RLO  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402
from photon_tpu.optim import lane_lbfgs as RLB  # noqa: E402
from photon_tpu.optim import lane_tron as RLT  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import (chunk_batch,  # noqa: E402
                                           make_batch)
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var)
from photon_tpu_torch.ops import lane_objective as LO  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402
from photon_tpu_torch.optim import lane_lbfgs as LB  # noqa: E402
from photon_tpu_torch.optim import lane_tron as LT  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
# zipf rows as the bench makes them, planted logistic labels:
# (reference batch, port batch)
from test_torch_training import problem as bell_problem  # noqa: E402

CPU = "cpu"
LOGISTIC = L.TaskType.LOGISTIC_REGRESSION
RLOGISTIC = RL.TaskType.LOGISTIC_REGRESSION
# Loss history: both sides take the same steps; each loss is an f32 sum
# over 300 rows in another order, a few ulp apart, and the differences
# feed the next step. The budgets below end before any lane reaches the
# f32 floor, where the two sides' stopping iterations would part.
HIST_RTOL = 1e-5
# Coefficients: the same drift along directions in which the loss is
# flat, on values of order 1.
W_ATOL = 1e-3
# The Wolfe search's scalars: the same trial points, an ulp or two.
LS_TOL = 1e-6


def dense_problem(seed=0, n=300, d=40):
    """(reference batch, port batch): N(0, 1) rows (intercept last) and
    labels from a planted logistic model."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    w = (0.5 * rng.normal(size=d)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w))).astype(np.float32)
    return RD.make_batch(X, y), make_batch(X, y, device=CPU)


def small_bell(seed=0):
    return bell_problem(seed=seed, n=300, d=120, k=8, d_dense=16)


def _configs(reg="l2", iters=10, optimizer="LBFGS", **kw):
    rreg, preg = {"l1": (RReg.l1(), Reg.l1()),
                  "l2": (RReg.l2(), Reg.l2()),
                  "en": (RReg.elastic_net(0.5), Reg.elastic_net(0.5))}[reg]
    common = dict(max_iters=iters, tolerance=kw.pop("tolerance", 0.0),
                  reg_weight=0.0, history=5, **kw)
    return (RConfig(reg=rreg, optimizer=ROpt[optimizer], **common),
            OptimizerConfig(reg=preg, optimizer=OptimizerType[optimizer],
                            **common))


def _history(h) -> np.ndarray:
    h = np.asarray(h)
    return h[~np.isnan(h)]


def _assert_same_grid(rgrid, pgrid, w_atol=W_ATOL, zeros=False):
    assert len(pgrid) == len(rgrid)
    for (rm, rr), (pm, pr) in zip(rgrid, pgrid):
        assert pr.iterations == int(rr.iterations)
        np.testing.assert_allclose(pr.history(), _history(rr.loss_history),
                                   rtol=HIST_RTOL)
        wr = np.asarray(rm.coefficients.means)
        wp = pm.coefficients.means.numpy()
        np.testing.assert_allclose(wp, wr, atol=w_atol)
        if zeros:
            np.testing.assert_array_equal(wp == 0, wr == 0)
        assert bool(pr.converged) == bool(rr.converged)
        assert bool(pr.failed) == bool(rr.failed)


def _grids(rb, pb, rcfg, pcfg, weights, **kw):
    pkw = dict(kw)
    rkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if "variance" in kw:
        rkw["variance"] = RVar[kw["variance"].name]
    return (RT.train_glm_grid(rb, RLOGISTIC, rcfg, weights, **rkw),
            T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU,
                             **pkw))


# ------------------------------------------------------------ line search
def _lanes_phi(kinds):
    """φ for G lanes, one function of a per lane; ``lib`` is jnp or torch.
    quadratic: minimum at 0.7 (a = 1 accepted); far: minimum at 5
    (bracketing doubles); steep: exp(3a) − 4a (zoom); logistic:
    log(1 + e^{2 − 3a}) (a = 1 accepted); never: −a (Armijo always, the
    curvature test never)."""
    def one(kind, a, lib):
        if kind == "quadratic":
            return (a - 0.7) ** 2 - 0.49, 2.0 * (a - 0.7)
        if kind == "far":
            return (a - 5.0) ** 2 - 25.0, 2.0 * (a - 5.0)
        if kind == "steep":
            return lib.exp(3.0 * a) - 4.0 * a, 3.0 * lib.exp(3.0 * a) - 4.0
        if kind == "logistic":
            t = 2.0 - 3.0 * a
            return (lib.log(1.0 + lib.exp(t)),
                    -3.0 / (1.0 + lib.exp(-t)))
        return -a, -1.0 + 0.0 * a

    def phi(a, lib):
        parts = [one(k, a[i], lib) for i, k in enumerate(kinds)]
        return (lib.stack([p[0] for p in parts]),
                lib.stack([p[1] for p in parts]))

    return phi


def _wolfe_both(kinds, a_init, done0=None, max_evals=12):
    phi = _lanes_phi(kinds)
    G = len(kinds)
    f0, d0 = phi(np.zeros(G, np.float32), np)
    f0, d0 = np.float32(f0), np.float32(d0)
    a0 = np.full(G, a_init, np.float32)
    want = RLB.wolfe_line_search_lanes(
        lambda a: phi(a, jnp), jnp.asarray(f0), jnp.asarray(d0),
        jnp.asarray(a0), max_evals,
        done0=None if done0 is None else jnp.asarray(done0))
    calls = [0]

    def port_phi(a):
        calls[0] += 1
        return phi(a, torch)

    got = LB.wolfe_line_search_lanes(
        port_phi, torch.from_numpy(f0), torch.from_numpy(d0),
        torch.from_numpy(a0), max_evals,
        done0=None if done0 is None else torch.from_numpy(done0))
    return want, got, calls[0]


def _assert_same_search(want, got):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LS_TOL,
                                   atol=LS_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("a_init", [1.0, 0.05])
def test_wolfe_lanes_match_reference(a_init):
    """Five kinds of lane side by side, one never satisfying Wolfe: the
    search runs to the reference's cap and no further."""
    kinds = ["quadratic", "far", "steep", "logistic", "never"]
    want, got, calls = _wolfe_both(kinds, a_init)
    _assert_same_search(want, got)
    assert calls == 12


def test_wolfe_lanes_seeded_done():
    """Seeded-done lanes keep alpha 0 and ok False; the others search as
    if alone, and the search stops when they are done."""
    kinds = ["quadratic", "never", "steep", "logistic", "never"]
    done0 = np.array([False, True, False, False, True])
    want, got, calls = _wolfe_both(kinds, 1.0, done0=done0)
    _assert_same_search(want, got)
    assert not got[2][[1, 4]].any() and (got[0][[1, 4]] == 0).all()
    _, alone, alone_calls = _wolfe_both(["steep"], 1.0)
    np.testing.assert_array_equal(got[0][2:3].numpy(), alone[0].numpy())
    assert calls == alone_calls < 12


def test_wolfe_lanes_stop_at_the_first_accepted_trial():
    """a = 1 satisfies Wolfe in every lane: one φ evaluation, not twelve."""
    want, got, calls = _wolfe_both(["quadratic", "logistic", "quadratic"],
                                   1.0)
    _assert_same_search(want, got)
    assert calls == 1 and got[2].all()
    np.testing.assert_array_equal(got[0].numpy(), np.ones(3, np.float32))


# ---------------------------------------------------------------- history
def _history_state(dtype, seed=6, m=5, d=60, G=4):
    """A (m, d, G) history with holes: slot/lane pairs invalid at random,
    one lane with no valid pair at all."""
    rng = np.random.default_rng(seed)
    S, Y = rng.normal(size=(2, m, d, G)).astype(np.float32)
    rho = rng.uniform(0.1, 1.0, size=(m, G)).astype(np.float32)
    sy = rng.uniform(0.5, 1.5, size=(m, G)).astype(np.float32)
    yy = rng.uniform(0.5, 2.0, size=(m, G)).astype(np.float32)
    valid = rng.uniform(size=(m, G)) < 0.6
    valid[:, 2] = False
    g = rng.normal(size=(d, G)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = dict(S=jnp.asarray(S).astype(jdt), Y=jnp.asarray(Y).astype(jdt),
               rho=jnp.asarray(rho), valid=jnp.asarray(valid),
               sy=jnp.asarray(sy), yy=jnp.asarray(yy))
    port = dict(S=torch.from_numpy(S).to(tdt), Y=torch.from_numpy(Y).to(tdt),
                rho=torch.from_numpy(rho), valid=torch.from_numpy(valid),
                sy=torch.from_numpy(sy), yy=torch.from_numpy(yy))
    return ref, port, g


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_loop_lanes_matches_reference(dtype):
    """Holes in the history, gamma from each lane's newest valid pair, a
    lane with none (gamma 1): f32 dots over 60 entries."""
    ref, port, g = _history_state(dtype)
    for idx in (0, 3):
        want = RLB.two_loop_lanes(jnp.asarray(g), ref["S"], ref["Y"],
                                  ref["rho"], ref["valid"], jnp.int32(idx),
                                  ref["sy"], ref["yy"])
        got = LB.two_loop_lanes(torch.from_numpy(g), port["S"], port["Y"],
                                port["rho"], port["valid"], idx, port["sy"],
                                port["yy"])
        assert got.dtype == torch.float32
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_two_loop_lanes_skips_unwritten_slots_bit_for_bit():
    """Slots never written (zero, invalid in every lane) change nothing,
    so the recursion over the written ones alone gives the same bits."""
    _, port, g = _history_state("f32")
    for k in ("S", "Y"):
        port[k][3:] = 0.0
    for k in ("rho", "sy", "yy"):
        port[k][3:] = 0.0
    port["valid"][3:] = False
    full = LB.two_loop_lanes(torch.from_numpy(g), port["S"], port["Y"],
                             port["rho"], port["valid"], 3, port["sy"],
                             port["yy"])
    part = LB.two_loop_lanes(torch.from_numpy(g), port["S"], port["Y"],
                             port["rho"], port["valid"], 3, port["sy"],
                             port["yy"], slots=3)
    assert torch.equal(full, part)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_push_lanes_matches_reference(dtype):
    """Lanes that accept and pass the curvature test write the slot; a
    rejected lane and one failing curvature (y = −s) leave it invalid.
    sᵀy and yᵀy are cached from the UNROUNDED pair, before the cast."""
    ref, port, _ = _history_state(dtype)
    rng = np.random.default_rng(7)
    s = rng.normal(size=(60, 4)).astype(np.float32)
    y = (s + 0.3 * rng.normal(size=(60, 4))).astype(np.float32)
    y[:, 3] = -s[:, 3]
    accept = np.array([True, False, True, True])
    idx = 2
    want = RLB._push_lanes(ref["S"], ref["Y"], ref["rho"], ref["valid"],
                           jnp.int32(idx), jnp.asarray(s), jnp.asarray(y),
                           jnp.asarray(accept), ref["sy"], ref["yy"])
    nxt = LB._push_lanes(port["S"], port["Y"], port["rho"], port["valid"],
                         idx, torch.from_numpy(s), torch.from_numpy(y),
                         torch.from_numpy(accept), port["sy"], port["yy"])
    assert nxt == int(want[4]) == 3
    for got, w in zip((port["S"], port["Y"]), want[:2]):
        np.testing.assert_array_equal(_f32(got), _f32(w))
    np.testing.assert_array_equal(port["valid"].numpy(),
                                  np.asarray(want[3]))
    assert port["valid"][idx].tolist() == [True, False, True, False]
    for got, w in zip((port["rho"], port["sy"], port["yy"]),
                      (want[2], want[5], want[6])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
    exact = (s[:, 0].astype(np.float64) * y[:, 0]).sum()
    np.testing.assert_allclose(float(port["sy"][idx, 0]), exact, rtol=1e-6)
    if dtype == "bf16":  # the rounded pair's product is another number
        rounded = (_f32(port["S"])[idx, :, 0].astype(np.float64)
                   * _f32(port["Y"])[idx, :, 0]).sum()
        assert abs(rounded - exact) > 1e-6 * abs(exact)


# --------------------------------------------------------------- lane CG
def test_cg_lanes_matches_reference_and_stops_with_the_last_lane():
    """The lock-step Steihaug CG: (p, zp, r) as the reference's, and it
    stops when its slowest lane does — the per-lane solves alone take at
    most as many steps, the slowest exactly as many — not at max_cg."""
    rng = np.random.default_rng(3)
    n, d, G = 300, 40, 3
    # columns scaled over two decades: CG needs several steps, fewer for
    # the heavily regularized lane
    X = (rng.normal(size=(n, d))
         * np.logspace(-1, 1, d)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    rb, pb = RD.make_batch(X, y), make_batch(X, y, device=CPU)
    W = (0.1 * rng.normal(size=(d, G))).astype(np.float32)
    l2s = np.array([1e-3, 0.1, 1e3], np.float32)
    ro = RObjective(RLOGISTIC, l2=np.float32(0.0))
    po = Objective(LOGISTIC)
    rz, pz = (RLO.margin_lanes(ro, jnp.asarray(W), rb),
              LO.margin_lanes(po, torch.from_numpy(W), pb))
    rg = RLO.grad_at_margin_lanes(ro, jnp.asarray(l2s), jnp.asarray(W), rz,
                                  rb)
    pg = LO.grad_at_margin_lanes(po, torch.from_numpy(l2s),
                                 torch.from_numpy(W), pz, pb)
    delta = np.full(G, 1e4, np.float32)
    want = RLT._cg_trust_margin_lanes(ro, jnp.asarray(l2s), rz, rb, rg,
                                      jnp.asarray(delta), 40)
    p, zp, r, steps = LT._cg_trust_margin_lanes(
        po, torch.from_numpy(l2s), pz, pb, pg, torch.from_numpy(delta), 40)
    for got, w in zip((p, zp, r), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    alone = [LT._cg_trust_margin_lanes(
        po, torch.from_numpy(l2s[i:i + 1]), pz[:, i:i + 1].contiguous(), pb,
        pg[:, i:i + 1].contiguous(), torch.from_numpy(delta[i:i + 1]),
        40)[3] for i in range(G)]
    assert steps == max(alone) < 40 and min(alone) < steps


# ------------------------------------------------------------ the solvers
@pytest.mark.parametrize("layout,G", [("blocked_ell", 3), ("dense", 8),
                                      ("dense", 1)])
def test_grid_lbfgs_matches_reference(layout, G):
    rb, pb = small_bell() if layout == "blocked_ell" else dense_problem()
    # 40 dense features: the heavy lanes reach the f32 floor by iteration
    # 8, so the dense budget ends before it
    rcfg, pcfg = _configs(iters=10 if layout == "blocked_ell" else 6)
    weights = list(np.geomspace(1e-2, 10.0, G))
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, weights)
    _assert_same_grid(rgrid, pgrid)
    # the lock-step search stops where the reference's does: far fewer
    # trials than the masked twelve per iteration
    its = max(r.iterations for _, r in pgrid)
    assert its <= pgrid[0][1].trials <= 2 * its


def test_grid_tron_matches_reference():
    """Reg weights that keep each Newton system well conditioned, so CG
    converges inside its budget on both sides (at light reg its
    rarely-touched columns leave CG unconverged at the cap, and sums in
    another order move the step on both sides alike)."""
    rb, pb = small_bell(seed=2)
    rcfg, pcfg = _configs(iters=4, optimizer="TRON", cg_max_iters=20)
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, [3.0, 10.0, 30.0])
    _assert_same_grid(rgrid, pgrid)
    res = pgrid[0][1]
    assert res.iterations < res.hvps < 20 * res.iterations


@pytest.mark.parametrize("reg", ["l1", "en"])
def test_grid_owlqn_matches_reference(reg):
    """Any L1 weight routes the sweep to the OWL-QN lanes: the same
    exactly-zero coefficients per lane."""
    rb, pb = dense_problem(seed=1)
    rcfg, pcfg = _configs(reg, iters=8)
    weights = [1.0, 4.0, 16.0]
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, weights)
    _assert_same_grid(rgrid, pgrid, zeros=True)
    wz = pgrid[-1][0].coefficients.means
    assert 0 < int((wz == 0).sum()) < wz.numel()
    assert pgrid[0][1].trials >= pgrid[0][1].iterations


def test_grid_per_lane_w0_matches_reference():
    """A lane-major (G, d) start: each lane from its own row."""
    rb, pb = dense_problem(seed=4)
    rcfg, pcfg = _configs(iters=6)
    w0 = (0.2 * np.random.default_rng(9).normal(size=(3, 40))).astype(
        np.float32)
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, [0.1, 1.0, 10.0], w0=w0)
    _assert_same_grid(rgrid, pgrid)
    for i, (_, r) in enumerate(pgrid):
        assert r.history()[0] != pgrid[(i + 1) % 3][1].history()[0]


def test_grid_skewed_weights_converge_independently():
    """A heavy lane converges in a handful of iterations and freezes
    while the light one runs on: per-lane iteration counts as the
    reference's."""
    rb, pb = small_bell(seed=1)
    rcfg, pcfg = _configs(iters=60, tolerance=1e-4)
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, [1.0, 1e4])
    its = [r.iterations for _, r in pgrid]
    assert its[1] < its[0] < 60
    assert all(bool(r.converged) for _, r in pgrid)
    _assert_same_grid(rgrid, pgrid, w_atol=5e-3)


def test_grid_device_results_layout():
    """device_results: the lane-major result as tensors, variances None,
    the same numbers as the per-lane list."""
    _, pb = small_bell()
    _, pcfg = _configs(iters=5)
    weights = [0.1, 1.0, 10.0]
    res, var = T.train_glm_grid(pb, LOGISTIC, pcfg, weights,
                                device_results=True, device=CPU)
    d = pb.X.n_features
    assert var is None
    assert tuple(res.w.shape) == (3, d)
    assert tuple(res.loss_history.shape) == (3, 6)
    for t in (res.value, res.grad_norm, res.iterations, res.converged,
              res.failed):
        assert tuple(t.shape) == (3,)
    grid = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    for i, (model, r) in enumerate(grid):
        assert torch.equal(model.coefficients.means, res.w[i])
        assert torch.equal(r.loss_history, res.loss_history[i])
        assert r.iterations == int(res.iterations[i])


def test_grid_simple_variances_on_the_general_runner(caplog):
    """SIMPLE variances run each lane's single solve and variances in turn
    (the reference vmaps them), and say so at INFO."""
    rb, pb = small_bell(seed=3)
    rcfg, pcfg = _configs(iters=6)
    with caplog.at_level(logging.INFO, logger="photon_tpu_torch.models"):
        rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, [0.3, 3.0],
                              variance=Var.SIMPLE)
    assert "general runner" in caplog.text
    _assert_same_grid(rgrid, pgrid)
    for (rm, _), (pm, _) in zip(rgrid, pgrid):
        np.testing.assert_allclose(pm.coefficients.variances.numpy(),
                                   np.asarray(rm.coefficients.variances),
                                   rtol=1e-4)


def test_grid_diagonal_prior_on_the_general_runner():
    """A shared diagonal prior (original column order, on a permuted
    layout) sends the sweep to the general runner."""
    rb, pb = small_bell(seed=5)
    rcfg, pcfg = _configs(iters=6)
    rng = np.random.default_rng(10)
    d = pb.X.n_features
    mean = (0.1 * rng.normal(size=d)).astype(np.float32)
    prec = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    rgrid, pgrid = _grids(rb, pb, rcfg, pcfg, [0.1, 1.0], prior_mean=mean,
                          prior_precision=prec)
    _assert_same_grid(rgrid, pgrid)


def test_grid_bf16_history_quality():
    """bf16 S/Y storage with f32 steering: the reference's own tolerance
    against the f32-history run (final values rtol 1e-5, coefficients
    atol 2e-2), and the reference's bf16 run's final values."""
    rb, pb = small_bell(seed=6)
    rcfg, pcfg = _configs(iters=80, tolerance=1e-6)
    weights = [0.3, 1.0, 10.0]
    g32 = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    g16 = T.train_glm_grid(
        pb, LOGISTIC, dataclasses.replace(pcfg,
                                          lane_history_dtype="bfloat16"),
        weights, device=CPU)
    r16 = RT.train_glm_grid(
        rb, RLOGISTIC, dataclasses.replace(rcfg,
                                           lane_history_dtype="bfloat16"),
        weights)
    for (m32, r32), (m16, p16), (_, rr16) in zip(g32, g16, r16):
        assert bool(p16.converged)
        np.testing.assert_allclose(float(p16.value), float(r32.value),
                                   rtol=1e-5)
        np.testing.assert_allclose(m16.coefficients.means.numpy(),
                                   m32.coefficients.means.numpy(), atol=2e-2)
        np.testing.assert_allclose(float(p16.value), float(rr16.value),
                                   rtol=1e-5)


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_grid_lanes_match_sequential_train_glm(optimizer):
    """Lane i of the port's grid is the port's own train_glm at weight i:
    the same iterations and loss history."""
    _, pb = small_bell(seed=7)
    weights = [3.0, 10.0, 30.0]
    _, pcfg = _configs(iters=5, optimizer=optimizer, cg_max_iters=20)
    grid = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    for wt, (model, res) in zip(weights, grid):
        m1, r1 = T.train_glm(pb, LOGISTIC,
                             dataclasses.replace(pcfg, reg_weight=wt),
                             device=CPU)
        assert res.iterations == r1.iterations
        np.testing.assert_allclose(res.history(), r1.history(),
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(model.coefficients.means.numpy(),
                                   m1.coefficients.means.numpy(),
                                   atol=W_ATOL)


def test_lane_weight_arrays_match_reference():
    """The route switch: an L1 weight anywhere forces OWL-QN for every
    lane; the static config is weight-normalized."""
    for reg, opt in (("l2", "LBFGS"), ("l2", "TRON"), ("en", "LBFGS"),
                     ("l1", "TRON")):
        rcfg, pcfg = _configs(reg, optimizer=opt)
        rcfg = dataclasses.replace(rcfg, reg_weight=2.0)
        pcfg = dataclasses.replace(pcfg, reg_weight=2.0)
        rl2, rl1, rstatic = RT.lane_weight_arrays(rcfg, [0.0, 0.5, 3.0])
        pl2, pl1, pstatic = T.lane_weight_arrays(pcfg, [0.0, 0.5, 3.0])
        np.testing.assert_array_equal(pl2.numpy(), np.asarray(rl2))
        assert (pl1 is None) == (rl1 is None)
        if rl1 is not None:
            np.testing.assert_array_equal(pl1.numpy(), np.asarray(rl1))
        assert pstatic.optimizer.value == rstatic.optimizer.value
        assert pstatic.reg_weight == 0.0


# ---------------------------------------------------------- what raises
@pytest.mark.parametrize("what", ["mesh", "chunked"])
def test_grid_parts_still_to_port_raise(what):
    """Meshes are ported (tests/test_torch_mesh.py holds the grid on a
    mesh); a one-device `BlockedEllRows` under a mesh raises the
    reference's ValueError (its buckets cannot be row-sharded: the mesh
    form is `shard_blocked_ell_batch`). A streamed batch (a host
    `ChunkedBatch`) raises the reference's ValueError: streamed mode has
    no lane grid (each point is a train_glm solve). Normalization,
    priors, FULL variances and SparseRows grids are ported
    (test_torch_prior_norm.py holds them)."""
    _, pb = small_bell()
    _, pcfg = _configs(iters=2)
    if what == "mesh":
        from photon_tpu_torch.parallel.mesh import make_mesh

        with pytest.raises(ValueError, match="single-device"):
            T.train_glm_grid(pb, LOGISTIC, pcfg, [0.1, 1.0],
                             mesh=make_mesh(n_devices=8, device=CPU))
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            T.train_glm_grid(pb, LOGISTIC, pcfg, [0.1, 1.0], device=CPU,
                             mesh=object())
        return
    chunked = chunk_batch(make_batch(np.zeros((8, 3), np.float32),
                                     np.zeros(8), device=CPU), 4)
    with pytest.raises(ValueError, match="streamed mode has no lane-minor "
                                         "grid"):
        RT.train_glm_grid(RD.chunk_batch(RD.make_batch(np.zeros((8, 3)),
                                                       np.zeros(8)), 4),
                          RLOGISTIC, _configs(iters=2)[0], [0.1, 1.0])
    with pytest.raises(ValueError, match="streamed mode has no lane-minor "
                                         "grid"):
        T.train_glm_grid(chunked, LOGISTIC, pcfg, [0.1, 1.0], device=CPU)


def test_grid_kernels_on_with_cpu_tensors_raises():
    _, pb = small_bell()
    _, pcfg = _configs(iters=2)
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train_glm_grid(pb, LOGISTIC, dataclasses.replace(pcfg,
                                                           kernels="on"),
                         [0.1, 1.0], device=CPU)
    assert K.launch_counts() == {}


def test_grid_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    _, pb = small_bell()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_glm_grid(pb, LOGISTIC, _configs(iters=2)[1], [0.1, 1.0])
