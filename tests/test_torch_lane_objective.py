"""The port's lane-minor objective against the JAX package.

On the same numpy-seeded data, G ∈ {1, 3, 8} lanes: every function of
`photon_tpu_torch.ops.lane_objective` (margins, the ray's regularizer
coefficients, φ along the ray, the Hessian-vector product with and
without the direction's margin, the value, the gradient, both together)
against `photon_tpu.ops.lane_objective` on dense X and on a small
`BlockedEllRows`, with a regularization mask, non-zero offsets and
weights; and the lane X passes against the single-lane ones. The port
runs on the CPU (its kernels' plain versions).
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
from typing import Optional  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.ops import lane_objective as RLO  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402

from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.ops import lane_objective as LO  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402
# the small blocked-ELL layout of the X-pass parity tests: (reference,
# port) pair built from the same padded COO rows
from test_torch_blocked_ell import layouts, rows  # noqa: E402

CPU = "cpu"
# Each lane's sums run over ~300 rows (or 120 features) in another order
# on the two sides (XLA vs PyTorch): a few ulp of the sum's magnitude.
# Where terms cancel, a sum far below its terms keeps that ABSOLUTE
# error, so atol is 1e-6 of the output's largest magnitude (and at least
# 1e-6).
RTOL, ATOL = 1e-5, 1e-6
LANES = [1, 3, 8]


def _problem(layout: str, G: int, seed=0):
    """(reference batch, port batch, d, the lane operands as numpy): the
    same X, labels, weights and offsets on both sides; W, P, V (d, G) of
    scale 0.1, per-lane L2 weights and step lengths."""
    rng = np.random.default_rng(seed)
    n = 300
    if layout == "dense":
        d = 120
        X = rng.normal(size=(n, d)).astype(np.float32)
        X[:, -1] = 1.0
        rX, pX = X, X
    else:
        rX, pX = layouts(seed, d_dense=16, n=n, d=1000)
        d = pX.n_features
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::7] = 0.0
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    rb = RD.make_batch(rX, y, weights=wt, offsets=off)
    pb = make_batch(pX, y, weights=wt, offsets=off, device=CPU)
    ops = dict(
        W=(0.1 * rng.normal(size=(d, G))).astype(np.float32),
        P=(0.1 * rng.normal(size=(d, G))).astype(np.float32),
        V=(0.1 * rng.normal(size=(d, G))).astype(np.float32),
        l2s=rng.uniform(0.1, 3.0, size=G).astype(np.float32),
        a=rng.uniform(0.2, 1.5, size=G).astype(np.float32),
        mask=np.ones(d, np.float32))
    ops["mask"][-1] = 0.0
    return rb, pb, d, ops


def _objectives(ops, task="logistic"):
    mask = ops["mask"]
    ro = RObjective(RL.TaskType(task), l2=np.float32(0.0),
                    reg_mask=jnp.asarray(mask))
    po = Objective(L.TaskType(task), l2=0.0,
                   reg_mask=torch.from_numpy(mask))
    return ro, po


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _sides(ops, *names):
    return ([jnp.asarray(ops[k]) for k in names],
            [torch.from_numpy(ops[k]) for k in names])


@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_margins_match_reference(layout):
    for G in LANES:
        rb, pb, _, ops = _problem(layout, G)
        ro, po = _objectives(ops)
        (rW, rP), (pW, pP) = _sides(ops, "W", "P")
        _close(LO.margin_lanes(po, pW, pb), RLO.margin_lanes(ro, rW, rb))
        _close(LO.direction_margin_lanes(po, pP, pb),
               RLO.direction_margin_lanes(ro, rP, rb))


@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_ray_and_phi_match_reference(layout):
    """The ray's (c0, c1, c2) and (φ(a), φ'(a)) from cached margins."""
    for G in LANES:
        rb, pb, _, ops = _problem(layout, G)
        ro, po = _objectives(ops)
        (rW, rP, rl2, ra), (pW, pP, pl2, pa) = _sides(ops, "W", "P", "l2s",
                                                      "a")
        rc = RLO.ray_reg_coeffs_lanes(ro, rl2, rW, rP)
        pc = LO.ray_reg_coeffs_lanes(po, pl2, pW, pP)
        _close(pc, rc)
        rz, rdz = RLO.margin_lanes(ro, rW, rb), RLO.direction_margin_lanes(
            ro, rP, rb)
        pz, pdz = LO.margin_lanes(po, pW, pb), LO.direction_margin_lanes(
            po, pP, pb)
        _close(LO.phi_at_ray_lanes(po, pz, pdz, pa, pc, pb),
               RLO.phi_at_ray_lanes(ro, rz, rdz, ra, rc, rb))


@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_hvp_matches_reference(layout):
    """With the directions' margins computed inside and passed in."""
    for G in LANES:
        rb, pb, _, ops = _problem(layout, G)
        ro, po = _objectives(ops)
        (rW, rV, rl2), (pW, pV, pl2) = _sides(ops, "W", "V", "l2s")
        rz, pz = RLO.margin_lanes(ro, rW, rb), LO.margin_lanes(po, pW, pb)
        want = RLO.hvp_at_margin_lanes(ro, rl2, rz, rb, rV)
        _close(LO.hvp_at_margin_lanes(po, pl2, pz, pb, pV), want)
        dzv = LO.direction_margin_lanes(po, pV, pb)
        _close(LO.hvp_at_margin_lanes(po, pl2, pz, pb, pV, dZv=dzv), want)


@pytest.mark.parametrize("task", ["logistic", "linear", "poisson"])
@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_value_and_grad_match_reference(layout, task):
    """value, grad and value_and_grad at cached margins, per task."""
    for G in LANES:
        rb, pb, _, ops = _problem(layout, G)
        ro, po = _objectives(ops, task)
        (rW, rl2), (pW, pl2) = _sides(ops, "W", "l2s")
        rz, pz = RLO.margin_lanes(ro, rW, rb), LO.margin_lanes(po, pW, pb)
        _close(LO.value_at_margin_lanes(po, pl2, pW, pz, pb),
               RLO.value_at_margin_lanes(ro, rl2, rW, rz, rb))
        _close(LO.grad_at_margin_lanes(po, pl2, pW, pz, pb),
               RLO.grad_at_margin_lanes(ro, rl2, rW, rz, rb))
        _close(LO.value_and_grad_at_margin_lanes(po, pl2, pW, pz, pb),
               RLO.value_and_grad_at_margin_lanes(ro, rl2, rW, rz, rb))


@pytest.mark.parametrize("layout", ["dense", "blocked_ell"])
def test_lane_x_passes_are_the_single_lane_passes(layout):
    """Lane g of matvec_lanes / rmatvec_lanes is the single-lane pass of
    column g (one product of the stacked operand: the same sums up to the
    order a batched product takes)."""
    _, pb, d, ops = _problem(layout, 3)
    rng = np.random.default_rng(5)
    W = torch.from_numpy(ops["W"])
    R = torch.from_numpy(rng.normal(size=(pb.n, 3)).astype(np.float32))
    mv, rv = M.matvec_lanes(pb.X, W), M.rmatvec_lanes(pb.X, R)
    assert tuple(mv.shape) == (pb.n, 3) and tuple(rv.shape) == (d, 3)
    for g in range(3):
        _close(mv[:, g], M.matvec(pb.X, W[:, g].contiguous()).numpy())
        _close(rv[:, g], M.rmatvec(pb.X, R[:, g].contiguous()).numpy())


def test_supports_lanes_and_normalization():
    """A shared (d,) prior or a full-covariance one sends a sweep off the
    lane path, per-lane (d, G) priors stay on it; an objective carrying
    normalization folds it into every lane as the reference's does."""
    po = Objective(L.TaskType.LOGISTIC_REGRESSION)
    assert LO.supports_lanes(po)
    assert not LO.supports_lanes(dataclasses.replace(
        po, prior_mean=torch.zeros(4)))
    assert not LO.supports_lanes(dataclasses.replace(
        po, prior_precision=torch.ones(4)))
    assert not LO.supports_lanes(dataclasses.replace(
        po, prior_full_precision=torch.eye(4)))
    assert LO.supports_lanes(dataclasses.replace(
        po, prior_mean=torch.zeros(4, 3), prior_precision=torch.ones(4, 3)))

    rb, pb, d, ops = _problem("dense", 3)
    rng = np.random.default_rng(17)
    f = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    s = (0.1 * rng.normal(size=d)).astype(np.float32)
    normed = Objective(L.TaskType.LOGISTIC_REGRESSION,
                       norm_factors=torch.from_numpy(f),
                       norm_shifts=torch.from_numpy(s))
    rnormed = RObjective(RL.TaskType.LOGISTIC_REGRESSION,
                         norm_factors=jnp.asarray(f),
                         norm_shifts=jnp.asarray(s))
    W = ops["W"]
    _close(LO.margin_lanes(normed, torch.from_numpy(W), pb),
           np.asarray(RLO.margin_lanes(rnormed, jnp.asarray(W), rb)))
    l2s = np.asarray([0.1, 1.0, 3.0], np.float32)
    z = LO.margin_lanes(normed, torch.from_numpy(W), pb)
    got = LO.value_and_grad_at_margin_lanes(normed, torch.from_numpy(l2s),
                                            torch.from_numpy(W), z, pb)
    want = RLO.value_and_grad_at_margin_lanes(
        rnormed, jnp.asarray(l2s), jnp.asarray(W), jnp.asarray(z.numpy()),
        rb)
    for g_, w_ in zip(got, want):
        _close(g_, np.asarray(w_))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_contractions_sum_in_chunks(dtype, monkeypatch):
    """An Xᵀr over many rows sums chunk by chunk (here chunks of 64 over
    1,000 rows: 15 chunks and a remainder of 40): the f64 result to f32
    rounding, for a vector and for lanes, and the chunked form agrees with
    one product of the whole contraction."""
    rng = np.random.default_rng(11)
    X = torch.from_numpy(rng.normal(size=(1000, 37)).astype(np.float32)).to(
        dtype)
    R = torch.from_numpy(rng.normal(size=(1000, 5)).astype(np.float32)).to(
        dtype)
    exact = (X.double().t() @ R.double()).numpy()
    whole = M._mm_f32(X.t(), R)
    monkeypatch.setattr(M, "_MM_CHUNK", 64)
    for got, want in ((M._mm_f32(X.t(), R), exact),
                      (M._mm_f32(X.t(), R[:, 2].contiguous()), exact[:, 2]),
                      (M._mm_f32(X.t(), R), whole.numpy())):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
