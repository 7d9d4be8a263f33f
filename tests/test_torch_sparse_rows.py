"""The port's `SparseRows` Xᵀr (`data.matrix._sparse_rmatvec`) against the
JAX package's `rmatvec`, `rmatvec_lanes` and `sq_rmatvec` on the same
padded COO rows, and its plan.

The port sums each column's live slots in sorted order through a
`SegmentPlan` (chunked cumulative-sum differences), so no atomic add
decides an output: within rtol 1e-5, atol 1e-6 of the reference (whose
segment sum adds in another order), within 1e-6 of the largest output of
an f64 numpy Xᵀr, and the same bits on every call. Padding slots (index
0, value 0.0) never touch column 0, not even when their row's cotangent
is not finite. One plan per matrix object, counted.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import inspect  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import matrix as RM  # noqa: E402

from photon_tpu_torch.data import matrix as PM  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def rows(n: int, d: int, k: int, seed: int = 0, pad: float = 0.25):
    """Zipf(1.4) columns, N(0, 1) values, an intercept in column d - 1 and
    about ``pad`` of the slots padding (index 0, value 0.0)."""
    rng = np.random.default_rng(seed)
    ind = ((rng.zipf(1.4, (n, k)) - 1) % (d - 1)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    hole = rng.uniform(size=(n, k)) < pad
    ind[hole], val[hole] = 0, 0.0
    ind = np.concatenate([ind, np.full((n, 1), d - 1, np.int32)], 1)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    return ind, val


def both(ind, val, d):
    return (SparseRows(torch.from_numpy(ind), torch.from_numpy(val), d),
            RM.SparseRows(jnp.asarray(ind), jnp.asarray(val), d))


def f64_rmatvec(ind, val, r, d, square=False):
    v = val.astype(np.float64)
    v = v * v if square else v
    lanes = r.shape[1:]
    out = np.zeros((d,) + lanes)
    contrib = (v[..., None] * r[:, None].astype(np.float64) if lanes
               else v * r[:, None].astype(np.float64))
    np.add.at(out, ind.reshape(-1), contrib.reshape((-1,) + lanes))
    return out


@pytest.mark.parametrize("n,d,k", [(1, 5, 1), (37, 11, 3), (513, 400, 9),
                                   (2048, 5000, 17)])
@pytest.mark.parametrize("square", [False, True])
def test_rmatvec_matches_reference(n, d, k, square):
    ind, val = rows(n, d, k, seed=n)
    r = np.random.default_rng(1).normal(size=n).astype(np.float32)
    X, RX = both(ind, val, d)
    fn, rfn = ((PM.sq_rmatvec, RM.sq_rmatvec) if square
               else (PM.rmatvec, RM.rmatvec))
    got = fn(X, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(rfn(RX, jnp.asarray(r))),
                               **TOL)
    want = f64_rmatvec(ind, val, r, d, square)
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    assert np.array_equal(fn(X, torch.from_numpy(r)).numpy(), got)


@pytest.mark.parametrize("G", [1, 3, 8])
def test_lane_forms_match_reference(G):
    n, d, k = 300, 700, 6
    ind, val = rows(n, d, k, seed=G)
    R = np.random.default_rng(G).normal(size=(n, G)).astype(np.float32)
    X, RX = both(ind, val, d)
    got = PM.rmatvec_lanes(X, torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(RM.rmatvec_lanes(RX, jnp.asarray(R))), **TOL)
    sq = PM.sq_rmatvec_lanes(X, torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(
        sq, f64_rmatvec(ind, val, R, d, square=True), **TOL)
    # each lane equals the one-lane pass on its own column
    for g in range(G):
        one = PM.rmatvec(X, torch.from_numpy(np.ascontiguousarray(R[:, g])))
        np.testing.assert_allclose(got[:, g], one.numpy(), **TOL)


def test_padding_slots_leave_column_zero_alone():
    """A row of padding alone, whose cotangent is inf, adds nothing to
    column 0 (an index add of its 0·inf slots would make it NaN), and
    column 0's real entries sum as without the padding."""
    d = 6
    ind = np.array([[0, 2, 0], [0, 0, 0], [3, 0, 0]], np.int32)
    val = np.array([[1.5, 2.0, 0.0], [0.0, 0.0, 0.0], [4.0, 0.0, 0.0]],
                   np.float32)
    r = np.array([2.0, np.inf, -1.0], np.float32)
    X, _ = both(ind, val, d)
    got = PM.rmatvec(X, torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, [3.0, 0.0, 4.0, -4.0, 0.0, 0.0])
    assert PM.segment_plan(X).src.tolist() == [0, 1, 6]


def test_no_atomic_add_decides_an_output():
    for fn in (PM._sparse_rmatvec, PM.segment_plan, PM.segment_sums,
               PM._plan_levels):
        src = inspect.getsource(fn)
        for word in ("index_add", "scatter_add", "accumulate=True",
                     "index_put_"):
            assert word not in src, (fn.__name__, word)


def test_one_plan_per_matrix():
    ind, val = rows(200, 300, 5)
    X, _ = both(ind, val, 300)
    before = PM.segment_plan_builds()
    r = torch.ones(200)
    for fn in (PM.rmatvec, PM.sq_rmatvec):
        fn(X, r)
        fn(X, torch.ones((200, 3)))
    assert PM.segment_plan_builds() == before + 1
    Y = SparseRows(X.indices, X.values * 2.0, 300)
    PM.rmatvec(Y, r)
    assert PM.segment_plan_builds() == before + 2
    assert X.plan is not None and Y.plan is not X.plan


@pytest.mark.parametrize("chunk", [2, 3, 256])
def test_levels_sum_long_runs(monkeypatch, chunk):
    """Runs that span many chunks (a column in every row) sum over
    several levels to the f64 sum, at any chunk size."""
    monkeypatch.setattr(PM, "_SEG_CHUNK", chunk)
    n, d = 1000, 4
    rng = np.random.default_rng(chunk)
    ind = rng.integers(0, d, (n, 2)).astype(np.int32)
    val = rng.normal(size=(n, 2)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    X, _ = both(ind, val, d)
    got = PM.rmatvec(X, torch.from_numpy(r)).numpy()
    want = f64_rmatvec(ind, val, r, d)
    assert len(X.plan.levels) >= (3 if chunk < 4 else 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_all_padding_and_empty():
    X = SparseRows(torch.zeros((4, 3), dtype=torch.int32),
                   torch.zeros((4, 3)), 7)
    assert PM.rmatvec(X, torch.ones(4)).tolist() == [0.0] * 7
    E = SparseRows(torch.zeros((0, 2), dtype=torch.int32),
                   torch.zeros((0, 2)), 3)
    assert PM.rmatvec_lanes(E, torch.ones((0, 2))).shape == (3, 2)
