"""The port's hybrid layouts (`HybridRows`, `PermutedHybridRows`) against
the JAX package, on one device (the CPU; the kernels' plain versions).

On the same numpy-seeded padded COO rows:

- the builders (`to_hybrid`, `to_permuted_hybrid`, each with the hot
  block built on the host and through the device scatter, f32 and bf16;
  `blocked_ell_from_scipy_csr`; `nnz_stats`) lay out every array as the
  reference does, bit for bit;
- every X pass on both layouts (`matvec`, `rmatvec`, `sq_rmatvec`, the
  lane forms at G = 3, `weighted_gram`) within rtol 1e-5 of the
  reference's own result on the same storage (f32, and bf16 against the
  reference's bf16 result: the two layouts' bf16 recipes differ, so
  nothing is compared across them there);
- the occurrence-bucket rmatvec's plain version with the cotangent
  unrounded (``round_r=False``, the recipe the permuted hybrid hands the
  kernel) against the reference's `_permuted_rmatvec`, and the kernel
  seam handing that flag, and an occurrence-only plan, to the launch;
- `train_glm` and `train_glm_grid` on both layouts against the
  reference's (iterations equal, loss histories within rtol 1e-5,
  coefficients in original column order), with w0, normalization and an
  unregularized intercept;
- GAME: a fixed effect on either layout (the sequential path) and a
  `HybridRows` fixed effect in the lane-axis grid;
- every refusal, matched by the reference's message.

Mirrors `tests/test_hybrid.py`'s `TestHybridParity` and
`TestDeviceDenseBuild`, the single-device tests of `tests/test_permuted.py`,
`tests/test_lane_solver.py:74` and `tests/test_statistics.py:78,161`.
"""
import dataclasses
import inspect
import re

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
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.data import normalization as RN  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data import normalization as N  # noqa: E402
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402

CPU = "cpu"
LOGISTIC = L.TaskType.LOGISTIC_REGRESSION
RLOGISTIC = RL.TaskType.LOGISTIC_REGRESSION
BUILDERS = ("to_hybrid", "to_permuted_hybrid")
# An X pass: sums of at most a few hundred products added in another order
# (XLA's segment sum or einsum against PyTorch's prefix sums, sorted
# segments and the kernel's plain version): within 1e-5 of the largest
# output.
PASS_RTOL = 1e-5
# Loss histories: the same steps on both sides, each loss a sum over the
# rows in another order (as tests/test_torch_training.py).
HIST_RTOL = 1e-5
W_ATOL = 1e-3


def rows(seed=0, n=400, d=600, k=10, zipf=1.5, intercept=True, dup=True):
    """Padded COO rows: zipf columns (hot block, several occurrence
    buckets and a deep tail all filled), normal values, an intercept in
    column d - 1; a duplicate (row, column) slot gets value 0, the padding
    convention (tests/test_permuted.py's `_power_law_sparse`)."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(zipf, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    if dup:
        order = np.argsort(col, axis=1, kind="stable")
        s = np.take_along_axis(col, order, axis=1)
        mask = np.zeros_like(col, bool)
        np.put_along_axis(mask, order[:, 1:], s[:, 1:] == s[:, :-1], axis=1)
        val[mask] = 0.0
    if intercept:
        col = np.concatenate([col, np.full((n, 1), d - 1)], 1)
        val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    return col.astype(np.int32), val, d


def planted(ind, val, d, seed=1):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=d) / np.sqrt(np.arange(1, d + 1))).astype(
        np.float32)
    z = np.einsum("nk,nk->n", val, w[ind])
    return (rng.uniform(size=ind.shape[0]) < 1 / (1 + np.exp(-z))).astype(
        np.float32)


def pair(build, seed=0, d_dense=32, bf16=False, **kw):
    """(reference layout, port layout on the CPU) of the same rows."""
    ind, val, d = rows(seed, **kw)
    ref = getattr(RM, build)(RM.SparseRows(ind, val, d), d_dense)
    port = getattr(M, build)(M.SparseRows(ind, val, d), d_dense,
                             device=CPU)
    if bf16:
        n = ind.shape[0]
        ref = RD.cast_features(RD.make_batch(ref, np.zeros(n))).X
        port = D.cast_features(D.make_batch(port, np.zeros(n),
                                            device=CPU)).X
    return ref, port


def host(a) -> np.ndarray:
    """Bits of a tensor or array as numpy (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_layout(ref, port):
    for f in dataclasses.fields(ref):
        r, p = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(r, tuple):
            assert len(r) == len(p), f.name
            for i, (a, b) in enumerate(zip(r, p)):
                np.testing.assert_array_equal(host(b), host(a),
                                              err_msg=f"{f.name}[{i}]")
                assert host(b).dtype == host(a).dtype, f.name
        elif isinstance(r, int):
            assert p == r, f.name
        else:
            np.testing.assert_array_equal(host(p), host(r), err_msg=f.name)
            assert host(p).dtype == host(r).dtype, f.name


def close(got, want, rtol=PASS_RTOL, msg=""):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=msg)


def vec(rng, m, lanes=0):
    shape = (m, lanes) if lanes else (m,)
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- builders
@pytest.mark.parametrize("build", BUILDERS)
@pytest.mark.parametrize("kw", [dict(), dict(d_dense=16, zipf=1.2),
                                dict(n=64, d=40, k=4, intercept=False),
                                dict(zipf=1.1, dup=False)])
def test_builders_lay_out_the_reference_arrays(build, kw):
    kw = dict(kw)
    d_dense = kw.pop("d_dense", 32)
    ref, port = pair(build, seed=3, d_dense=d_dense, **kw)
    assert_same_layout(ref, port)
    assert port.shape == tuple(ref.shape)
    assert M.nnz_stats(port) == RM.nnz_stats(ref)


@pytest.mark.parametrize("build", BUILDERS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_device_dense_build_matches(build, dtype):
    """``device_dense_dtype`` scatters the hot block from its compact COO
    (duplicate cells summed): the reference's arrays, the hot block bit
    for bit in its storage dtype (`TestDeviceDenseBuild`)."""
    rng = np.random.default_rng(3)
    n, k, d = 400, 6, 5000
    ind = rng.integers(0, d, (n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < 0.2] = 0.0
    ind[:, 1] = ind[:, 0]
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = getattr(RM, build)(RM.SparseRows(ind, val, d), 64,
                             device_dense_dtype=jdt)
    port = getattr(M, build)(M.SparseRows(ind, val, d), 64,
                             device_dense_dtype=tdt, device=CPU)
    assert port.dense.dtype == tdt
    assert_same_layout(ref, port)
    # against the host build: the same block up to the storage cast
    hostb = getattr(M, build)(M.SparseRows(ind, val, d), 64, device=CPU)
    np.testing.assert_array_equal(host(port.dense.float()),
                                  host(hostb.dense.to(tdt).float()))


def test_device_dense_build_chunked_scatter_matches(monkeypatch):
    rng = np.random.default_rng(5)
    n, k, d = 700, 6, 4000
    ind = rng.integers(0, d, (n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    X = M.SparseRows(ind, val, d)
    one = M.to_hybrid(X, 48, device_dense_dtype=torch.float32, device=CPU)
    monkeypatch.setattr(M, "_SCATTER_CHUNK_ELEMS", 48 * 128)
    chunked = M.to_hybrid(X, 48, device_dense_dtype=torch.float32,
                          device=CPU)
    np.testing.assert_array_equal(one.dense.numpy(), chunked.dense.numpy())


def test_blocked_ell_from_scipy_csr_matches_reference():
    ind, val, d = rows(4, n=200)
    n, k = ind.shape
    csr = sp.csr_matrix((val.ravel(), (np.repeat(np.arange(n), k),
                                       ind.ravel())), shape=(n, d))
    csr.sum_duplicates()
    csr.eliminate_zeros()
    ref = RM.blocked_ell_from_scipy_csr(csr, 32)
    port = M.blocked_ell_from_scipy_csr(csr, 32, device=CPU)
    assert_same_layout(ref, port)
    assert M.nnz_stats(port) == RM.nnz_stats(ref)


def test_hybrid_hot_columns_dense_and_tail_sorted():
    """`TestHybridParity.test_hot_columns_really_dense`."""
    _, H = pair("to_hybrid")
    tail = set(H.tail_cols[H.tail_vals != 0].tolist())
    assert tail.isdisjoint(set(H.dense_cols.tolist()))
    assert int((H.dense != 0).sum()) > int((H.tail_vals != 0).sum())
    assert bool((H.tail_rows[1:] >= H.tail_rows[:-1]).all())


def test_permuted_roundtrip_and_layout():
    _, P = pair("to_permuted_hybrid")
    d = P.n_features
    perm, inv = P.perm_cols.numpy(), P.inv_perm.numpy()
    assert sorted(perm.tolist()) == list(range(d))
    np.testing.assert_array_equal(perm[inv], np.arange(d))
    v = torch.from_numpy(np.random.default_rng(0).normal(size=d).astype(
        np.float32))
    assert torch.equal(P.to_model_space(P.from_model_space(v)), v)
    assert P.last_col_pos < P.d_sel
    assert float(P.dense[:, P.last_col_pos].min()) == 1.0


def test_layouts_move_and_keep_themselves():
    for build in BUILDERS:
        _, X = pair(build)
        assert X.to(CPU) is X
        bf = X.astype(torch.bfloat16)
        assert bf.dense.dtype == torch.bfloat16
        assert bf.tail_vals.dtype == torch.bfloat16
        if build == "to_permuted_hybrid":
            assert all(v.dtype == torch.bfloat16 for v in bf.bucket_vals)


# ------------------------------------------------------------- X passes
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("build", BUILDERS)
def test_x_passes_match_reference(build, bf16):
    ref, port = pair(build, seed=6, bf16=bf16)
    n, d = port.shape
    rng = np.random.default_rng(7)
    for lanes in (0, 3):
        w, r = vec(rng, d, lanes), vec(rng, n, lanes)
        mv = RM.matvec_lanes if lanes else RM.matvec
        close(M.matvec(port, torch.from_numpy(w)), mv(ref, jnp.asarray(w)),
              msg=f"matvec {lanes}")
        rmv = RM.rmatvec_lanes if lanes else RM.rmatvec
        close(M.rmatvec(port, torch.from_numpy(r)), rmv(ref, jnp.asarray(r)),
              msg=f"rmatvec {lanes}")
        close(M.matvec_lanes(port, torch.from_numpy(w)),
              mv(ref, jnp.asarray(w)))
        close(M.rmatvec_lanes(port, torch.from_numpy(r)),
              rmv(ref, jnp.asarray(r)))
    r = vec(rng, n)
    close(M.sq_rmatvec(port, torch.from_numpy(r)),
          RM.sq_rmatvec(ref, jnp.asarray(r)), msg="sq_rmatvec")
    R = vec(rng, n, 3)
    sq = M.sq_rmatvec_lanes(port, torch.from_numpy(R)).numpy()
    for g in range(3):
        close(sq[:, g], RM.sq_rmatvec(ref, jnp.asarray(R[:, g])))


@pytest.mark.parametrize("build", BUILDERS)
def test_x_passes_match_the_sparse_rows(build):
    """The representation-invariance checks of the reference's tests: at
    f32 storage a layout's passes (in original order) equal the
    `SparseRows` passes of the same rows."""
    ind, val, d = rows(8)
    X = M.SparseRows(torch.from_numpy(ind), torch.from_numpy(val), d)
    H = getattr(M, build)(X, 32, device=CPU)
    rng = np.random.default_rng(9)
    w = torch.from_numpy(vec(rng, d))
    r = torch.from_numpy(vec(rng, ind.shape[0]))
    perm = build == "to_permuted_hybrid"
    wl = H.from_model_space(w) if perm else w
    back = H.to_model_space if perm else (lambda v: v)
    close(M.matvec(H, wl), M.matvec(X, w))
    close(back(M.rmatvec(H, r)), M.rmatvec(X, r))
    close(back(M.sq_rmatvec(H, r)), M.sq_rmatvec(X, r))


@pytest.mark.parametrize("build", BUILDERS)
def test_weighted_gram_matches_reference(build):
    ref, port = pair(build, seed=10, n=200, d=60, k=6, d_dense=8)
    r = np.random.default_rng(11).uniform(0.1, 1.0, size=200).astype(
        np.float32)
    close(M.weighted_gram(port, torch.from_numpy(r)),
          RM.weighted_gram(ref, jnp.asarray(r)))


def test_weighted_gram_refuses_wide():
    _, H = pair("to_hybrid")
    wide = dataclasses.replace(H, n_features=M.MAX_GRAM_FEATURES + 1)
    with pytest.raises(ValueError, match="weighted_gram densifies "
                       "HybridRows"):
        M.weighted_gram(wide, torch.ones(H.shape[0]))


@pytest.mark.parametrize("build", BUILDERS)
def test_empty_tail(build):
    """Every column hot: no tail (the hybrid's one zero sentinel, the
    permuted layout's empty buckets); the passes stay exact."""
    rng = np.random.default_rng(12)
    ind = rng.integers(0, 16, size=(50, 4)).astype(np.int32)
    val = rng.normal(size=(50, 4)).astype(np.float32)
    ref = getattr(RM, build)(RM.SparseRows(ind, val, 16), 16)
    port = getattr(M, build)(M.SparseRows(ind, val, 16), 16, device=CPU)
    assert_same_layout(ref, port)
    w, r = vec(rng, 16), vec(rng, 50)
    close(M.matvec(port, torch.from_numpy(w)), RM.matvec(ref, jnp.asarray(w)))
    close(M.rmatvec(port, torch.from_numpy(r)),
          RM.rmatvec(ref, jnp.asarray(r)))


# ---------------------------------------------- the rmatvec kernel's seam
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lanes", [0, 4])
def test_unrounded_plain_rmatvec_matches_permuted_rmatvec(bf16, lanes):
    """`bucket_rmatvec_reference(round_r=False)` is the bucket block of
    the reference's `_permuted_rmatvec` (values upcast, the cotangent
    unrounded), in [d_sel:n_prefix]; with bf16 storage the rounded form
    differs from it."""
    ref, port = pair("to_permuted_hybrid", seed=13, bf16=bf16)
    r = vec(np.random.default_rng(14), port.shape[0], lanes)
    want = (RM._permuted_rmatvec_lanes(ref, jnp.asarray(r)) if lanes
            else RM._permuted_rmatvec(ref, jnp.asarray(r)))
    block = np.asarray(want)[port.d_sel:port.n_prefix]
    for form in (KB.bucket_rmatvec, KB.bucket_rmatvec_tiled):
        got = form(port, torch.from_numpy(r), round_r=False)
        close(got, block, rtol=1e-6)
    plain = KB.bucket_rmatvec_reference(port, torch.from_numpy(r),
                                        round_r=False)
    close(plain, block, rtol=1e-6)
    rounded = KB.bucket_rmatvec_reference(port, torch.from_numpy(r))
    assert torch.equal(rounded, plain) == (not bf16)
    sq = KB.bucket_rmatvec_reference(port, torch.from_numpy(r), square=True,
                                     round_r=False)
    assert torch.equal(sq, KB.bucket_rmatvec_reference(
        port, torch.from_numpy(r), square=True))


def test_permuted_rmatvec_hands_the_kernel_an_unrounded_cotangent(
        monkeypatch):
    """On the kernel route (launches emulated here by the plain version
    through the layout's plan) the permuted hybrid's Xᵀr launches the
    rmatvec with ``round_r`` off on an occurrence-only plan, the
    blocked-ELL Xᵀr with it on; both give the plain passes' bits."""
    seen = []

    def emulate(name, plan, ranges, r, lanes, square, out, round_r=True):
        X = next(ref() for ref, pl in KB._PLANS.values() if pl is plan)
        seen.append((type(X).__name__, bool(round_r), bool(square)))
        out.copy_(KB.bucket_rmatvec_reference(X, r, square, round_r))
        K.count_launch(name, ranges[2])

    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate)
    _, P = pair("to_permuted_hybrid", seed=15, bf16=True)
    ind, val, d = rows(15)
    B = D.cast_features(D.make_batch(M.to_blocked_ell(
        M.SparseRows(ind, val, d), 32, device=CPU), np.zeros(len(ind)),
        device=CPU)).X
    r = torch.from_numpy(vec(np.random.default_rng(16), P.shape[0]))
    before = KB.plan_builds()
    K.reset_launch_counts()
    for X in (P, B):
        for square in (False, True):
            got = (M.sq_rmatvec if square else M.rmatvec)(X, r)
            with K.scope("off"):
                want = (M.sq_rmatvec if square else M.rmatvec)(X, r)
            assert torch.equal(got, want)
    assert seen == [("PermutedHybridRows", False, False),
                    ("PermutedHybridRows", False, True),
                    ("BlockedEllRows", True, False),
                    ("BlockedEllRows", True, True)]
    assert KB.plan_builds() - before == 2
    assert K.launch_counts()[KB.RMATVEC] == 4
    plan = KB.layout_plan(P)
    assert plan.tail_rows.numel() == 0 and plan.tail_desc.numel() == 0
    np.testing.assert_array_equal(
        plan.occ_items.numpy(),
        KB.rmatvec_plan([tuple(v.shape) for v in P.bucket_vals]))


def test_rmatvec_entry_point_takes_the_rounding_flag():
    """The C entry point's parameters and the ctypes binding agree, and
    the kernel template carries the rounding flag."""
    src = KB.SOURCE.read_text()
    m = re.search(r"photon_bell_bucket_rmatvec\(([^)]*)\)", src)
    params = [p.strip().split()[-1].lstrip("*") for p in
              m.group(1).split(",")]
    assert params == ["buckets", "items", "bf16", "ranges", "n_ranges", "r",
                      "lanes", "square", "round_r", "out", "stream"]
    assert "template <bool kBf16, bool kSquare, bool kRound, int kChunk>" \
        in src
    assert "launch_rmatvec<true, false, false>" in src
    sig = inspect.signature(KB._launch_rmatvec)
    assert list(sig.parameters)[-1] == "round_r"


def test_hybrid_passes_add_no_atomic_sum():
    """Every Xᵀr of the hybrids sums in a fixed order: no atomic or
    combining add decides an output."""
    for fn in (M._hybrid_rmatvec, M._hybrid_matvec, M._perm_matvec,
               M._bell_rmatvec, M._gather_product, M.segment_plan):
        src = inspect.getsource(fn)
        for word in ("index_add", "scatter_add", "accumulate=True",
                     "torch.cumsum"):
            assert word not in src, (fn.__name__, word)


def test_blocked_lane_prefix_sum_matches_the_scan():
    """The lane tails' fixed-order prefix sum (taken on the card for (n, G)
    columns): every column the prefix sum of that column, in blocks of
    1,024 rows (one level, two and a ragged last block)."""
    rng = np.random.default_rng(38)
    for n in (700, 1024, 5000, 1024 * 1024 + 3):
        x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        got = M._blocked_prefix_sum(x).double().numpy()
        want = np.cumsum(x.double().numpy(), axis=0)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_flat_tail_row_sums_round_as_the_reference():
    """The permuted hybrid's flat-tail row sums are differences of one
    prefix sum over the whole tail, in both packages, so a row's sum
    carries the rounding of the prefix's magnitude, not of its own terms
    (the reference's docstring admits ~1e-4·σ·√nnz). On T2's recipe
    (`chip_smoke.sparse_planted`: 10M features, 32 zipf(1.4) nonzeros and
    an intercept, a 1,024-column hot block, f32, the planted w) cut to
    2^14 rows, 4,096 sampled rows: both stay within that bound of f64,
    and a plain f32 sum of each row's own products is tighter than
    either. Prints the figures (run with ``-s``)."""
    import json

    import chip_smoke as CS

    ind, va, _, w = CS.sparse_planted(0, 1 << 14)
    d = CS.T_FEATURES
    sample = np.sort(np.random.default_rng(1).choice(
        ind.shape[0], 4096, replace=False))
    ref = RM.to_permuted_hybrid(RM.SparseRows(ind, va, d), CS.T_DENSE)
    wp = ref.from_model_space(jnp.asarray(w))
    contrib = ref.tail_vals.astype(jnp.float32) * wp[ref.tail_pcols]
    bounds = np.asarray(ref.row_bounds)
    figures = {"reference": CS.row_sum_errors(
        np.asarray(RM._tail_rowsum(contrib, ref.row_bounds)),
        np.asarray(contrib), bounds, sample)}
    port = M.to_permuted_hybrid(M.SparseRows(ind, va, d), CS.T_DENSE,
                                device=CPU)
    figures["port"] = CS.tail_errors(
        port, port.from_model_space(torch.from_numpy(w)), sample)
    keys = ("max_abs_err", "of_row_scale", "zero_rows_not_zero",
            "largest_abs_prefix", "own_row_sum_max_abs_err")
    print(json.dumps({"rows": ind.shape[0], "tail_entries": int(bounds[-1]),
                      **{k: dict(zip(keys, v)) for k, v in figures.items()}}))
    for name, (err, _, _, prefix, own) in figures.items():
        assert err <= 1e-4 * prefix, name
        assert own < err / 10, name

def test_hybrid_builds_one_segment_plan():
    _, H = pair("to_hybrid")
    before = M.segment_plan_builds()
    r = torch.ones(H.shape[0])
    for fn in (M.rmatvec, M.sq_rmatvec):
        fn(H, r)
        fn(H, torch.ones((H.shape[0], 3)))
    assert M.segment_plan_builds() == before + 1
    assert H.plan is not None and H.to(CPU).plan is H.plan


# ----------------------------------------------------------- batches
@pytest.mark.parametrize("build", BUILDERS)
def test_pad_and_cast_match_reference(build):
    ref, port = pair(build, seed=17, n=100, d=300, k=6)
    y = np.random.default_rng(18).normal(size=100).astype(np.float32)
    rb = RD.pad_batch(RD.make_batch(ref, y), 128)
    pb = D.pad_batch(D.make_batch(port, y, device=CPU), 128)
    assert pb.n == 128 and pb.X.dense.shape[0] == 128
    assert_same_layout(rb.X, pb.X)
    w = vec(np.random.default_rng(19), 300)
    close(M.matvec(pb.X, torch.from_numpy(w)),
          RM.matvec(rb.X, jnp.asarray(w)))
    z = M.matvec(pb.X, torch.from_numpy(w))
    assert float(z[100:].abs().max()) == 0.0
    rc, pc = RD.cast_features(rb), D.cast_features(pb)
    assert_same_layout(rc.X, pc.X)


# ------------------------------------------------------------ training
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


def batches(build, seed=20, bf16=False, d_dense=32, n=600, d=800, **kw):
    ind, val, d = rows(seed, n=n, d=d, **kw)
    y = planted(ind, val, d, seed + 1)
    ref, port = pair(build, seed=seed, d_dense=d_dense, bf16=bf16, n=n,
                     d=d, **kw)
    return (RD.make_batch(ref, y), D.make_batch(port, y, device=CPU),
            (ind, val, d, y))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("build", BUILDERS)
def test_train_glm_matches_reference(build, bf16):
    rb, pb, _ = batches(build, bf16=bf16)
    rcfg, pcfg = _configs()
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    assert pres.iterations == 10
    _assert_same_solve(rm, rres, pm, pres)
    # scoring translates into the layout's space: the model's margins on
    # the layout are the reference's
    close(pm.score(pb.X), rm.score(rb.X))


@pytest.mark.parametrize("build", BUILDERS)
def test_train_glm_unregularized_intercept_and_stopping(build):
    rb, pb, _ = batches(build, seed=22)
    rcfg = RConfig(max_iters=60, tolerance=1e-4, reg=RReg.l2(),
                   reg_weight=1.0, history=5, regularize_intercept=False)
    pcfg = OptimizerConfig(max_iters=60, tolerance=1e-4, reg=Reg.l2(),
                           reg_weight=1.0, history=5,
                           regularize_intercept=False)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, device=CPU)
    assert bool(rres.converged) and pres.iterations < 60
    _assert_same_solve(rm, rres, pm, pres, w_atol=5e-3)


@pytest.mark.parametrize("build", BUILDERS)
def test_train_glm_w0_and_normalization(build):
    """An original-space w0 and a standardization context built on the
    original rows: both translate into the layout's space and back."""
    rb, pb, (ind, val, d, _) = batches(build, seed=24, n=400, d=200, k=8,
                                       d_dense=16)
    w0 = np.random.default_rng(25).normal(size=d).astype(np.float32) * 0.1
    rnorm = RN.NormalizationContext.build(
        RM.SparseRows(ind, val, d), RN.NormalizationType.STANDARDIZATION,
        intercept_index=d - 1)
    pnorm = N.NormalizationContext.build(
        M.SparseRows(ind, val, d), N.NormalizationType.STANDARDIZATION,
        intercept_index=d - 1)
    rcfg, pcfg = _configs(lam=5.0)
    rm, rres = RT.train_glm(rb, RLOGISTIC, rcfg, w0=jnp.asarray(w0),
                            normalization=rnorm)
    pm, pres = T.train_glm(pb, LOGISTIC, pcfg, w0=w0, normalization=pnorm,
                           device=CPU)
    _assert_same_solve(rm, rres, pm, pres)


def _assert_same_grid(rgrid, pgrid):
    for (rm, rr), (pm, pr) in zip(rgrid, pgrid):
        assert pr.iterations == int(rr.iterations)
        h = np.asarray(rr.loss_history)
        np.testing.assert_allclose(pr.history(), h[~np.isnan(h)],
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(pm.coefficients.means.numpy(),
                                   np.asarray(rm.coefficients.means),
                                   atol=W_ATOL)


@pytest.mark.parametrize("build", BUILDERS)
def test_train_glm_grid_matches_reference(build):
    """The lane grid on a layout against the reference's; its pick and
    scores through `evaluate_glm_grid`."""
    rb, pb, _ = batches(build, seed=26)
    rcfg, pcfg = _configs(lam=0.0)
    weights = [1e-1, 1.0, 30.0]
    rgrid = RT.train_glm_grid(rb, RLOGISTIC, rcfg, weights)
    pgrid = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    _assert_same_grid(rgrid, pgrid)
    rbest, rscores = RT.evaluate_glm_grid(rgrid, rb)
    pbest, pscores = T.evaluate_glm_grid(pgrid, pb)
    assert pbest == rbest
    np.testing.assert_allclose(pscores, rscores, rtol=1e-5)


def test_grid_device_results_in_original_order():
    rb, pb, _ = batches("to_permuted_hybrid", seed=28, n=200, d=100, k=6,
                        d_dense=8)
    rcfg, pcfg = _configs(iters=8, lam=0.0)
    rres, _ = RT.train_glm_grid(rb, RLOGISTIC, rcfg, [0.5, 2.0],
                                device_results=True)
    pres, _ = T.train_glm_grid(pb, LOGISTIC, pcfg, [0.5, 2.0],
                               device_results=True, device=CPU)
    np.testing.assert_allclose(pres.w.numpy(), np.asarray(rres.w),
                               atol=W_ATOL)


def test_lane_grid_matches_sequential_on_hybrid_rows():
    """`tests/test_lane_solver.py:74`: every lane of a grid on a
    `HybridRows` batch is the single-lane solve of its weight."""
    _, pb, _ = batches("to_hybrid", seed=30, n=600, d=500, d_dense=64)
    _, pcfg = _configs(lam=0.0)
    weights = [1e-2, 1.0, 30.0]
    grid = T.train_glm_grid(pb, LOGISTIC, pcfg, weights, device=CPU)
    for wt, (gm, gr) in zip(weights, grid):
        sm, sr = T.train_glm(pb, LOGISTIC, dataclasses.replace(
            pcfg, reg_weight=wt), device=CPU)
        assert gr.iterations == sr.iterations
        np.testing.assert_allclose(gr.history(), sr.history(),
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(gm.coefficients.means.numpy(),
                                   sm.coefficients.means.numpy(),
                                   atol=W_ATOL)


@pytest.mark.parametrize("build", BUILDERS)
def test_intercept_detection_matches_reference(build):
    """Incl. `test_perm_intercept_in_tail_detected`: an every-row column
    left in the tail by the hot selection's ties, and one missing a row."""
    n, d = 16, 6
    ind = np.tile(np.array([[0, 0, 1, 1, 2, 5]], np.int32), (n, 1))
    val = np.ones((n, 6), np.float32)
    for v in (val, np.where(np.arange(n)[:, None] == 3,
                            np.array([1, 1, 1, 1, 1, 0], np.float32), val)):
        ref = getattr(RM, build)(RM.SparseRows(ind, v, d), 2)
        port = getattr(M, build)(M.SparseRows(ind, v, d), 2, device=CPU)
        assert M.last_column_is_intercept(port) == \
            RM.last_column_is_intercept(ref)
    _, port = pair(build)
    assert M.last_column_is_intercept(port)


# ---------------------------------------------------------------- GAME
@pytest.mark.parametrize("build", BUILDERS)
def test_game_fixed_effect_matches_reference(build):
    """`test_perm_game_fixed_effect_falls_back_correctly`: a GAME fit whose
    fixed shard is a hybrid runs train_glm (which owns the space
    translation) and matches the reference's fit of the same layout."""
    from photon_tpu.game.dataset import GameData as RGameData
    from photon_tpu.game.estimator import (FixedEffectConfig as RFixed,
                                           GameEstimator as RGame)

    ind, val, d = rows(32, n=300, d=150, k=6)
    y = planted(ind, val, d, 33)
    ref = getattr(RM, build)(RM.SparseRows(ind, val, d), 16)
    port = getattr(M, build)(M.SparseRows(ind, val, d), 16, device=CPU)
    rcfg, pcfg = _configs(iters=12)
    rest = RGame(task=RLOGISTIC, warm_start=False, coordinate_configs={
        "fixed": RFixed("f", rcfg)})
    rfit = rest.fit(RGameData.build(y, {"f": ref}, {}))[0]
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator)

    pdata = GameData.build(y, {"f": port}, {})
    pest = GameEstimator(task=LOGISTIC, device=CPU, warm_start=False,
                         coordinate_configs={"fixed": FixedEffectConfig(
                             "f", pcfg)})
    assert pest._grid_data_supported(pdata) == (build == "to_hybrid")
    pfit = pest.fit(pdata)[0]
    np.testing.assert_allclose(pfit.descent.objective_history,
                               rfit.descent.objective_history,
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(
        pfit.model["fixed"].model.coefficients.means.numpy(),
        np.asarray(rfit.model["fixed"].model.coefficients.means),
        atol=W_ATOL)


def test_grid_gate_takes_a_hybrid_fixed_effect_only():
    """`_grid_data_supported`: a `HybridRows` fixed effect without a mesh
    runs in the lane-axis grid; a permuted one, a hybrid random effect and
    a hybrid on a mesh fall back to the sequential path."""
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator,
                                                 RandomEffectConfig)

    _, H = pair("to_hybrid", n=64, d=40, k=4)
    _, P = pair("to_permuted_hybrid", n=64, d=40, k=4)
    y = np.zeros(64, np.float32)
    _, cfg = _configs()

    def gate(shard, re=False, mesh=None):
        coords = {"fixed": FixedEffectConfig("f", cfg)}
        if re:
            coords = {"re": RandomEffectConfig("user", "f", cfg)}
        est = GameEstimator(task=LOGISTIC, coordinate_configs=coords,
                            device=CPU, mesh=mesh)
        return est._grid_data_supported(GameData.build(
            y, {"f": shard}, {"user": np.zeros(64, np.int64)}))

    assert gate(H)
    assert not gate(P)
    assert not gate(H, re=True)
    assert not gate(H, mesh=PM.make_mesh(n_devices=2, device=CPU))


def test_game_grid_on_a_hybrid_fixed_effect_matches_reference():
    """The lane-axis GAME grid (`fit_game_grid`) with a `HybridRows` fixed
    shard beside two random effects, against the reference's grid."""
    import test_torch_game as TG

    raw = TG.raw_game(seed=34, n=400)
    rval_raw = TG.raw_game(seed=35, n=300)

    def hybrid_pair(raw):
        ref, port = TG.game_pair(raw)
        n, dd = raw["Xf"].shape
        ind = np.tile(np.arange(dd, dtype=np.int32), (n, 1))
        ref.shards["fixed"] = RM.to_hybrid(
            RM.SparseRows(ind, raw["Xf"], dd), 3)
        port.shards["fixed"] = M.to_hybrid(
            M.SparseRows(ind, raw["Xf"], dd), 3, device=CPU)
        return ref, port

    ref, port = hybrid_pair(raw)
    rval, pval = hybrid_pair(rval_raw)
    rest, pest = TG.estimator_pair(n_sweeps=2, warm_start=False)
    name, weights = "fixed", (0.5, 2.0, 8.0)

    def with_weight(est, w):
        cfg = est.coordinate_configs[name]
        return {name: dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, reg_weight=w))}

    rgrid = [with_weight(rest, w) for w in weights]
    pgrid = [with_weight(pest, w) for w in weights]
    assert pest.would_vectorize(pgrid, data=port)
    from photon_tpu_torch import telemetry

    telemetry.reset()
    rres = rest.fit(ref, validation=rval, config_grid=rgrid)
    pres = pest.fit(port, validation=pval, config_grid=pgrid)
    assert telemetry.snapshot()["counters"].get(
        "game.grid_vectorized_lanes", 0) == 3
    for rr, pr in zip(rres, pres):
        TG.assert_same_fit(rr, pr)
    np.testing.assert_allclose([r.validation_score for r in pres],
                               [r.validation_score for r in rres], atol=1e-5)


# ------------------------------------------------------------- refusals
def test_refusals_match_reference_messages():
    from photon_tpu_torch.data.statistics import FeatureSummary
    from photon_tpu_torch.data.validators import validate_glm_data
    from photon_tpu_torch.diagnostics.importance import variance_importance
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (GameEstimator,
                                                 RandomEffectConfig)
    from photon_tpu_torch.kernels.fused import can_fuse

    _, H = pair("to_hybrid", n=64, d=40, k=4)
    _, P = pair("to_permuted_hybrid", n=64, d=40, k=4)
    with pytest.raises(TypeError, match="before to_hybrid"):
        FeatureSummary.compute(H)
    with pytest.raises(TypeError, match="does not take HybridRows"):
        N.NormalizationContext.build(
            H, N.NormalizationType.SCALE_WITH_MAX_MAGNITUDE)
    with pytest.raises(TypeError, match="feature importance does not take "
                       "HybridRows"):
        variance_importance(torch.ones(40), H)
    assert not can_fuse(H) and not can_fuse(P)
    for X in (H, P):
        with pytest.raises(TypeError, match="cannot be host-chunked"):
            D.chunk_matrix(X, 16)
        y = np.zeros(64, np.float32)
        _, cfg = _configs()
        est = GameEstimator(task=LOGISTIC, device=CPU, coordinate_configs={
            "re": RandomEffectConfig("user", "f", cfg)})
        with pytest.raises(TypeError, match="not supported for GAME entity "
                           "bucketing"):
            est.fit(GameData.build(y, {"f": X},
                                   {"user": np.arange(64) % 4}))
    # the data validators read the hybrid's values: a NaN anywhere fails
    bad = dataclasses.replace(H, tail_vals=H.tail_vals.clone())
    bad.tail_vals[0] = float("nan")
    y = np.zeros(64, np.float32)
    validate_glm_data(y, H, task=LOGISTIC)
    with pytest.raises(ValueError):
        validate_glm_data(y, bad, task=LOGISTIC)


def test_single_device_layouts_refuse_a_mesh():
    """`test_perm_mesh_rejected` and `test_plain_hybrid_under_mesh_points
    _at_sharded`: a one-device hybrid under ``mesh=`` names the sharded
    form; a sharded one without a mesh solves in its global view
    (`test_single_device_global_view_owlqn`), as on the mesh."""
    mesh = PM.make_mesh(n_devices=8, device=CPU)
    cfg = OptimizerConfig(max_iters=2, reg=Reg.l2(), reg_weight=0.1)
    ind, val, d = rows(36, n=64, d=100, k=4)
    y = np.zeros(64, np.float32)
    for build, match in (("to_permuted_hybrid", "single-device"),
                         ("to_hybrid", "shard_hybrid_batch")):
        X = getattr(M, build)(M.SparseRows(ind, val, d), 16, device=CPU)
        for fn in (T.train_glm, lambda b, t, c, mesh: T.train_glm_grid(
                b, t, c, [1.0], mesh=mesh)):
            with pytest.raises(ValueError, match=match):
                fn(D.make_batch(X, y, device=CPU), LOGISTIC, cfg, mesh=mesh)
    sb = D.shard_hybrid_batch(D.make_batch(M.SparseRows(ind, val, d), y,
                                           device=CPU), 8, d_dense=16)
    m_g, r_g = T.train_glm(sb, LOGISTIC, cfg, device=CPU)
    m_m, r_m = T.train_glm(sb, LOGISTIC, cfg, mesh=mesh)
    np.testing.assert_allclose(float(r_g.value), float(r_m.value),
                               rtol=1e-5)
    np.testing.assert_allclose(m_g.coefficients.means.numpy(),
                               m_m.coefficients.means.numpy(), atol=1e-4)


def test_make_batch_keeps_a_sharded_hybrid():
    """`tests/test_statistics.py:161`: a sharded hybrid goes into a batch
    as the host container it is."""
    ind, val, d = rows(37, n=64, d=100, k=4)
    X = M.shard_hybrid(M.SparseRows(ind, val, d), 4, d_dense=8)
    b = D.make_batch(X, np.random.default_rng(0).uniform(size=64),
                     device=CPU)
    assert b.X is X and b.n == X.shape[0] == 64
    with pytest.raises(ValueError, match="cannot pad a sharded batch"):
        D.pad_batch(b, 72)
    with pytest.raises(TypeError, match="shard_permuted_batch expects "
                       "SparseRows"):
        D.shard_permuted_batch(b, 4)
