"""The port's blocked-ELL layout and X passes against the JAX package.

On the same numpy-seeded padded COO rows: `to_blocked_ell` must lay out
every array exactly as the reference does; the plain PyTorch versions of
the four CUDA kernels (`tail_matvec_reference`,
`bucket_rmatvec_reference`, which the CPU path runs) are held against the
reference's Pallas kernels in interpret mode, fused and tiled, f32 and
bf16 storage, vector and lanes, ``square`` on and off; and `matvec`,
`rmatvec`, `sq_rmatvec` on a `BlockedEllRows` against the reference's.
The CUDA kernels themselves run only on a GPU, where ``chip_smoke.py``
holds them against the same plain versions.
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

from photon_tpu import kernels as RK  # noqa: E402
from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.convert import blocked_ell_from_arrays  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import (cast_features,  # noqa: E402
                                           make_batch)
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402

CPU = "cpu"
# Each output is a sum of at most W_b (k_b) products, exact in f32 for bf16
# storage; the two sides add them in another order (XLA's einsum vs
# PyTorch's), so they agree to a few ulp of the sum's magnitude.
RTOL, ATOL = 1e-6, 1e-6
# A full X pass adds the hot block's 32-wide f32 dot to the tail term.
PASS_RTOL, PASS_ATOL = 1e-5, 1e-5


def rows(seed=0, n=300, d=2000, k=12, zipf=1.4, intercept=True):
    """Padded COO rows as the bench makes them: zipf columns, normal
    values, an intercept column d - 1, and two padding slots per row."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(zipf, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    col[:, -2:], val[:, -2:] = 0, 0.0
    if intercept:
        col = np.concatenate([col, np.full((n, 1), d - 1)], axis=1)
        val = np.concatenate([val, np.ones((n, 1), np.float32)], axis=1)
    return col.astype(np.int32), val, d


def layouts(seed=0, d_dense=32, bf16=False, **kw):
    """(reference BlockedEllRows, port BlockedEllRows on the CPU)."""
    ind, val, d = rows(seed, **kw)
    ref = RM.to_blocked_ell(RM.SparseRows(ind, val, d), d_dense)
    port = M.to_blocked_ell(M.SparseRows(ind, val, d), d_dense, device=CPU)
    if bf16:
        n = ind.shape[0]
        ref = RD.cast_features(RD.make_batch(ref, np.zeros(n))).X
        port = cast_features(make_batch(port, np.zeros(n), device=CPU)).X
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


# ---------------------------------------------------------------- builder
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_blocked_ell_equals_reference(seed):
    ref, port = layouts(seed)
    assert port.ell_vals and port.bucket_vals  # a real tail
    assert_same_layout(ref, port)
    assert port.tail_pad_waste == ref.tail_pad_waste
    assert port.ell_slots == ref.ell_slots


@pytest.mark.parametrize("case", ["d_dense_ge_d", "tail_fits_hot"])
def test_to_blocked_ell_without_tail(case):
    """No tail at all: every column hot (d_dense ≥ d), or every used column
    fits the hot block while d_sel < d."""
    if case == "d_dense_ge_d":
        ref, port = layouts(3, d_dense=64, d=40)
    else:
        ref, port = layouts(4, d_dense=48, d=200, zipf=3.5)
    assert port.tail_nnz == 0 and not port.ell_vals
    assert_same_layout(ref, port)


def test_to_blocked_ell_device_dense_block():
    """The hot block built on the device (f32 index_put_, then the bf16
    cast) equals the reference's device scatter bit for bit."""
    ind, val, d = rows(5)
    ref = RM.to_blocked_ell(RM.SparseRows(ind, val, d), 32,
                            device_dense_dtype=jnp.bfloat16)
    port = M.to_blocked_ell(M.SparseRows(ind, val, d), 32,
                            device_dense_dtype=torch.bfloat16, device=CPU)
    assert port.dense.dtype == torch.bfloat16
    assert_same_layout(ref, port)


def test_convert_carries_the_reference_layout_bit_for_bit():
    ref, port = layouts(6, bf16=True)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    carried = blocked_ell_from_arrays(fields, device=CPU)
    assert carried.dense.dtype == torch.bfloat16
    assert_same_layout(ref, carried)
    assert_same_layout(ref, port)  # cast_features rounds as the reference


# ----------------------------------------------------------- kernel forms
def _forms_layout(bf16):
    """A layout whose buckets include one smaller than the reference's
    8-row tile and several spanning many tiles."""
    ref, port = layouts(7, n=400, d=3000, k=20, bf16=bf16)
    for group in (port.ell_vals, port.bucket_vals):
        sizes = [int(v.shape[0]) for v in group]
        assert min(sizes) < 8 < max(sizes), sizes
    return ref, port


def _vec(rng, m, lanes):
    shape = (m, lanes) if lanes else (m,)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("form", ["fused", "tiled"])
def test_tail_matvec_plain_matches_pallas(form, bf16, lanes, monkeypatch):
    monkeypatch.setenv(RK.ENV_TILE, "8")
    ref, port = _forms_layout(bf16)
    w = _vec(np.random.default_rng(lanes), port.n_features, lanes)
    pallas = RK.tail_matvec if form == "fused" else RK.tail_matvec_tiled
    want = np.asarray(pallas(ref, jnp.asarray(w)))
    got = KB.tail_matvec_reference(port, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on CPU tensors both wrappers run the plain version, unchanged
    wrapper = KB.tail_matvec if form == "fused" else KB.tail_matvec_tiled
    np.testing.assert_array_equal(
        wrapper(port, torch.from_numpy(w)).numpy(), got.numpy())
    # rows with no tail read the zero slot
    zero = port.row_pos.numpy() == sum(int(v.shape[0])
                                       for v in port.ell_vals)
    assert zero.any() and not got.numpy()[zero].any()


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("form", ["fused", "tiled"])
def test_bucket_rmatvec_plain_matches_pallas(form, bf16, lanes, square,
                                             monkeypatch):
    monkeypatch.setenv(RK.ENV_TILE, "8")
    ref, port = _forms_layout(bf16)
    r = _vec(np.random.default_rng(10 + lanes), port.shape[0], lanes)
    pallas = RK.bucket_rmatvec if form == "fused" else RK.bucket_rmatvec_tiled
    want = np.asarray(pallas(ref, jnp.asarray(r), square=square))
    got = KB.bucket_rmatvec_reference(port, torch.from_numpy(r), square)
    assert got.shape == want.shape == (
        (port.n_prefix - port.d_sel,) + ((lanes,) if lanes else ()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    wrapper = KB.bucket_rmatvec if form == "fused" else \
        KB.bucket_rmatvec_tiled
    np.testing.assert_array_equal(
        wrapper(port, torch.from_numpy(r), square=square).numpy(),
        got.numpy())


def test_square_does_not_round_the_cotangent():
    """bf16 storage: the normal rmatvec rounds r to bf16 before the
    product, ``square`` does not — a cotangent off the bf16 grid tells
    them apart."""
    _, port = layouts(8, bf16=True)
    n = port.shape[0]
    r = torch.full((n,), 1.0 + 2.0 ** -12)   # rounds to 1.0 in bf16
    ones = torch.ones(n)
    normal = KB.bucket_rmatvec_reference(port, r)
    np.testing.assert_array_equal(
        normal.numpy(), KB.bucket_rmatvec_reference(port, ones).numpy())
    sq = KB.bucket_rmatvec_reference(port, r, square=True)
    sq1 = KB.bucket_rmatvec_reference(port, ones, square=True)
    np.testing.assert_allclose(sq.numpy(), sq1.numpy() * (1.0 + 2.0 ** -12),
                               rtol=1e-6)
    assert not np.array_equal(sq.numpy(), sq1.numpy())


# ---------------------------------------------------------------- X passes
@pytest.mark.parametrize("lanes", [0, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_x_passes_match_reference(bf16, lanes):
    ref, port = layouts(9, bf16=bf16)
    rng = np.random.default_rng(11)
    n, d = port.shape
    w, r = _vec(rng, d, lanes), _vec(rng, n, lanes)
    ref_mv = RM.matvec_lanes if lanes else RM.matvec
    ref_rmv = RM.rmatvec_lanes if lanes else RM.rmatvec
    want_z = np.asarray(ref_mv(ref, jnp.asarray(w)))
    want_g = np.asarray(ref_rmv(ref, jnp.asarray(r)))
    got_z = M.matvec(port, torch.from_numpy(w))
    got_g = M.rmatvec(port, torch.from_numpy(r))
    assert got_z.dtype == got_g.dtype == torch.float32
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=PASS_RTOL,
                               atol=PASS_ATOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=PASS_RTOL,
                               atol=PASS_ATOL)
    if not lanes:
        want_h = np.asarray(RM.sq_rmatvec(ref, jnp.asarray(r)))
        got_h = M.sq_rmatvec(port, torch.from_numpy(r))
        np.testing.assert_allclose(got_h.numpy(), want_h, rtol=PASS_RTOL,
                                   atol=PASS_ATOL)


def test_dense_x_passes_match_reference():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(64, 24)).astype(np.float32)
    w, r = _vec(rng, 24, 0), _vec(rng, 64, 0)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        Xp, Xr = torch.from_numpy(X).to(dtype), jnp.asarray(X).astype(jdt)
        for port_fn, ref_fn, v in ((M.matvec, RM.matvec, w),
                                   (M.rmatvec, RM.rmatvec, r),
                                   (M.sq_rmatvec, RM.sq_rmatvec, r)):
            got = port_fn(Xp, torch.from_numpy(v))
            want = np.asarray(ref_fn(Xr, jnp.asarray(v)))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=PASS_RTOL,
                                       atol=PASS_ATOL)


def test_model_space_round_trip():
    _, port = layouts(13)
    v = torch.arange(port.n_features, dtype=torch.float32)
    np.testing.assert_array_equal(
        port.to_model_space(port.from_model_space(v)).numpy(), v.numpy())
    # the intercept (original column d - 1) sits at last_col_pos
    assert port.from_model_space(v)[port.last_col_pos] == port.n_features - 1


# ------------------------------------------------------------------- seam
def test_route_follows_the_budget(monkeypatch):
    _, port = layouts(14)
    n, d = port.shape
    w, r = torch.zeros(d), torch.zeros(n)
    monkeypatch.delenv(K.ENV_BUDGET, raising=False)
    assert K.budget() is None
    assert K.route(port, w) == K.route(port, r) == "fused"
    # no default budget: a cotangent of 2^20 lanes (GBs) stays fused too
    assert K.route(port, torch.empty((n, 1 << 20), device="meta")) == "fused"
    U = port.n_prefix - port.d_sel
    # a matvec keeps the tail slice w[d_sel:n_prefix] resident, an
    # rmatvec the whole cotangent: fused exactly while that fits
    for vec, nbytes in ((w, 4 * U), (r, 4 * n), (torch.zeros(d, 2), 8 * U)):
        monkeypatch.setenv(K.ENV_BUDGET, str(nbytes))
        assert K.route(port, vec) == "fused"
        monkeypatch.setenv(K.ENV_BUDGET, str(nbytes - 1))
        assert K.route(port, vec) == "tiled"
    monkeypatch.setenv(K.ENV_BUDGET, "0")
    assert K.route(port, w) == K.route(port, r) == "tiled"
    monkeypatch.setenv(K.ENV_BUDGET, "-1")
    with pytest.raises(ValueError, match=K.ENV_BUDGET):
        K.route(port, w)
    monkeypatch.setenv(K.ENV_BUDGET, "lots")
    with pytest.raises(ValueError, match=K.ENV_BUDGET):
        K.route(port, w)


def test_kernel_mode_on_with_cpu_tensors_raises():
    _, port = layouts(15)
    n, d = port.shape
    K.reset_launch_counts()
    with K.scope("on"):
        for call in (lambda: KB.tail_matvec(port, torch.zeros(d)),
                     lambda: KB.tail_matvec_tiled(port, torch.zeros(d)),
                     lambda: KB.bucket_rmatvec(port, torch.zeros(n)),
                     lambda: KB.bucket_rmatvec_tiled(port, torch.zeros(n)),
                     lambda: M.matvec(port, torch.zeros(d))):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert K.launch_counts() == {}


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    ind, val, d = rows(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.to_blocked_ell(M.SparseRows(ind, val, d), 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(np.zeros((4, 3)), np.zeros(4))


def test_operands_are_checked_before_any_build():
    """The wrappers refuse what the kernels do not take, before building
    or launching anything."""
    _, port = layouts(17)
    n, d = port.shape
    with pytest.raises(ValueError, match="float32"):
        KB._check_tail(port, torch.zeros(d, dtype=torch.float64))
    with pytest.raises(ValueError, match="features"):
        KB._check_tail(port, torch.zeros(d + 1))
    with pytest.raises(ValueError, match="not contiguous"):
        KB._check_rmatvec(port, torch.zeros(n, 2)[:, 0])
    bad = dataclasses.replace(port, bucket_vals=tuple(
        v.to(torch.float64) for v in port.bucket_vals))
    with pytest.raises(ValueError, match="f32 or bf16"):
        KB._check_rmatvec(bad, torch.zeros(n))
    mixed = dataclasses.replace(port, ell_vals=(
        port.ell_vals[0].to(torch.bfloat16),) + port.ell_vals[1:])
    with pytest.raises(ValueError, match="values"):
        KB._check_tail(mixed, torch.zeros(d))
