"""The port's blocked-ELL layout and X passes against the JAX package.

On the same numpy-seeded padded COO rows: `to_blocked_ell` must lay out
every array exactly as the reference does; the plain PyTorch versions of
the four CUDA kernels (`tail_matvec_reference`,
`bucket_rmatvec_reference`, which the CPU path runs) are held against the
reference's Pallas kernels in interpret mode, fused and tiled, f32 and
bf16 storage, vector and lanes, ``square`` on and off; and `matvec`,
`rmatvec`, `sq_rmatvec` on a `BlockedEllRows` against the reference's.
The rmatvec kernel's work plan (`rmatvec_plan`) is checked on the bucket
shapes of chip_smoke.py's T1 layout and of the headline training layout:
every column covered once, no thread walking more than max(S, k_b /
T_max) slots, longest walk first, each tiled launch the fused plan of its
bucket, a deterministic plan packed as the C struct. So is the tail
matvec's (`tail_plan`, on the same layouts' ELL width buckets): every row
once, no item mixing two widths, widest bucket first, each tiled launch
the fused plan of its bucket, the C struct's fields. The per-layout plan
(`layout_plan`): ``tail_rows`` inverts ``row_pos``, the descriptors and
launch ranges are the layout's, it is built once per layout object. The
``out=`` seams: the tail matvec adds into ``out`` bit for bit, and
`_bell_matvec` is the hot product plus the tail term on either route.
The CUDA kernels themselves run only on a GPU, where ``chip_smoke.py``
holds them against the same plain versions.
"""
import dataclasses
import functools
import gc
import importlib.util
import re
from pathlib import Path

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
ROOT = Path(__file__).resolve().parent.parent
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


# ------------------------------------------------------------ rmatvec plan
# The occurrence buckets (c_b, k_b) of the training path's headline layout:
# bench.py's sparse problem (2^21 rows, 10,000,000 features, 32 zipf(1.4)
# nonzeros + an intercept per row, a 1,024-column hot block) drawn by
# chip_smoke.py's recipe at seed 0 with numpy 2.0 (U = 539,058 tail
# columns; the column counts alone, no 2^21-row data).
T2_BUCKETS = ((380559, 1), (58680, 2), (37970, 4), (23819, 8), (15253, 16),
              (9252, 32), (5701, 64), (3441, 128), (2104, 256), (1290, 512),
              (781, 1024), (208, 2048))


@functools.lru_cache(maxsize=None)
def _t1_shapes():
    """(ELL width bucket shapes, occurrence bucket shapes) of
    chip_smoke.py's T1 layout, built here on the CPU (it asserts that they
    reach every class of the rmatvec's plan, a sub-tile and a many-tile
    bucket)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    X = cs.small_layout(CPU, False)
    return tuple(tuple(tuple(int(s) for s in v.shape) for v in vals)
                 for vals in (X.ell_vals, X.bucket_vals))


@pytest.fixture(scope="module", params=["t1", "t2"])
def bucket_shapes(request):
    return _t1_shapes()[1] if request.param == "t1" else T2_BUCKETS


def _thread_walk(k_b, tpc):
    """The most slots one thread of a tpc-thread group walks in the
    kernel's loops over a k_b-slot column."""
    if k_b % 4 == 0:
        return max(4 * len(range(4 * j, k_b, 4 * tpc)) for j in range(tpc))
    return max(len(range(j, k_b, tpc)) for j in range(tpc))


def test_rmatvec_plan_covers_every_column_once(bucket_shapes):
    plan = KB.rmatvec_plan(bucket_shapes)
    assert plan.dtype == np.int32 and plan.shape[1] == len(KB._PLAN_FIELDS)
    for b, (c_b, _) in enumerate(bucket_shapes):
        mine = plan[plan[:, 0] == b]
        cols = np.concatenate([np.arange(c0, c0 + n) for _, c0, n, _ in mine])
        np.testing.assert_array_equal(np.sort(cols), np.arange(c_b))
    bucket, _, n, tpc = plan.T
    assert ((0 <= bucket) & (bucket < len(bucket_shapes))).all()
    assert (n >= 1).all() and (n * tpc <= KB.BLOCK).all()
    assert ((tpc & (tpc - 1)) == 0).all()  # powers of two: the xor tree


def test_rmatvec_plan_bounds_every_walk(bucket_shapes):
    """No thread walks more than max(S, k_b / T_max) slots (k_b = 2,048
    columns: 8 slots, not 2,048)."""
    plan = KB.rmatvec_plan(bucket_shapes)
    for b, (_, k_b) in enumerate(bucket_shapes):
        tpcs = set(plan[plan[:, 0] == b, 3].tolist())
        assert tpcs == {KB.threads_per_column(k_b)}
        walk = _thread_walk(k_b, tpcs.pop())
        assert walk == KB.walk_length(k_b)
        assert walk <= max(KB.SLOTS_PER_THREAD, k_b // KB.BLOCK), (k_b, walk)


def test_rmatvec_plan_runs_longest_walk_first(bucket_shapes):
    plan = KB.rmatvec_plan(bucket_shapes)
    k = np.asarray([bucket_shapes[b][1] for b in plan[:, 0]])
    walk = np.asarray([KB.walk_length(int(x)) for x in k])
    assert (np.diff(walk) <= 0).all()
    assert (np.diff(k)[np.diff(walk) == 0] <= 0).all()
    assert walk[0] == max(KB.walk_length(k_b) for _, k_b in bucket_shapes)


def test_rmatvec_plan_tiled_launch_is_the_fused_plan_of_its_bucket(
        bucket_shapes):
    plan = KB.rmatvec_plan(bucket_shapes)
    ranges = KB.plan_ranges(plan, len(bucket_shapes))
    assert sum(hi - lo for lo, hi in ranges) == plan.shape[0]
    for b, (lo, hi) in enumerate(ranges):
        np.testing.assert_array_equal(plan[lo:hi], plan[plan[:, 0] == b])
        assert (np.diff(plan[lo:hi, 1]) > 0).all()  # column order


def _c_struct_fields(src: str, name: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    return re.findall(r"^\s*(?:int32_t|long long) (\w+);", body, re.M)


def test_rmatvec_plan_is_deterministic_and_matches_the_c_struct(
        bucket_shapes):
    a, b = KB.rmatvec_plan(bucket_shapes), KB.rmatvec_plan(
        list(bucket_shapes))
    np.testing.assert_array_equal(a, b)
    assert a.flags.c_contiguous
    src = KB.SOURCE.read_text()
    assert tuple(_c_struct_fields(src, "WorkItem")) == KB._PLAN_FIELDS
    assert re.search(r"struct WorkItem \{(?:\s*int32_t \w+;)+\s*\};", src)
    assert tuple(_c_struct_fields(src, "Bucket")) == KB._DESC_FIELDS
    assert f"constexpr int kThreads = {KB.BLOCK};" in src


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("form", ["fused", "tiled"])
def test_bell_rmatvec_fills_one_output_as_the_concatenation(form, lanes):
    """`_bell_rmatvec` writes [hot | bucket block | zero suffix] into one
    result, bit for bit their concatenation, and the wrappers' ``out=``
    writes exactly its slice."""
    for bf16 in (False, True):
        _, X = layouts(18, bf16=bf16)
        n, d = X.shape
        U = X.n_prefix - X.d_sel
        assert d > X.n_prefix  # an untouched suffix
        r = torch.from_numpy(_vec(np.random.default_rng(19), n, lanes))
        tail = () if not lanes else (lanes,)
        wrapper = KB.bucket_rmatvec if form == "fused" else \
            KB.bucket_rmatvec_tiled
        for square in (False, True):
            dense = X.dense * X.dense if square else X.dense
            want = torch.cat([
                M._mm_f32(dense.t(), r.to(X.dense.dtype)),
                KB.bucket_rmatvec_reference(X, r, square),
                torch.zeros((d - X.n_prefix,) + tail)], dim=0)
            got = (M.sq_rmatvec if square else M.rmatvec)(X, r)
            assert got.shape == (d,) + tail and torch.equal(got, want)
            buf = torch.full((U + 5,) + tail, float("nan"))
            res = wrapper(X, r, square=square, out=buf[2:2 + U])
            assert res.data_ptr() == buf[2:].data_ptr()
            assert torch.equal(buf[2:2 + U], want[X.d_sel:X.n_prefix])
            assert buf[:2].isnan().all() and buf[2 + U:].isnan().all()


def test_rmatvec_operands_are_checked():
    """The rmatvec refuses a misaligned bucket (its 16-byte slot loads) and
    an ``out`` that is not the (U[, G]) f32 block."""
    _, X = layouts(20)
    n = X.shape[0]
    U = X.n_prefix - X.d_sel
    b = next(i for i, v in enumerate(X.bucket_rows) if v.shape[1] >= 4)
    c, k = X.bucket_rows[b].shape
    shifted = torch.zeros(c * k + 1, dtype=torch.int32)[1:].view(c, k)
    bad = dataclasses.replace(X, bucket_rows=X.bucket_rows[:b] + (
        shifted,) + X.bucket_rows[b + 1:])
    with pytest.raises(ValueError, match="aligned"):
        KB._check_rmatvec(bad, torch.zeros(n))
    plan, lanes = KB._check_rmatvec(X, torch.zeros(n, 2))
    assert lanes == 2 and plan.occ_args[-1].value == 0  # f32 values
    r = torch.zeros(n)
    with pytest.raises(ValueError, match="out"):
        KB._rmatvec_out(X, r, torch.zeros(U + 1))
    with pytest.raises(ValueError, match="out"):
        KB._rmatvec_out(X, r, torch.zeros(U, dtype=torch.float64))
    assert KB._rmatvec_out(X, r, None).shape == (U,)


# -------------------------------------------------------------- tail plan
# The ELL width buckets (r_b, W_b) of the same headline layout, as
# chip_smoke.py's T2 line prints them on the card (seed 0, the numpy
# there: U = 539,182 tail columns, 1,694,311 rows with a tail).
T2_ELL_BUCKETS = ((680425, 1), (559958, 2), (410178, 4), (43698, 8),
                  (52, 16))


@pytest.fixture(scope="module", params=["t1", "t2"])
def ell_shapes(request):
    return _t1_shapes()[0] if request.param == "t1" else T2_ELL_BUCKETS


def _port(seed, bf16=False, **kw):
    """A port layout on the CPU alone (no reference build)."""
    ind, val, d = rows(seed, **kw)
    X = M.to_blocked_ell(M.SparseRows(ind, val, d), 32, device=CPU)
    return X.astype(torch.bfloat16) if bf16 else X


def test_tail_plan_covers_every_row_once(ell_shapes):
    """Every row of every width bucket in exactly one item, an item's rows
    inside its own bucket (no item mixes two widths), at most
    `rows_per_thread` rows a thread: TAIL_SLOTS_PER_THREAD slots, or one
    wider row."""
    plan = KB.tail_plan(ell_shapes)
    assert plan.dtype == np.int32 and plan.shape[1] == len(KB._TAIL_FIELDS)
    bucket, row0, n_rows = plan.T
    assert ((0 <= bucket) & (bucket < len(ell_shapes))).all()
    per = np.asarray([KB.rows_per_thread(w) for _, w in ell_shapes])[bucket]
    assert ((1 <= n_rows) & (n_rows <= KB.BLOCK * per)).all()
    w_b = np.asarray([w for _, w in ell_shapes])[bucket]
    assert (w_b * per == np.maximum(w_b, KB.TAIL_SLOTS_PER_THREAD)).all()
    r_b = np.asarray([r for r, _ in ell_shapes])[bucket]
    assert ((0 <= row0) & (row0 + n_rows <= r_b)).all()
    for b, (r, _) in enumerate(ell_shapes):
        mine = plan[plan[:, 0] == b]
        covered = np.concatenate([np.arange(r0, r0 + k) for _, r0, k in mine])
        np.testing.assert_array_equal(np.sort(covered), np.arange(r))


def test_tail_plan_runs_widest_bucket_first(ell_shapes):
    plan = KB.tail_plan(ell_shapes)
    widths = np.asarray([ell_shapes[b][1] for b in plan[:, 0]])
    assert (np.diff(widths) <= 0).all()
    assert widths[0] == max(w for _, w in ell_shapes)


def test_tail_plan_tiled_launch_is_the_fused_plan_of_its_bucket(ell_shapes):
    plan = KB.tail_plan(ell_shapes)
    ranges = KB.plan_ranges(plan, len(ell_shapes))
    assert sum(hi - lo for lo, hi in ranges) == plan.shape[0]
    for b, (lo, hi) in enumerate(ranges):
        np.testing.assert_array_equal(plan[lo:hi], plan[plan[:, 0] == b])
        assert (np.diff(plan[lo:hi, 1]) > 0).all()  # row order


def test_tail_plan_is_deterministic_and_matches_the_c_struct(ell_shapes):
    a, b = KB.tail_plan(ell_shapes), KB.tail_plan(list(ell_shapes))
    np.testing.assert_array_equal(a, b)
    assert a.flags.c_contiguous
    src = KB.SOURCE.read_text()
    assert tuple(_c_struct_fields(src, "TailItem")) == KB._TAIL_FIELDS
    assert re.search(r"struct TailItem \{(?:\s*int32_t \w+;)+\s*\};", src)
    assert (f"constexpr int kTailSlotsPerThread = "
            f"{KB.TAIL_SLOTS_PER_THREAD};") in src
    assert f"constexpr int kMaxTailBuckets = {KB.MAX_TAIL_BUCKETS};" in src
    assert [KB.rows_per_thread(1 << e) for e in range(6)] == [4, 2, 1, 1, 1,
                                                               1]


@pytest.mark.parametrize("seed", [7, 18])
def test_layout_plan_inverts_row_pos_and_packs_the_buckets(seed):
    """``tail_rows`` is argsort(row_pos)[:B], a bijection onto the rows
    with a tail; the descriptors and both work plans are the layout's."""
    X = _port(seed, n=400, d=3000, k=20)
    plan = KB.layout_plan(X)
    row_pos = X.row_pos.numpy()
    B = sum(int(v.shape[0]) for v in X.ell_vals)
    tail_rows = plan.tail_rows.numpy()
    assert plan.tail_rows.dtype == torch.int32 and B < X.shape[0]
    np.testing.assert_array_equal(tail_rows,
                                  np.argsort(row_pos, kind="stable")[:B])
    np.testing.assert_array_equal(np.sort(tail_rows),
                                  np.flatnonzero(row_pos != B))
    np.testing.assert_array_equal(row_pos[tail_rows], np.arange(B))
    for desc, idx, vals in ((plan.tail_desc, X.ell_pcols, X.ell_vals),
                            (plan.occ_desc, X.bucket_rows, X.bucket_vals)):
        shapes = np.asarray([v.shape for v in vals])
        np.testing.assert_array_equal(desc.numpy(), np.column_stack([
            [i.data_ptr() for i in idx], [v.data_ptr() for v in vals],
            shapes, np.cumsum(shapes[:, 0]) - shapes[:, 0]]))
    for items, fused, tiled, host in (
            (plan.tail_items, plan.tail_fused, plan.tail_tiled,
             KB.tail_plan([tuple(v.shape) for v in X.ell_vals])),
            (plan.occ_items, plan.occ_fused, plan.occ_tiled,
             KB.rmatvec_plan([tuple(v.shape) for v in X.bucket_vals]))):
        np.testing.assert_array_equal(items.numpy(), host)
        # the launches the C entry point makes: one over every item, or
        # one per bucket over its items
        assert list(fused[0]) == [0, len(host)]
        assert (fused[1].value, fused[2]) == (1, 1)
        ranges = KB.plan_ranges(host, len(tiled[0]) // 2)
        assert list(tiled[0]) == [x for r in ranges for x in r]
        assert (tiled[1].value, tiled[2]) == (len(ranges), len(ranges))
    # the entry points' leading arguments are the plan's own tensors
    assert [a.value for a in plan.tail_args] == [
        plan.tail_desc.data_ptr(), len(X.ell_vals),
        plan.tail_items.data_ptr(), plan.tail_rows.data_ptr(), 0]
    assert [a.value for a in plan.occ_args] == [
        plan.occ_desc.data_ptr(), plan.occ_items.data_ptr(), 0]


def test_layout_plan_is_built_once_per_layout(monkeypatch):
    built = []
    real = KB._build_plan
    monkeypatch.setattr(KB, "_build_plan",
                        lambda X: built.append(id(X)) or real(X))
    X = _port(22)
    n, d = X.shape
    for _ in range(3):
        KB._check_tail(X, torch.zeros(d))
        KB._check_rmatvec(X, torch.zeros(n, 2))
    assert KB.layout_plan(X) is KB.layout_plan(X) and len(built) == 1
    # a batch moved to where it already is keeps its layout, and its plan
    moved = make_batch(X, np.zeros(n), device=CPU).to(CPU).X
    assert moved is X and X.to(torch.device(CPU)) is X
    assert KB.layout_plan(moved) is KB.layout_plan(X) and len(built) == 1
    Y = X.astype(torch.bfloat16)  # a second layout: its own plan
    assert KB.layout_plan(Y) is not KB.layout_plan(X) and len(built) == 2
    # the bf16 flag of each entry point's arguments
    assert KB.layout_plan(Y).tail_args[-1].value == 1
    assert KB.layout_plan(Y).occ_args[-1].value == 1
    assert KB.layout_plan(X).tail_args[-1].value == 0
    key = id(Y)
    del Y
    gc.collect()
    assert key not in KB._PLANS  # a collected layout's plan goes with it


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("form", ["fused", "tiled"])
def test_tail_matvec_adds_into_out(form, bf16, lanes):
    """``out=`` takes ``out + tail`` in place, bit for bit; rows with no
    tail keep their value."""
    X = _port(7, bf16, n=400, d=3000, k=20)
    n, d = X.shape
    rng = np.random.default_rng(30 + lanes)
    w = torch.from_numpy(_vec(rng, d, lanes))
    h = torch.from_numpy(_vec(rng, n, lanes))
    wrapper = KB.tail_matvec if form == "fused" else KB.tail_matvec_tiled
    tail = wrapper(X, w)
    buf = h.clone()
    res = wrapper(X, w, out=buf)
    assert res.data_ptr() == buf.data_ptr()
    assert torch.equal(buf, h + tail)
    zero = X.row_pos.numpy() == sum(int(v.shape[0]) for v in X.ell_vals)
    assert zero.any() and torch.equal(buf[zero], h[zero])


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("route", ["fused", "tiled"])
def test_bell_matvec_adds_the_tail_into_the_hot_product(route, lanes,
                                                        monkeypatch):
    """`_bell_matvec` is the hot product + the tail term, bit for bit, on
    either route."""
    if route == "tiled":
        monkeypatch.setenv(K.ENV_BUDGET, "0")
    else:
        monkeypatch.delenv(K.ENV_BUDGET, raising=False)
    for bf16 in (False, True):
        X = _port(24, bf16)
        assert K.route(X, torch.zeros(X.n_features)) == route
        w = torch.from_numpy(_vec(np.random.default_rng(25), X.n_features,
                                  lanes))
        want = (M._mm_f32(X.dense, w[:X.d_sel].to(X.dense.dtype))
                + KB.tail_matvec_reference(X, w))
        got = M.matvec(X, w)
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_tail_out_is_checked():
    """``out`` of the wrong shape, dtype or device raises, on both forms."""
    X = _port(26)
    n, d = X.shape
    w = torch.zeros(d)
    bad = (torch.zeros(n + 1), torch.zeros(n, dtype=torch.float64),
           torch.zeros(n, 2), torch.zeros(n, device="meta"),
           torch.zeros(2 * n)[::2])
    for out in bad:
        with pytest.raises(ValueError, match="out"):
            KB._tail_out(X, w, out)
        for fn in (KB.tail_matvec, KB.tail_matvec_tiled):
            with pytest.raises(ValueError, match="out"):
                fn(X, w, out=out)
    out, zero_bytes = KB._tail_out(X, w, None)  # zeroed by the entry point
    assert out.shape == (n,) and out.dtype == torch.float32
    assert zero_bytes == 4 * n
    given, zero_bytes = KB._tail_out(X, w, out)
    assert given is out and zero_bytes == 0


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
