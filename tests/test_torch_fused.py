"""The port's fused value+grad (`photon_tpu_torch.kernels.fused`) against
the JAX package's Pallas kernel (`photon_tpu.ops.fused`, interpret mode on
the CPU, which is what it runs by itself off the TPU).

Same numpy-seeded inputs on both sides; the port runs its plain version
here (the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``, phase D1).
"""
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

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.ops import fused as RF  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data.dataset import cast_features, make_batch  # noqa: E402
from photon_tpu_torch.kernels import fused as F  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402

CPU = "cpu"
TASKS = [t.value for t in TaskType]
# The loss: an f32 sum over up to 4,096 rows added in another order (the
# Pallas tile loop vs PyTorch's sum), a few ulp apart; 1e-5 as the
# reference's own f32 test (tests/test_fused.py:39).
LOSS_RTOL = 1e-5
# The gradient: f32 sums over up to 4,096 rows in another order, against
# the gradient's largest entry (single entries can cancel to near zero).
# With bf16 storage r rounds to bf16, and a last-ulp difference in one
# margin can move that rounding by 2^-8 on one row, so bf16 gets 10x the
# room. Both are far tighter than tests/test_fused.py:40-41 and :50-52
# (rtol 1e-4 / atol 1e-3, and 0.05 for bf16).
GRAD_ATOL = {False: 1e-5, True: 1e-4}


def problem(task, n, d, seed=0, bf16=False):
    """(reference batch, port batch, w) with non-trivial weights and
    offsets; labels of the task's kind; margins of order 2."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if task == "poisson":
        y = rng.poisson(2.0, size=n).astype(np.float32)
    elif task == "linear":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::7] = 0.0  # zero-weight rows contribute nothing
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    w = (2.0 * rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    rb = RD.make_batch(X, y, weights=wt, offsets=off)
    pb = make_batch(X, y, weights=wt, offsets=off, device=CPU)
    if bf16:
        rb, pb = RD.cast_features(rb), cast_features(pb)
    return rb, pb, w


def _close(got, want, bf16):
    lv, g = got
    wl, wg = (np.asarray(x) for x in want)
    np.testing.assert_allclose(float(lv), float(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(g.numpy(), wg, rtol=0,
                               atol=GRAD_ATOL[bf16] * np.abs(wg).max())


@pytest.mark.parametrize("shape", [(1024, 40), (4096, 128)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("task", TASKS)
def test_plain_version_matches_the_pallas_kernel(task, bf16, shape):
    n, d = shape
    rb, pb, w = problem(task, n, d, bf16=bf16)
    want = RF.fused_value_and_grad(RTask(task), rb.X, jnp.asarray(w), rb.y,
                                   rb.weights, rb.offsets)
    got = F.fused_value_and_grad(TaskType(task), pb.X, torch.from_numpy(w),
                                 pb.y, pb.weights, pb.offsets)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert tuple(got[0].shape) == () and tuple(got[1].shape) == (d,)
    _close(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_objective_fused_flag_matches_reference(bf16):
    """Objective(fused=True).value_and_grad on both sides: the L2 term
    with an unregularized intercept rides on the kernel's (loss, Xᵀr)."""
    rb, pb, w = problem("logistic", 1024, 40, seed=3, bf16=bf16)
    mask = np.ones(40, np.float32)
    mask[-1] = 0.0
    ro = RObjective(RTask.LOGISTIC_REGRESSION, l2=np.float32(0.5),
                    fused=True, reg_mask=jnp.asarray(mask))
    po = Objective(TaskType.LOGISTIC_REGRESSION, l2=0.5, fused=True,
                   reg_mask=torch.from_numpy(mask))
    assert F.can_fuse(pb.X) and RF.can_fuse(rb.X)
    K.reset_launch_counts()
    _close(po.value_and_grad(torch.from_numpy(w), pb),
           ro.value_and_grad(jnp.asarray(w), rb), bf16)
    assert K.launch_counts() == {}  # the CPU runs the plain version
    # the unfused route gives the same (f, g) within the same tolerance
    _close(Objective(TaskType.LOGISTIC_REGRESSION, l2=0.5,
                     reg_mask=torch.from_numpy(mask)).value_and_grad(
                         torch.from_numpy(w), pb),
           ro.value_and_grad(jnp.asarray(w), rb), bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_can_fuse_accepts_every_dense_batch_the_reference_accepts(dtype):
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    accepted = 0
    for n in (1, 100, 128, 1000, 4096, 3 * 4096, 1 << 19):
        for d in (1, 40, 256, 1000, 8192, 16384):
            ref = RF.can_fuse(jax.ShapeDtypeStruct((n, d), jdt))
            port = F.can_fuse(torch.empty((n, d), dtype=tdt, device="meta"))
            assert port or not ref, (n, d)
            accepted += ref
    assert accepted > 0
    # the port is wider: any n (ragged last tile), no d % 128 rule
    assert F.can_fuse(torch.empty((1000, 40), dtype=tdt, device="meta"))
    assert not RF.can_fuse(jax.ShapeDtypeStruct((1000, 40), jdt))


def test_can_fuse_rejects_what_the_kernel_does_not_take():
    meta = dict(device="meta")
    assert not F.can_fuse(torch.empty((0, 16), **meta))
    assert not F.can_fuse(torch.empty((16,), **meta))
    assert not F.can_fuse(torch.empty((16, 16), dtype=torch.float64, **meta))
    for dtype in (torch.float32, torch.bfloat16):
        top = F.max_features(dtype)
        assert F.can_fuse(torch.empty((4, top), dtype=dtype, **meta))
        assert not F.can_fuse(torch.empty((4, top + 1), dtype=dtype, **meta))
    ind = np.zeros((4, 2), np.int32)
    val = np.ones((4, 2), np.float32)
    sparse = M.SparseRows(ind, val, 8)
    assert not F.can_fuse(sparse)
    assert not F.can_fuse(M.to_blocked_ell(sparse, 2, device=CPU))


def test_tile_geometry():
    """A full ring at the dense bench width fits the budget twice over an
    SM's 227 KB; the widest d takes one stage of one row and covers the
    reference's widest (a 128-row chunk in its 4 MB slot: 8,192 f32 or
    16,384 bf16 columns)."""
    assert F.tile_rows(256, 4) == F.MAX_ROWS
    assert F.stages(256, 4) == F.STAGES
    assert F.smem_bytes(32, 3, 256, 4) == 101_712 <= F.SMEM_BUDGET
    for dtype, itemsize, ref_top in ((torch.float32, 4, 8192),
                                     (torch.bfloat16, 2, 16384)):
        top = F.max_features(dtype)
        assert top >= ref_top
        assert (F.tile_rows(top, itemsize), F.stages(top, itemsize)) == (1, 1)
        assert (F.tile_rows(top + 1, itemsize),
                F.stages(top + 1, itemsize)) == (0, 0)
        assert F.smem_bytes(1, 1, top, itemsize) <= F.SMEM_BUDGET \
            < F.smem_bytes(1, 1, top + 1, itemsize)


def test_max_features_is_pinned():
    """At the widest d the ring is one stage of one row, whose two
    mbarriers and second cotangent fit in the 16-byte padding of its
    parts: `can_fuse` takes every width up to 12,796 f32 / 17,060 bf16."""
    assert F.max_features(torch.float32) == 12_796
    assert F.max_features(torch.bfloat16) == 17_060


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_fits_the_budget_for_every_width(dtype):
    """For every d up to `max_features`: at least one stage of one row,
    inside the budget, with as many rows as the budget allows for its
    stages (up to `MAX_ROWS`) and fewer stages only where not one row
    fits with more."""
    itemsize = getattr(torch, dtype).itemsize
    for d in range(1, F.max_features(getattr(torch, dtype)) + 1):
        rows, ring = F.tile_rows(d, itemsize), F.stages(d, itemsize)
        assert 1 <= rows <= F.MAX_ROWS and 1 <= ring <= F.STAGES, d
        assert F.smem_bytes(rows, ring, d, itemsize) <= F.SMEM_BUDGET, d
        assert rows == F.MAX_ROWS or F.smem_bytes(
            rows + 1, ring, d, itemsize) > F.SMEM_BUDGET, d
        assert ring == F.STAGES or F.smem_bytes(
            1, ring + 1, d, itemsize) > F.SMEM_BUDGET, d


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    _, pb, w = problem("linear", 64, 8)
    args = (TaskType.LINEAR_REGRESSION, pb.X, torch.from_numpy(w), pb.y,
            pb.weights, pb.offsets)
    K.reset_launch_counts()
    want = F.fused_value_and_grad_reference(*args)
    for mode in ("auto", "off"):
        with K.scope(mode):
            got = F.fused_value_and_grad(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with K.scope("on"), pytest.raises(RuntimeError, match="CUDA"):
        F.fused_value_and_grad(*args)
    assert K.launch_counts() == {}


def test_plain_version_rounds_where_the_reference_does():
    """bf16 storage: w rounds to bf16 before the margin and r before Xᵀr
    (photon_tpu/ops/fused.py:77 and :139) — the same numbers by hand."""
    _, pb, w = problem("logistic", 256, 24, seed=5, bf16=True)
    wt = torch.from_numpy(w)
    loss, g = F.fused_value_and_grad_reference(
        TaskType.LOGISTIC_REGRESSION, pb.X, wt, pb.y, pb.weights, pb.offsets)
    X = pb.X.double()
    z = X @ wt.to(torch.bfloat16).double() + pb.offsets.double()
    r = (pb.weights.double() * (torch.sigmoid(z) - pb.y.double()))
    r16 = r.float().to(torch.bfloat16).double()
    np.testing.assert_allclose(g.numpy(), (X.t() @ r16).numpy(), rtol=0,
                               atol=1e-5 * float((X.t() @ r16).abs().max()))
    want = torch.sum(pb.weights.double()
                     * (torch.logaddexp(z, torch.zeros_like(z))
                        - pb.y.double() * z))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
