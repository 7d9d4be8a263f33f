"""The dense GLM objective's value and gradient in one pass over X, as a
hand-written CUDA kernel (port of the Pallas kernel
`photon_tpu/ops/fused.py::fused_value_and_grad`).

`fused_value_and_grad` returns the LOCAL weighted loss sum and Xᵀr of a
dense (n, d) f32 or bf16 X: z = X·S(w) + offset with f32 accumulation,
loss = Σ weight·loss(z, y) in f32, r = S(weight·d1(z, y)), g = Xᵀr in f32,
where S rounds to X's dtype (the reference's rounding points,
`photon_tpu/ops/fused.py:77` and `:139`). On a CUDA tensor it launches
`csrc/fused_vg.cu` (counted in `kernels.count_launch`) or raises; on a CPU
tensor, or under ``scope("off")``, it runs
`fused_value_and_grad_reference`, the plain PyTorch version, whose
products run on upcast operands (every bf16×bf16 product exact) and sum
in f64, as near-exactly as the kernel's compensated sums.

The kernel reads X from HBM once per call, against the two reads of the
unfused route (``matvec`` then ``rmatvec``): each block of a persistent
grid keeps a ring of `stages` row tiles in shared memory, filled by bulk
asynchronous copies while it forms both products from the tile before
them; a second small kernel sums the blocks' partials in a fixed order
(no atomics, so a call repeats bit for bit). `tile_rows`, `stages` and
`smem_bytes` mirror the source's layout; `_plan` caches the geometry and
the grid per shape.

`can_fuse` is the port's own gate: a dense 2-D f32 or bf16 X with at
least one row, and rows that fit the kernel's shared-memory budget
(`max_features`). The reference's 4 MB VMEM slot, its power-of-two row
chunks dividing n and its d % 128 rule are TPU facts that do not carry
over: the kernel takes any n, masking its ragged last tile. So the port's
`train_glm` does not pad the batch to a multiple of 4,096 rows as the
reference does; zero-weight padding rows add nothing to the loss or the
gradient, so the two agree either way.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch.ops.losses import TaskType, loss_fns

KERNEL = "fused_value_and_grad"
SOURCE = Path(__file__).parent / "csrc" / "fused_vg.cu"
_DTYPES = (torch.float32, torch.bfloat16)
# the task's number in csrc/fused_vg.cu (enum Task)
_TASK_IDS = {TaskType.LOGISTIC_REGRESSION: 0,
             TaskType.LINEAR_REGRESSION: 1,
             TaskType.POISSON_REGRESSION: 2,
             TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: 3}
# Shared memory one block may take (of the 227 KB a Hopper block can opt
# into); the rows of a full tile and the tiles of a full ring, chosen by
# chip_fused_ab.py at D2's shape.
SMEM_BUDGET = 200 * 1024
MAX_ROWS = 32
STAGES = 3
_WARPS = 8

_lib = None
_lib_lock = threading.Lock()
_plan_lock = threading.Lock()
_PLANS: dict = {}


def library() -> ctypes.CDLL:
    """The built kernel library (built on first call; raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = K.load_library(SOURCE)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.photon_fused_vg.argtypes = [p, p, p, p, p, ll, i, i, i, i, i,
                                            i, p, p, p]
            lib.photon_fused_vg.restype = i
            lib.photon_fused_vg_grid.argtypes = [ll, i, i, i, i,
                                                 ctypes.POINTER(i)]
            lib.photon_fused_vg_grid.restype = i
            lib.photon_fused_vg_error_string.argtypes = [i]
            lib.photon_fused_vg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ----------------------------------------------------------- tile geometry
def _align16(b: int) -> int:
    return (b + 15) & ~15


def smem_bytes(rows: int, stages: int, d: int, itemsize: int) -> int:
    """Shared memory of one block for a ring of ``stages`` tiles of
    ``rows`` rows: the tiles, w in X's dtype, the gradient sums and their
    compensations, two buffers of the tile's cotangents, the warps' loss
    sums and each stage's two mbarriers (``smem_bytes`` in
    csrc/fused_vg.cu computes the same layout)."""
    return (stages * _align16(rows * d * itemsize) + _align16(d * itemsize)
            + 2 * _align16(4 * d) + _align16(8 * rows) + 4 * _WARPS
            + 16 * stages)


def _ring(d: int, itemsize: int) -> tuple:
    """(rows, stages) of the ring for rows of ``d`` columns: `STAGES` tiles
    of up to `MAX_ROWS` rows, fewer rows while the budget does not hold
    them, then fewer stages; (0, 0) when not one row fits."""
    for stages in range(STAGES, 0, -1):
        rows = MAX_ROWS
        while rows > 0 and smem_bytes(rows, stages, d, itemsize) \
                > SMEM_BUDGET:
            rows -= 1
        if rows:
            return rows, stages
    return 0, 0


def tile_rows(d: int, itemsize: int) -> int:
    """The rows of a tile (0 when not even one row fits)."""
    return _ring(d, itemsize)[0]


def stages(d: int, itemsize: int) -> int:
    """The tiles of the ring (0 when not even one row fits)."""
    return _ring(d, itemsize)[1]


def _widest(itemsize: int) -> int:
    d = SMEM_BUDGET // (2 * itemsize + 8)  # an upper bound
    while smem_bytes(1, 1, d, itemsize) > SMEM_BUDGET:
        d -= 1
    return d


_MAX_FEATURES = {dt: _widest(dt.itemsize) for dt in _DTYPES}


def max_features(dtype) -> int:
    """The widest d the kernel takes for storage ``dtype`` (one row per
    tile): 12,796 for f32, 17,060 for bf16."""
    return _MAX_FEATURES[dtype]


def can_fuse(X) -> bool:
    """Dense 2-D f32/bf16 X with at least one row and a row width the
    kernel takes."""
    return (isinstance(X, torch.Tensor) and X.dim() == 2
            and X.dtype in _DTYPES and X.shape[0] >= 1
            and 1 <= X.shape[1] <= max_features(X.dtype))


# ----------------------------------------------------------- plain version
def fused_value_and_grad_reference(task: TaskType, X: torch.Tensor,
                                   w: torch.Tensor, y: torch.Tensor,
                                   weights: torch.Tensor,
                                   offsets: torch.Tensor):
    """The plain (loss sum, Xᵀr): w rounds to X's dtype, r rounds to X's
    dtype, and the per-element math is f32, at the reference's points.
    The two products and the loss sum run in f64 and round to f32 once,
    so the margin is within an ulp of the exact one, as the kernel's
    compensated sums are: with bf16 storage both sides then round r to
    bf16 alike (a margin an ulp off can move r by a bf16 step)."""
    loss_f, d1_f, _ = loss_fns(task)
    Xd = X.double()
    z = (Xd @ w.to(X.dtype).double()).float() + offsets
    loss = torch.sum((weights * loss_f(z, y)).double()).float()
    r = (weights * d1_f(z, y)).to(X.dtype)
    return loss, (Xd.t() @ r.double()).float()


# ---------------------------------------------------------------- wrapper
def fused_value_and_grad(task: TaskType, X: torch.Tensor, w: torch.Tensor,
                         y: torch.Tensor, weights: torch.Tensor,
                         offsets: torch.Tensor):
    """(Σᵢ weightᵢ·loss(zᵢ, yᵢ), Xᵀ(weight∘d1)) as f32 tensors — () and
    (d,) — in one pass over X."""
    if not K.use_kernel(X):
        return fused_value_and_grad_reference(task, X, w, y, weights,
                                              offsets)
    n, d, bf16 = _check(X, w, y, weights, offsets)
    rows, ring, ctas = _plan(X.device, n, d, bf16)
    # the blocks' (ctas, d + 1) partials, then the (d + 1,) result
    buf = torch.empty(((ctas + 1) * (d + 1),), dtype=torch.float32,
                      device=X.device)
    out = buf[ctas * (d + 1):]
    lib = _lib if _lib is not None else library()
    code = K.launch(lib.photon_fused_vg, X.get_device(), X.data_ptr(),
                    w.data_ptr(), y.data_ptr(), weights.data_ptr(),
                    offsets.data_ptr(), n, d, int(bf16), _TASK_IDS[task],
                    rows, ring, ctas, buf.data_ptr(), out.data_ptr())
    if code:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.photon_fused_vg_error_string(code)}")
    K.count_launch(KERNEL)
    return out[d], out[:d]


def _check(X, w, y, weights, offsets):
    if not can_fuse(X) or not X.is_contiguous():
        raise ValueError(
            f"X: expected a contiguous 2-D f32 or bf16 tensor with n >= 1 "
            f"and 1 <= d <= max_features(dtype), got {X.dtype} "
            f"{tuple(X.shape)}{'' if X.is_contiguous() else ' (not contiguous)'}")
    n, d = (int(s) for s in X.shape)
    for what, t, m in (("w", w, d), ("y", y, n), ("weights", weights, n),
                       ("offsets", offsets, n)):
        if not isinstance(t, torch.Tensor) or t.device != X.device \
                or t.dtype != torch.float32 or tuple(t.shape) != (m,) \
                or not t.is_contiguous():
            raise ValueError(
                f"{what}: expected a contiguous f32 tensor of shape ({m},) "
                f"on {X.device}, got "
                + (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else str(type(t))))
    return n, d, X.dtype == torch.bfloat16


def _plan(device, n: int, d: int, bf16: bool):
    """(rows per tile, stages, blocks) for this shape on ``device``: one
    full wave of resident blocks, at most one per tile (cached per
    shape)."""
    key = (device, n, d, bf16)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    rows, ring = _ring(d, 2 if bf16 else 4)
    lib = library()
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):  # once per shape
        code = lib.photon_fused_vg_grid(n, d, int(bf16), rows, ring,
                                        ctypes.byref(ctas))
    if code:
        raise RuntimeError(f"{KERNEL} grid query failed: "
                           f"{lib.photon_fused_vg_error_string(code)}")
    plan = (rows, ring, int(ctas.value))
    with _plan_lock:
        _PLANS[key] = plan
    return plan
