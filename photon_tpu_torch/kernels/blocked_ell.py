"""The blocked-ELL X passes as hand-written CUDA kernels (port of the four
Pallas kernels of `photon_tpu/kernels/blocked_ell.py`).

Four wrappers, two kernel bodies in `csrc/blocked_ell.cu`:

- `tail_matvec` (fused): ONE launch over the n original rows returns the
  (n,)/(n, G) f32 tail term in original row order — each row finds its
  width bucket through ``row_pos`` (the zero slot gives 0);
- `tail_matvec_tiled`: one launch per width bucket over row tiles, then
  the concat + zero row + ``row_pos`` gather in PyTorch, as the reference
  does outside its tiled kernels;
- `bucket_rmatvec` (fused): ONE launch over every item of the layout's
  work plan (`rmatvec_plan`) returns the (U,)/(U, G) tail-gradient block
  in prefix order; ``square`` gives (X∘X)ᵀr;
- `bucket_rmatvec_tiled`: one launch per occurrence bucket over that
  bucket's items, each writing its slice of one preallocated output.

Both rmatvec forms take ``out=``, a preallocated (U,)/(U, G) f32 view to
write the block into (the caller's slice of the full (d,)/(d, G)
gradient).

The caller (`data.matrix`) adds the hot block's product and picks the
form with `kernels.route`. `tail_matvec_reference` and
`bucket_rmatvec_reference` are the plain PyTorch versions of the same
functions (gather, f32 upcast, product, sum; the same bf16 rounding
points):
the CPU runs them, the tests hold them against the JAX package, and
``chip_smoke.py`` holds every kernel against them on the card.

Each wrapper checks its operands, then on a CUDA tensor launches its
kernel (counting the launch in `kernels.count_launch`) or raises; it takes
the plain version only for CPU tensors (or under ``scope("off")``).
Operand contract: w / r f32 contiguous, (d,)/(d, G) or (n,)/(n, G); every
index matrix int32 and every value matrix f32 or bf16 (one dtype for all),
contiguous, on the vector's device; occurrence buckets whose width is a
multiple of 4 start 16-byte aligned, as the caching allocator gives
them. Index ranges are what `data.matrix.to_blocked_ell` guarantees:
ell_pcols in [0, U), row_pos in [0, B], bucket_rows in [0, n).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from photon_tpu_torch import kernels as K

SOURCE = Path(__file__).parent / "csrc" / "blocked_ell.cu"
TAIL = "tail_matvec"
TAIL_TILED = "tail_matvec_tiled"
RMATVEC = "bucket_rmatvec"
RMATVEC_TILED = "bucket_rmatvec_tiled"
# Bucket in csrc/blocked_ell.cu: one int64 per field, in this order
_DESC_FIELDS = ("idx", "val", "rows", "width", "base")
_DESC_BYTES = 8 * len(_DESC_FIELDS)
# WorkItem in csrc/blocked_ell.cu: one int32 per field, in this order
_PLAN_FIELDS = ("bucket", "col0", "cols", "tpc")
_ITEM_BYTES = 4 * len(_PLAN_FIELDS)
_VALUE_DTYPES = (torch.float32, torch.bfloat16)
# the rmatvec's work plan: kThreads in the source (one block per item, and
# the most threads one column gets) and the slots one thread walks
BLOCK = 256
SLOTS_PER_THREAD = 8

_lib = None
_lib_lock = threading.Lock()
# descriptor arrays on the device, keyed by their own content (pointers,
# shapes, device), so a layout uploads its descriptors once
_desc_lock = threading.Lock()
_DESC_CACHE: dict = {}
_DESC_CACHE_MAX = 64


def library() -> ctypes.CDLL:
    """The built kernel library (built on first call; raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = K.load_library(SOURCE)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.photon_bell_tail_matvec.argtypes = [p, i, p, p, i, ll, i, p,
                                                    p]
            lib.photon_bell_tail_matvec.restype = i
            lib.photon_bell_bucket_rmatvec.argtypes = [p, p, i, p, i, i, i,
                                                       p, p]
            lib.photon_bell_bucket_rmatvec.restype = i
            lib.photon_bell_error_string.argtypes = [i]
            lib.photon_bell_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ---------------------------------------------------------- plain versions
def _compute(v: torch.Tensor, g: torch.Tensor):
    """(values, gathered) as f32 in the reference's `_bell_compute` recipe:
    the gathered operand rounds to the storage dtype first."""
    if g.dtype != v.dtype:
        g = g.to(v.dtype)
    return v.float(), g.float()


def _gather(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vec[idx]`` for an (a, b) index matrix → (a, b[, G])."""
    flat = torch.index_select(vec, 0, idx.reshape(-1))
    return flat.reshape(tuple(idx.shape) + tuple(vec.shape[1:]))


def _rowdot(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Σ_k v[:, k]·g[:, k(, lane)] in f32. PyTorch's `sum` reduces in a
    tree, so a long row's sum stays within a few ulp of the exact one, as
    the kernels' compensated sums do."""
    if g.dim() == 3:
        v = v[:, :, None]
    return (v * g).sum(dim=1)


def tail_matvec_reference(X, w: torch.Tensor) -> torch.Tensor:
    """The plain tail matvec: per width bucket gather ``w[d_sel:n_prefix]``
    at the prefix-relative ids, round to the storage dtype, rowwise dot in
    f32; concat the buckets plus a zero row, gather by ``row_pos``."""
    wt = w[X.d_sel:X.n_prefix]
    parts = []
    for pc, pv in zip(X.ell_pcols, X.ell_vals):
        parts.append(_rowdot(*_compute(pv, _gather(wt, pc))))
    parts.append(torch.zeros((1,) + tuple(w.shape[1:]), dtype=torch.float32,
                             device=w.device))
    return torch.index_select(torch.cat(parts, dim=0), 0, X.row_pos)


def bucket_rmatvec_reference(X, r: torch.Tensor,
                             square: bool = False) -> torch.Tensor:
    """The plain occurrence-bucket rmatvec: per bucket gather ``r`` at the
    row ids and dot with the values in f32 (values squared in f32 and r
    not rounded for ``square``), concatenated in prefix order."""
    parts = []
    for br, bv in zip(X.bucket_rows, X.bucket_vals):
        g = _gather(r, br)
        if square:
            v = bv.float()
            v, g = v * v, g.float()
        else:
            v, g = _compute(bv, g)
        parts.append(_rowdot(v, g))
    if not parts:
        return torch.zeros((0,) + tuple(r.shape[1:]), dtype=torch.float32,
                           device=r.device)
    return torch.cat(parts, dim=0)


# --------------------------------------------------------- rmatvec plan
def threads_per_column(k_b: int) -> int:
    """The group of threads that sums one column of a k_b-slot bucket: the
    largest power of two ≤ k_b / SLOTS_PER_THREAD, between 1 and BLOCK."""
    t = 1
    while 2 * t <= min(k_b // SLOTS_PER_THREAD, BLOCK):
        t *= 2
    return t


def walk_length(k_b: int) -> int:
    """The most slots one thread of a k_b-slot column walks: SLOTS_PER_THREAD
    for every power-of-two k_b from SLOTS_PER_THREAD to
    SLOTS_PER_THREAD·BLOCK, k_b below it, k_b / BLOCK above it."""
    t = threads_per_column(k_b)
    if k_b % 4 == 0:  # the kernel's 4-slot vector steps
        return 4 * -(-k_b // (4 * t))
    return -(-k_b // t)


def rmatvec_plan(bucket_shapes) -> np.ndarray:
    """The rmatvec's work plan for occurrence buckets of (c_b, k_b) shapes:
    an (items, 4) int32 array of (bucket, col0, cols, tpc) rows, fields as
    `_PLAN_FIELDS`. Each item is one block's worth of one bucket's
    columns: ``cols`` columns from ``col0`` on, each summed by ``tpc`` =
    `threads_per_column` threads, cols·tpc ≤ BLOCK. Items run longest walk
    first (then wider buckets first, then bucket and column order), so the
    long columns start first and the short ones fill in behind; one
    bucket's items are contiguous, in column order."""
    parts = []
    for b, (c_b, k_b) in enumerate(bucket_shapes):
        tpc = threads_per_column(int(k_b))
        per = BLOCK // tpc
        col0 = np.arange(0, int(c_b), per, dtype=np.int64)
        item = np.empty((col0.size, len(_PLAN_FIELDS)), np.int32)
        item[:, 0], item[:, 1] = b, col0
        item[:, 2], item[:, 3] = np.minimum(per, int(c_b) - col0), tpc
        parts.append(((-walk_length(int(k_b)), -int(k_b), b), item))
    parts.sort(key=lambda kv: kv[0])
    if not parts:
        return np.zeros((0, len(_PLAN_FIELDS)), np.int32)
    return np.concatenate([item for _, item in parts])


def plan_ranges(plan: np.ndarray, n_buckets: int) -> list:
    """Each bucket's (first, end) rows of ``plan``: the items one launch of
    the tiled form runs."""
    out = []
    for b in range(n_buckets):
        rows = np.flatnonzero(plan[:, 0] == b)
        out.append((int(rows[0]), int(rows[-1]) + 1) if rows.size else (0, 0))
    return out


# ---------------------------------------------------------------- wrappers
def tail_matvec(X, w: torch.Tensor) -> torch.Tensor:
    """The fused tail matvec: (n,)/(n, G) f32 tail term in original row
    order, one launch. ``w`` is the full permuted (d,)/(d, G) vector."""
    if not K.use_kernel(w):
        return tail_matvec_reference(X, w)
    wt, lanes, bf16 = _check_tail(X, w)
    n = int(X.row_pos.shape[0])
    _check(X.row_pos, torch.int32, (n,), w.device, "row_pos")
    desc = _descriptors(X.ell_pcols, X.ell_vals, w.device)
    out = torch.empty((n,) + tuple(w.shape[1:]), dtype=torch.float32,
                      device=w.device)
    _launch_tail(TAIL, desc.data_ptr(), len(X.ell_vals),
                 X.row_pos.data_ptr(), wt, lanes, n, bf16, out)
    K.count_launch(TAIL)
    return out


def tail_matvec_tiled(X, w: torch.Tensor) -> torch.Tensor:
    """The tiled tail matvec: one launch per width bucket over its rows,
    then concat + zero row + ``row_pos`` gather. Same values as
    `tail_matvec`."""
    if not K.use_kernel(w):
        return tail_matvec_reference(X, w)
    wt, lanes, bf16 = _check_tail(X, w)
    _check(X.row_pos, torch.int32, (int(X.row_pos.shape[0]),), w.device,
           "row_pos")
    desc = _descriptors(X.ell_pcols, X.ell_vals, w.device)
    parts = []
    for b, pv in enumerate(X.ell_vals):
        r_b = int(pv.shape[0])
        out = torch.empty((r_b,) + tuple(w.shape[1:]), dtype=torch.float32,
                          device=w.device)
        _launch_tail(TAIL_TILED, desc.data_ptr() + b * _DESC_BYTES, 1, 0, wt,
                     lanes, r_b, bf16, out)
        K.count_launch(TAIL_TILED)
        parts.append(out)
    parts.append(torch.zeros((1,) + tuple(w.shape[1:]), dtype=torch.float32,
                             device=w.device))
    return torch.index_select(torch.cat(parts, dim=0), 0, X.row_pos)


def bucket_rmatvec(X, r: torch.Tensor, square: bool = False,
                   out=None) -> torch.Tensor:
    """The fused occurrence-bucket rmatvec: the (U,)/(U, G) f32 tail
    gradient block in prefix order (written into ``out`` when given), one
    launch over every item of the layout's work plan."""
    if not K.use_kernel(r):
        return _plain_into(bucket_rmatvec_reference(X, r, square), out)
    lanes, bf16 = _check_rmatvec(X, r)
    desc = _descriptors(X.bucket_rows, X.bucket_vals, r.device)
    plan, _ = _plan(X.bucket_vals, r.device)
    out = _rmatvec_out(X, r, out)
    _launch_rmatvec(RMATVEC, desc.data_ptr(), plan.data_ptr(),
                    int(plan.shape[0]), r, lanes, bf16, square, out)
    K.count_launch(RMATVEC)
    return out


def bucket_rmatvec_tiled(X, r: torch.Tensor, square: bool = False,
                         out=None) -> torch.Tensor:
    """The tiled occurrence-bucket rmatvec: one launch per bucket over that
    bucket's items of the plan, each into its slice of one output. The
    same items per bucket as `bucket_rmatvec`, so the same bits."""
    if not K.use_kernel(r):
        return _plain_into(bucket_rmatvec_reference(X, r, square), out)
    lanes, bf16 = _check_rmatvec(X, r)
    desc = _descriptors(X.bucket_rows, X.bucket_vals, r.device)
    plan, ranges = _plan(X.bucket_vals, r.device)
    out = _rmatvec_out(X, r, out)
    for lo, hi in ranges:
        _launch_rmatvec(RMATVEC_TILED, desc.data_ptr(),
                        plan.data_ptr() + lo * _ITEM_BYTES, hi - lo, r,
                        lanes, bf16, square, out)
        K.count_launch(RMATVEC_TILED)
    return out


# ----------------------------------------------------------------- helpers
def _check(t, dtype, shape, device, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {' or '.join(map(str, dtypes))} "
            f"tensor of shape {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_vector(v: torch.Tensor, what: str) -> int:
    """The lane count of an f32 (m,)/(m, G) vector (1 for (m,))."""
    if v.dim() not in (1, 2) or (v.dim() == 2 and v.shape[1] < 1):
        raise ValueError(f"{what}: expected (m,) or (m, G) with G >= 1, got "
                         f"{tuple(v.shape)}")
    _check(v, torch.float32, v.shape, v.device, what)
    return int(v.shape[1]) if v.dim() == 2 else 1


def _check_buckets(idx, vals, device, what: str) -> bool:
    """Whether the buckets' values are bf16 (all one dtype)."""
    if not vals:
        return False
    dtype = vals[0].dtype
    if dtype not in _VALUE_DTYPES:
        raise ValueError(f"{what} values must be f32 or bf16, got {dtype}")
    for b, (i, v) in enumerate(zip(idx, vals)):
        _check(i, torch.int32, i.shape, device, f"{what} ids[{b}]")
        _check(v, dtype, i.shape, device, f"{what} values[{b}]")
    return dtype == torch.bfloat16


def _check_tail(X, w):
    lanes = _check_vector(w, "w")
    if int(w.shape[0]) != X.n_features:
        raise ValueError(f"w has {w.shape[0]} rows, the layout "
                         f"{X.n_features} features")
    bf16 = _check_buckets(X.ell_pcols, X.ell_vals, w.device, "ELL")
    return w[X.d_sel:X.n_prefix], lanes, bf16


def _check_rmatvec(X, r):
    lanes = _check_vector(r, "r")
    if int(r.shape[0]) != int(X.shape[0]):
        raise ValueError(f"r has {r.shape[0]} rows, the layout "
                         f"{X.shape[0]}")
    bf16 = _check_buckets(X.bucket_rows, X.bucket_vals, r.device,
                          "occurrence-bucket")
    # the kernel reads 4 slots at a time from widths that are multiples of
    # 4: 16 B of row ids and 8 B (bf16) or 16 B (f32) of values
    for b, (i, v) in enumerate(zip(X.bucket_rows, X.bucket_vals)):
        if int(i.shape[1]) % 4 == 0 and (
                i.data_ptr() % 16 or v.data_ptr() % (8 if bf16 else 16)):
            raise ValueError(f"occurrence bucket {b}: ids and values must "
                             "start 16-byte aligned (8 for bf16 values)")
    return lanes, bf16


def _rmatvec_out(X, r, out) -> torch.Tensor:
    """``out`` checked as the (U,)/(U, G) f32 block, or a new one."""
    shape = (X.n_prefix - X.d_sel,) + tuple(r.shape[1:])
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=r.device)
    _check(out, torch.float32, shape, r.device, "out")
    return out


def _plain_into(res: torch.Tensor, out) -> torch.Tensor:
    """A plain version's result, copied into ``out`` when one is given."""
    if out is None:
        return res
    return out.copy_(res)


def _descriptors(idx, vals, device) -> torch.Tensor:
    """The (nb, 5) int64 device array of Bucket descriptors for these
    buckets, bases cumulative from 0 in bucket order."""
    rows, base = [], 0
    for i, v in zip(idx, vals):
        r_b, width = (int(s) for s in i.shape)
        rows.append((i.data_ptr(), v.data_ptr(), r_b, width, base))
        base += r_b
    key = (device, tuple(rows))
    with _desc_lock:
        desc = _DESC_CACHE.get(key)
        if desc is None:
            if len(_DESC_CACHE) >= _DESC_CACHE_MAX:
                _DESC_CACHE.clear()
            desc = torch.tensor(rows, dtype=torch.int64).to(device)
            _DESC_CACHE[key] = desc
    return desc


def _plan(vals, device):
    """(the `rmatvec_plan` of these buckets' shapes as an (items, 4) int32
    device array, each bucket's `plan_ranges`), built and uploaded once
    per list of shapes."""
    shapes = tuple(tuple(int(s) for s in v.shape) for v in vals)
    key = ("plan", device, shapes)
    with _desc_lock:
        hit = _DESC_CACHE.get(key)
        if hit is None:
            if len(_DESC_CACHE) >= _DESC_CACHE_MAX:
                _DESC_CACHE.clear()
            items = rmatvec_plan(shapes)
            hit = (torch.from_numpy(items).to(device),
                   plan_ranges(items, len(shapes)))
            _DESC_CACHE[key] = hit
    return hit


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what} launch failed: "
                           f"{library().photon_bell_error_string(code)}")


def _launch_tail(name, desc_ptr, nb, row_pos_ptr, wt, lanes, n_rows, bf16,
                 out):
    lib = library()
    with torch.cuda.device(out.device):
        code = lib.photon_bell_tail_matvec(
            desc_ptr, nb, row_pos_ptr, wt.data_ptr(), lanes, n_rows,
            int(bf16), out.data_ptr(), _stream(out.device))
    _raise_on(code, name)


def _launch_rmatvec(name, desc_ptr, plan_ptr, n_items, r, lanes, bf16,
                    square, out):
    lib = library()
    with torch.cuda.device(out.device):
        code = lib.photon_bell_bucket_rmatvec(
            desc_ptr, plan_ptr, n_items, r.data_ptr(), lanes, int(bf16),
            int(bool(square)), out.data_ptr(), _stream(out.device))
    _raise_on(code, name)
