"""The blocked-ELL X passes as hand-written CUDA kernels (port of the four
Pallas kernels of `photon_tpu/kernels/blocked_ell.py`).

Four wrappers, two kernel bodies in `csrc/blocked_ell.cu`, each body run
over a work plan of one-block items:

- `tail_matvec` (fused): ONE launch over every item of the tail plan
  (`tail_plan`: consecutive rows of one width bucket per block) adds the
  (n,)/(n, G) f32 tail term into its output in original row order, each
  row through the inverse map ``tail_rows``;
- `tail_matvec_tiled`: one launch per width bucket over that bucket's
  items, into the same output, the items cut at the bucket's tile;
- `bucket_rmatvec` (fused): ONE launch over every item of the rmatvec
  plan (`rmatvec_plan`) writes the (U,)/(U, G) tail-gradient block in
  prefix order; ``square`` gives (X∘X)ᵀr; ``round_r=False`` multiplies
  the cotangent unrounded (the `PermutedHybridRows` recipe, whose
  occurrence buckets are laid as the blocked-ELL ones);
- `bucket_rmatvec_tiled`: one launch per occurrence bucket over that
  bucket's items, each writing its slice of one output, the items cut at
  the bucket's tile.

THE TILE (the reference's row tile ``T`` of its grid-tiled forms): a
work item holds at most T rows of a width bucket (tail) or T columns of
an occurrence bucket (rmatvec), T clamped to what one block takes
(`max_tile`: BLOCK·`rows_per_thread`(W_b) rows, BLOCK // tpc columns).
The tiled forms resolve T per (kind, width) on every call
(`resolve_tiles`: the ``PHOTON_TPU_TORCH_KERNELS_TILE`` pin, else the
autotuner's winner for the card, `tuning.tile_tuner.tile_for`, else
`DEFAULT_TILE`, which clamps to today's whole-block items); the fused
forms always run the whole-block items. A row or a column is summed by
the same threads in the same order whatever item holds it, so every tile
gives the same bits.

`layout_plan` checks a layout's buckets, packs their descriptors and
builds both work plans and ``tail_rows`` once per layout object and tile
set (a
`BlockedEllRows` is frozen and its tensors are never replaced; a layout
with no ELL tail, a `PermutedHybridRows`, gets the rmatvec's plan alone),
so a call
checks only its vector and its output, then makes one ctypes call, in
which the C entry point makes all of the form's launches. The work plans
depend on the bucket shapes alone and are shared by every layout of the
same shapes (every chunk of a chunk ladder). A streamed solve reuses a
few device layouts whose buffers each chunk overwrites in place (the
upload ring's slots, `data.dataset.DeviceChunkRing`), so it builds one
plan per slot, not one per chunk visit; `plan_builds` counts the builds.

The tail matvec ADDS into ``out=`` — an (n,)/(n, G) f32 tensor, the
caller's hot-block product — and leaves rows with no tail as they are;
without it, into a zero-filled new output, so it returns the tail term
alone. The rmatvec WRITES into ``out=``, a preallocated (U,)/(U, G) f32
view (the caller's slice of the full (d,)/(d, G) gradient), or into a new
output. The caller (`data.matrix`) picks the form with `kernels.route`.

`tail_matvec_reference` and `bucket_rmatvec_reference` are the plain
PyTorch versions of the same functions (gather, f32 upcast, product, sum;
the same bf16 rounding points): the CPU runs them (added or copied into
``out``), the tests hold them against the JAX package, and
``chip_smoke.py`` holds every kernel against them on the card.

Each wrapper checks its operands, then on a CUDA tensor launches its
kernel (counting the launch in `kernels.count_launch`) or raises; it takes
the plain version only for CPU tensors (or under ``scope("off")``).
Operand contract: w / r f32 contiguous, (d,)/(d, G) or (n,)/(n, G), on the
layout's device; every index matrix int32 and the value matrices of each
kind f32 or bf16 (one dtype per kind), contiguous, on that device; every
ELL width a power of two; a bucket whose kernel reads 2 or 4 slots at once
starts aligned to that many ids and values, as the caching allocator
gives it. Index ranges are what `data.matrix.to_blocked_ell` guarantees:
ell_pcols in [0, U), row_pos in [0, B] with each position below B taken
by at most one row, bucket_rows in [0, n). A layout whose positions are
not all taken (a chunk of a ladder, `data.matrix.shard_blocked_ell`:
each width bucket is padded to the largest count over the chunks)
carries its inverse map ``tail_rows`` with -1 at the free positions,
which the tail kernel skips; otherwise the plan derives it from
``row_pos``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
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
# WorkItem (the rmatvec's plan) and TailItem (the tail matvec's) in
# csrc/blocked_ell.cu: one int32 per field, in these orders
_PLAN_FIELDS = ("bucket", "col0", "cols", "tpc")
_TAIL_FIELDS = ("bucket", "row0", "rows")
_VALUE_DTYPES = (torch.float32, torch.bfloat16)
# kThreads in the source (one block per item of either plan, the most
# threads one rmatvec column gets), the slots one rmatvec thread walks, the
# slots one tail thread holds (kTailSlotsPerThread) and the most ELL width
# buckets a layout may have (kMaxTailBuckets)
BLOCK = 256
SLOTS_PER_THREAD = 8
TAIL_SLOTS_PER_THREAD = 4
MAX_TAIL_BUCKETS = 32

_lib = None
_lib_lock = threading.Lock()
# each layout's LayoutPlan by id(layout), beside a weak reference to the
# layout that tells its entry from that of a dead layout with the same id;
# the shape-only parts of a plan by (bucket shapes, device); and the count
# of plans built
_plans_lock = threading.Lock()
_PLANS: dict = {}
_SHAPE_PLANS: dict = {}
_PLAN_BUILDS = 0


def library() -> ctypes.CDLL:
    """The built kernel library (built on first call; raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = K.load_library(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            ranges = ctypes.POINTER(ctypes.c_int)
            lib.photon_bell_tail_matvec.argtypes = [
                p, i, p, p, i, ranges, i, p, i, p, ctypes.c_longlong, p]
            lib.photon_bell_tail_matvec.restype = i
            lib.photon_bell_bucket_rmatvec.argtypes = [p, p, i, ranges, i, p,
                                                       i, i, i, p, p]
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


def bucket_rmatvec_reference(X, r: torch.Tensor, square: bool = False,
                             round_r: bool = True) -> torch.Tensor:
    """The plain occurrence-bucket rmatvec: per bucket gather ``r`` at the
    row ids and dot with the values in f32 (values squared in f32 and r
    not rounded for ``square``; r not rounded either without
    ``round_r``), concatenated in prefix order."""
    parts = []
    for br, bv in zip(X.bucket_rows, X.bucket_vals):
        g = _gather(r, br)
        if square:
            v = bv.float()
            v, g = v * v, g.float()
        elif round_r:
            v, g = _compute(bv, g)
        else:
            v, g = bv.float(), g.float()
        parts.append(_rowdot(v, g))
    if not parts:
        return torch.zeros((0,) + tuple(r.shape[1:]), dtype=torch.float32,
                           device=r.device)
    return torch.cat(parts, dim=0)


# ------------------------------------------------------------- work plans
def rows_per_thread(w_b: int) -> int:
    """The rows one thread of the tail kernel takes in a bucket of width
    w_b: TAIL_SLOTS_PER_THREAD / w_b, at least 1 (``rows_per_thread`` in
    the source)."""
    return max(1, TAIL_SLOTS_PER_THREAD // int(w_b))


def max_tile(kind: str, width: int) -> int:
    """The most rows (``kind`` `TAIL`, width W_b) or columns (`RMATVEC`,
    k_b slots) one work item takes: one block's worth,
    BLOCK·`rows_per_thread`(W_b) or BLOCK // `threads_per_column`(k_b)."""
    if kind == TAIL:
        return BLOCK * rows_per_thread(width)
    return BLOCK // threads_per_column(width)


def clamp_tile(kind: str, width: int, tile: int) -> int:
    """``tile`` clamped to `max_tile` (the port's counterpart of the
    reference's `_clamp_tile`, which halves its row tile to fit VMEM)."""
    return min(int(tile), max_tile(kind, width))


def tail_plan(bucket_shapes, tiles=None) -> np.ndarray:
    """The tail matvec's work plan for ELL width buckets of (r_b, W_b)
    shapes: an (items, 3) int32 array of (bucket, row0, rows) rows, fields
    as `_TAIL_FIELDS`. Each item is at most one block's worth of one
    bucket's rows: ``rows`` ≤ BLOCK·`rows_per_thread`(W_b) — or ≤ the
    bucket's tile, ``tiles[b]`` clamped by `clamp_tile` — rows from
    ``row0`` on, thread t taking rows t, t + BLOCK, .... Items run widest
    bucket first (the longest rows start first, the short ones fill in
    behind), then in bucket order; one bucket's items are contiguous, in
    row order."""
    parts = []
    for b, (r_b, w_b) in enumerate(bucket_shapes):
        per = (max_tile(TAIL, w_b) if tiles is None
               else clamp_tile(TAIL, w_b, tiles[b]))
        row0 = np.arange(0, int(r_b), per, dtype=np.int64)
        item = np.empty((row0.size, len(_TAIL_FIELDS)), np.int32)
        item[:, 0], item[:, 1] = b, row0
        item[:, 2] = np.minimum(per, int(r_b) - row0)
        parts.append(((-int(w_b), b), item))
    parts.sort(key=lambda kv: kv[0])
    if not parts:
        return np.zeros((0, len(_TAIL_FIELDS)), np.int32)
    return np.concatenate([item for _, item in parts])


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


def rmatvec_plan(bucket_shapes, tiles=None) -> np.ndarray:
    """The rmatvec's work plan for occurrence buckets of (c_b, k_b) shapes:
    an (items, 4) int32 array of (bucket, col0, cols, tpc) rows, fields as
    `_PLAN_FIELDS`. Each item is at most one block's worth of one bucket's
    columns: ``cols`` columns from ``col0`` on (at most the bucket's tile,
    ``tiles[b]`` clamped by `clamp_tile`, when given), each summed by
    ``tpc`` = `threads_per_column` threads, cols·tpc ≤ BLOCK. Items run
    longest walk first (then wider buckets first, then bucket and column
    order), so the long columns start first and the short ones fill in
    behind; one bucket's items are contiguous, in column order."""
    parts = []
    for b, (c_b, k_b) in enumerate(bucket_shapes):
        tpc = threads_per_column(int(k_b))
        per = (max_tile(RMATVEC, int(k_b)) if tiles is None
               else clamp_tile(RMATVEC, int(k_b), tiles[b]))
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
    """Each bucket's (first, end) rows of ``plan`` (either plan: the bucket
    is its first field): the items one launch of the tiled form runs."""
    out = []
    for b in range(n_buckets):
        rows = np.flatnonzero(plan[:, 0] == b)
        out.append((int(rows[0]), int(rows[-1]) + 1) if rows.size else (0, 0))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class LayoutPlan:
    """What the kernels need of one layout, checked and put on its device
    once (`layout_plan`). Per kind of bucket — ``tail`` the ELL width
    buckets, ``occ`` the occurrence buckets — the (nb, 5) int64 Bucket
    descriptors (bases cumulative from 0 in
    bucket order), the work plan as an (items, fields) int32 array on the
    device and the launches of each form over it as the C entry point
    takes them (``*_fused``: every item, ``*_tiled``: each bucket's
    `plan_ranges`; both `_host_ranges`; shared by layouts of the same
    shapes); ``tail_rows``, the (B,) int32 original row of each position
    of the width buckets' concatenation (the layout's own ``tail_rows``
    when it carries one, -1 at a position no row takes; else
    ``argsort(row_pos)[:B]``); and the leading arguments of each C entry
    point (``*_args``: the addresses of those tensors, the tail's bucket
    count, last whether the values are bf16), as ctypes objects that a
    call passes without converting them; the plan keeps the tensors
    alive."""

    device: torch.device
    n_features: int
    d_sel: int
    tail_desc: torch.Tensor
    tail_items: torch.Tensor
    tail_fused: tuple
    tail_tiled: tuple
    tail_rows: torch.Tensor
    occ_desc: torch.Tensor
    occ_items: torch.Tensor
    occ_fused: tuple
    occ_tiled: tuple
    tail_args: tuple
    occ_args: tuple


def layout_plan(X, tiles=None) -> LayoutPlan:
    """``X``'s `LayoutPlan`: built on the first call for this layout object
    (and tile set) and kept until the layout is collected. ``tiles``:
    None for the whole-block items, or (tail tiles, occurrence tiles),
    each a per-bucket tuple as `resolve_tiles` gives it or None for
    whole-block items. Raises if a bucket is not what the kernels
    take."""
    global _PLAN_BUILDS
    if tiles == (None, None):
        tiles = None
    key = id(X) if tiles is None else (id(X), tiles)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is X:
        return hit[1]
    base = None if tiles is None else layout_plan(X)
    with _plans_lock:
        hit = _PLANS.get(key)
        if hit is not None and hit[0]() is X:
            return hit[1]
        plan = _build_plan(X) if base is None else _tiled_plan(X, base,
                                                                tiles)
        _PLAN_BUILDS += 1
        _PLANS[key] = (weakref.ref(X), plan)
        weakref.finalize(X, _PLANS.pop, key, None)
    return plan


def resolve_tiles(kind: str, widths, device) -> tuple | None:
    """The tiled form's tile for each bucket of these widths on
    ``device``: the ``PHOTON_TPU_TORCH_KERNELS_TILE`` pin, else the
    autotuner's winner for (the card, kind, width), else `DEFAULT_TILE`
    (`tuning.tile_tuner.tiles_for`); clamped by `clamp_tile`. None when
    every bucket takes its whole-block items (the fused forms' plan) —
    in an untuned process after one environment read."""
    from photon_tpu_torch.tuning.tile_tuner import tiles_for

    pin = K.tile_override()
    if pin is not None:
        raw = (pin,) * len(widths)
    else:
        raw = tiles_for(kind, widths, device)
        if raw is None:  # untuned: DEFAULT_TILE clamps to whole blocks
            return None
    tiles = tuple(clamp_tile(kind, w, t) for w, t in zip(widths, raw))
    if all(t == max_tile(kind, w) for t, w in zip(tiles, widths)):
        return None
    return tiles


def plan_builds() -> int:
    """How many layout plans this process has built."""
    with _plans_lock:
        return _PLAN_BUILDS


def _shape_plan(tail_shapes, occ_shapes, device, tiles) -> tuple:
    """The parts of a plan that depend on the bucket shapes (and tiles)
    alone: both work plans on ``device`` and their fused and tiled ranges,
    built once per (shapes, tiles, device) (called under
    ``_plans_lock``)."""
    key = (tuple(tail_shapes), tuple(occ_shapes), tiles, str(device))
    hit = _SHAPE_PLANS.get(key)
    if hit is None:
        tail_items = tail_plan(tail_shapes, tiles[0])
        occ_items = rmatvec_plan(occ_shapes, tiles[1])
        hit = (torch.from_numpy(tail_items).to(device),
               _host_ranges([(0, int(tail_items.shape[0]))]),
               _host_ranges(plan_ranges(tail_items, len(tail_shapes))),
               torch.from_numpy(occ_items).to(device),
               _host_ranges([(0, int(occ_items.shape[0]))]),
               _host_ranges(plan_ranges(occ_items, len(occ_shapes))))
        _SHAPE_PLANS[key] = hit
    return hit


def _tiled_plan(X, base: LayoutPlan, tiles) -> LayoutPlan:
    """``base`` (``X``'s whole-block plan) with its work plans cut at
    ``tiles``: the descriptors and the inverse map are shared, only the
    items and their ranges are new (called under ``_plans_lock``)."""
    tail_shapes = [tuple(int(s) for s in v.shape)
                   for v in getattr(X, "ell_vals", ())]
    occ_shapes = [tuple(int(s) for s in v.shape) for v in X.bucket_vals]
    (tail_dev, tail_fused, tail_tiled, occ_dev, occ_fused,
     occ_tiled) = _shape_plan(tail_shapes, occ_shapes, base.device, tiles)
    desc, nb, _, rows, bf16 = base.tail_args
    occ_desc, _, occ_bf16 = base.occ_args
    return dataclasses.replace(
        base, tail_items=tail_dev, tail_fused=tail_fused,
        tail_tiled=tail_tiled, occ_items=occ_dev, occ_fused=occ_fused,
        occ_tiled=occ_tiled,
        tail_args=(desc, nb, ctypes.c_void_p(tail_dev.data_ptr()), rows,
                   bf16),
        occ_args=(occ_desc, ctypes.c_void_p(occ_dev.data_ptr()), occ_bf16))


def _build_plan(X) -> LayoutPlan:
    # a layout without an ELL tail (a PermutedHybridRows) gets the
    # occurrence-bucket plan alone: no width bucket, no inverse map
    ell = hasattr(X, "row_pos")
    ell_pcols, ell_vals = (X.ell_pcols, X.ell_vals) if ell else ((), ())
    device = X.row_pos.device if ell else X.dense.device
    if ell:
        _check(X.row_pos, torch.int32, (int(X.shape[0]),), device,
               "row_pos")
    tail_bf16 = _check_buckets(ell_pcols, ell_vals, device, "ELL")
    occ_bf16 = _check_buckets(X.bucket_rows, X.bucket_vals, device,
                              "occurrence-bucket")
    tail_shapes = [tuple(int(s) for s in v.shape) for v in ell_vals]
    occ_shapes = [tuple(int(s) for s in v.shape) for v in X.bucket_vals]
    if len(tail_shapes) > MAX_TAIL_BUCKETS:
        raise ValueError(f"{len(tail_shapes)} ELL width buckets; the tail "
                         f"kernel takes at most {MAX_TAIL_BUCKETS}")
    # the tail kernel reads a row's min(W_b, 4)-slot groups at once, the
    # rmatvec 4 slots at a time from widths that are multiples of 4
    for b, (_, w_b) in enumerate(tail_shapes):
        if w_b & (w_b - 1):
            raise ValueError(f"ELL width bucket {b}: width {w_b} is not a "
                             "power of two")
        _check_aligned(ell_pcols[b], ell_vals[b], min(w_b, 4),
                       f"ELL width bucket {b}")
    for b, (_, k_b) in enumerate(occ_shapes):
        if k_b % 4 == 0:
            _check_aligned(X.bucket_rows[b], X.bucket_vals[b], 4,
                           f"occurrence bucket {b}")
    B = sum(r_b for r_b, _ in tail_shapes)
    (tail_dev, tail_fused, tail_tiled, occ_dev, occ_fused,
     occ_tiled) = _shape_plan(tail_shapes, occ_shapes, device,
                              (None, None))
    tail_desc = _descriptors(ell_pcols, ell_vals, device)
    occ_desc = _descriptors(X.bucket_rows, X.bucket_vals, device)
    if not ell:
        tail_rows = torch.zeros(0, dtype=torch.int32, device=device)
    elif X.tail_rows is not None:
        _check(X.tail_rows, torch.int32, (B,), device, "tail_rows")
        tail_rows = X.tail_rows
    else:
        tail_rows = torch.argsort(X.row_pos, stable=True)[:B].to(torch.int32)
    return LayoutPlan(
        device=device, n_features=X.n_features, d_sel=X.d_sel,
        tail_desc=tail_desc, tail_items=tail_dev, tail_fused=tail_fused,
        tail_tiled=tail_tiled, tail_rows=tail_rows,
        occ_desc=occ_desc, occ_items=occ_dev, occ_fused=occ_fused,
        occ_tiled=occ_tiled,
        tail_args=(ctypes.c_void_p(tail_desc.data_ptr()),
                   ctypes.c_int(len(tail_shapes)),
                   ctypes.c_void_p(tail_dev.data_ptr()),
                   ctypes.c_void_p(tail_rows.data_ptr()),
                   ctypes.c_int(int(tail_bf16))),
        occ_args=(ctypes.c_void_p(occ_desc.data_ptr()),
                  ctypes.c_void_p(occ_dev.data_ptr()),
                  ctypes.c_int(int(occ_bf16))))


def _host_ranges(ranges) -> tuple:
    """(the (first, end) item ranges flattened into a ctypes int array,
    their count as a ctypes int, the launches they make: one per non-empty
    range)."""
    flat = [int(x) for r in ranges for x in r]
    return ((ctypes.c_int * len(flat))(*flat), ctypes.c_int(len(ranges)),
            sum(hi > lo for lo, hi in ranges))


# ---------------------------------------------------------------- wrappers
def tail_matvec(X, w: torch.Tensor, out=None) -> torch.Tensor:
    """The fused tail matvec: ``out`` plus the (n,)/(n, G) f32 tail term in
    original row order (``out`` zero-filled and new when not given), one
    launch. ``w`` is the full permuted (d,)/(d, G) vector."""
    if not K.use_kernel(w):
        return _plain_add(tail_matvec_reference(X, w), X, w, out)
    plan, lanes = _check_tail(X, w)
    out, zero_bytes = _tail_out(X, w, out)
    _launch_tail(TAIL, plan, plan.tail_fused, w, lanes, out, zero_bytes)
    return out


def tail_matvec_tiled(X, w: torch.Tensor, out=None) -> torch.Tensor:
    """The tiled tail matvec: one launch per width bucket over that
    bucket's items of the plan, cut at the bucket's tile
    (`resolve_tiles`), each adding its rows into the same output. The
    same per-row arithmetic as `tail_matvec`, so the same bits at every
    tile."""
    if not K.use_kernel(w):
        return _plain_add(tail_matvec_reference(X, w), X, w, out)
    tiles = resolve_tiles(TAIL, [int(v.shape[-1]) for v in X.ell_vals],
                          w.device)
    plan, lanes = _check_tail(X, w, (tiles, None))
    out, zero_bytes = _tail_out(X, w, out)
    _launch_tail(TAIL_TILED, plan, plan.tail_tiled, w, lanes, out,
                 zero_bytes)
    return out


def bucket_rmatvec(X, r: torch.Tensor, square: bool = False, out=None,
                   round_r: bool = True) -> torch.Tensor:
    """The fused occurrence-bucket rmatvec: the (U,)/(U, G) f32 tail
    gradient block in prefix order (written into ``out`` when given), one
    launch over every item of the layout's work plan. ``round_r`` rounds
    each gathered cotangent to the storage dtype (the blocked-ELL
    recipe); without it the cotangent multiplies unrounded (the permuted
    hybrid's)."""
    if not K.use_kernel(r):
        return _plain_into(bucket_rmatvec_reference(X, r, square, round_r),
                           X, r, out)
    plan, lanes = _check_rmatvec(X, r)
    out = _rmatvec_out(X, r, out)
    _launch_rmatvec(RMATVEC, plan, plan.occ_fused, r, lanes, square, out,
                    round_r)
    return out


def bucket_rmatvec_tiled(X, r: torch.Tensor, square: bool = False,
                         out=None, round_r: bool = True) -> torch.Tensor:
    """The tiled occurrence-bucket rmatvec: one launch per bucket over that
    bucket's items of the plan, cut at the bucket's tile
    (`resolve_tiles`), each into its slice of one output. Each column is
    summed as in `bucket_rmatvec`, so the same bits at every tile."""
    if not K.use_kernel(r):
        return _plain_into(bucket_rmatvec_reference(X, r, square, round_r),
                           X, r, out)
    tiles = resolve_tiles(RMATVEC,
                          [int(v.shape[-1]) for v in X.bucket_vals],
                          r.device)
    plan, lanes = _check_rmatvec(X, r, (None, tiles))
    out = _rmatvec_out(X, r, out)
    _launch_rmatvec(RMATVEC_TILED, plan, plan.occ_tiled, r, lanes, square,
                    out, round_r)
    return out


# ----------------------------------------------------------------- helpers
def _check(t, dtype, shape, device, what: str) -> None:
    if isinstance(t, torch.Tensor) and t.dtype == dtype \
            and t.shape == shape and t.device == device \
            and t.is_contiguous():
        return
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


def _check_vector(v, device, what: str) -> int:
    """The lane count of an f32 (m,)/(m, G) vector on ``device`` (1 for
    (m,))."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32 \
            and v.device == device and v.is_contiguous():
        if v.dim() == 1:
            return 1
        if v.dim() == 2 and v.shape[1] >= 1:
            return v.shape[1]
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(v)}")
    if v.dim() not in (1, 2) or (v.dim() == 2 and v.shape[1] < 1):
        raise ValueError(f"{what}: expected (m,) or (m, G) with G >= 1, got "
                         f"{tuple(v.shape)}")
    _check(v, torch.float32, v.shape, device, what)
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


def _check_aligned(i, v, slots: int, what: str) -> None:
    """Refuse a bucket whose kernel reads ``slots`` ids and values at once
    from a start that is not aligned to that many of each."""
    ai, av = 4 * slots, v.element_size() * slots
    if i.data_ptr() % ai or v.data_ptr() % av:
        raise ValueError(f"{what}: ids must start {ai}-byte aligned and "
                         f"values {av}-byte aligned")


def _check_tail(X, w, tiles=None):
    """(``X``'s plan at ``tiles``, the lane count) for a tail matvec of
    ``w``."""
    plan = layout_plan(X, tiles)
    lanes = _check_vector(w, plan.device, "w")
    if w.shape[0] != plan.n_features:
        raise ValueError(f"w has {w.shape[0]} rows, the layout "
                         f"{plan.n_features} features")
    return plan, lanes


def _check_rmatvec(X, r, tiles=None):
    """(``X``'s plan at ``tiles``, the lane count) for an rmatvec of
    ``r``."""
    plan = layout_plan(X, tiles)
    lanes = _check_vector(r, plan.device, "r")
    if r.shape[0] != X.shape[0]:
        raise ValueError(f"r has {r.shape[0]} rows, the layout "
                         f"{X.shape[0]}")
    return plan, lanes


def _tail_out(X, w, out):
    """(``out`` checked as the (n,)/(n, G) f32 output, 0), or (a new one,
    its bytes: the C entry point zero-fills them before the kernel adds
    into it)."""
    shape = (int(X.shape[0]),) + tuple(w.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=w.device)
        return out, 4 * out.numel()
    _check(out, torch.float32, shape, w.device, "out")
    return out, 0


def _rmatvec_out(X, r, out) -> torch.Tensor:
    """``out`` checked as the (U,)/(U, G) f32 block, or a new one."""
    shape = (X.n_prefix - X.d_sel,) + tuple(r.shape[1:])
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=r.device)
    _check(out, torch.float32, shape, r.device, "out")
    return out


def _plain_add(tail: torch.Tensor, X, w, out) -> torch.Tensor:
    """The plain tail term, added into ``out`` when one is given."""
    if out is None:
        return tail
    return _tail_out(X, w, out)[0].add_(tail)


def _plain_into(res: torch.Tensor, X, r, out) -> torch.Tensor:
    """The plain rmatvec block, copied into ``out`` when one is given."""
    if out is None:
        return res
    return _rmatvec_out(X, r, out).copy_(res)


def _descriptors(idx, vals, device) -> torch.Tensor:
    """The (nb, 5) int64 array of Bucket descriptors for these buckets on
    ``device``, bases cumulative from 0 in bucket order."""
    rows, base = [], 0
    for i, v in zip(idx, vals):
        r_b, width = (int(s) for s in i.shape)
        rows.append((i.data_ptr(), v.data_ptr(), r_b, width, base))
        base += r_b
    return torch.tensor(rows, dtype=torch.int64).reshape(
        len(rows), len(_DESC_FIELDS)).to(device)


def _launch(name: str, entry: str, n_launches: int, out, *args) -> None:
    """One call of the C entry point ``entry`` with ``args`` and the current
    stream of ``out``'s device, making ``n_launches`` launches; counts them,
    and raises if one fails."""
    fn = getattr(_lib if _lib is not None else library(), entry)
    code = K.launch(fn, out.get_device(), *args)
    if code:
        raise RuntimeError(f"{name} launch failed: "
                           f"{library().photon_bell_error_string(code)}")
    if n_launches:
        K.count_launch(name, n_launches, out)


def _launch_tail(name, plan, ranges, w, lanes, out, zero_bytes) -> None:
    """The tail kernel over ``ranges`` (a `_host_ranges` tuple) of the tail
    plan, after zeroing the first ``zero_bytes`` of ``out``; it gathers
    from the tail slice w[d_sel:n_prefix], passed by its address."""
    flat, n_ranges, n_launches = ranges
    _launch(name, "photon_bell_tail_matvec", n_launches, out,
            *plan.tail_args, flat, n_ranges,
            w.data_ptr() + plan.d_sel * lanes * 4, lanes, out.data_ptr(),
            zero_bytes)


def _launch_rmatvec(name, plan, ranges, r, lanes, square, out,
                    round_r) -> None:
    """The rmatvec kernel over ``ranges`` (a `_host_ranges` tuple) of the
    rmatvec plan."""
    flat, n_ranges, n_launches = ranges
    _launch(name, "photon_bell_bucket_rmatvec", n_launches, out,
            *plan.occ_args, flat, n_ranges, r.data_ptr(), lanes,
            int(bool(square)), int(bool(round_r)), out.data_ptr())


# ----------------------------------------------------------------- contracts
# The kernel-side pins of the blocked-ELL law: on the card both X passes
# launch the hand-written kernels (fused and tiled forms) with no host
# sync and no combining scatter, write f32, and build the layout's plan
# once — a second call on the same layout builds none.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import SCATTER_PRIMITIVES  # noqa: E402


def _contract_layout(device, bf16: bool = True):
    from photon_tpu_torch.data.matrix import (_contract_blocked_ell,
                                              _contract_vectors)

    X = _contract_blocked_ell(device, bf16=bf16)
    w, r = _contract_vectors(X, device)
    return X, X.from_model_space(w), r


@register_contract(
    name="blocked_ell_kernel_x_passes",
    description="BlockedEllRows matvec + rmatvec with the hand-written "
                "kernels dispatched (rows 2 and 4 on the card): ZERO host "
                "syncs, no combining scatter, f32 kernel outputs, bf16 "
                "products accumulating f32",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("kernels", "sparse", "resident"))
def _contract_kernel_x_passes(device):
    from photon_tpu_torch.data import matrix as M

    X, w, r = _contract_layout(device)
    mode = K.device_mode(device)

    def both(Xb, wv, rv):
        with K.scope(mode):
            z = M.matvec(Xb, wv)
            return z, M.rmatvec(Xb, rv * z)

    return both, (X, w, r)


@register_contract(
    name="blocked_ell_kernel_no_retrace",
    description="the kernel dispatch seam is signature-invariant: the "
                "same layout dispatched kernels-on and kernels-off "
                "records IDENTICAL call signatures (the builder replays "
                "both modes through the signature log and raises on "
                "divergence), and a second call on the layout builds no "
                "plan",
    collectives={}, tags=("kernels", "sparse"))
def _contract_kernel_no_retrace(device):
    from photon_tpu_torch.analysis.rules import TraceSignatureLog
    from photon_tpu_torch.data import matrix as M

    X, w, r = _contract_layout(device, bf16=False)
    log = TraceSignatureLog()
    cuda = torch.device(device).type == "cuda"
    for m in (("off", "on", "off") if cuda else ("off", "auto", "off")):
        with K.scope(m):
            log.record("dispatch.matvec", (X, w))
            log.record("dispatch.rmatvec", (X, r))
    for name in ("dispatch.matvec", "dispatch.rmatvec"):
        if len(log.signatures(name)) != 1:
            raise AssertionError(
                f"kernel dispatch seam drifted: "
                f"{len(log.signatures(name))} distinct {name} signatures "
                "across mode flips (expected 1)")
    mode = K.device_mode(device)

    def passes(Xb, wv, rv):
        with K.scope(mode):
            return M.matvec(Xb, wv), M.rmatvec(Xb, rv)

    return passes, (X, w, r)


@register_contract(
    name="blocked_ell_tiled_x_passes",
    description="the tiled forms (rows 3 and 5 on the card): one launch "
                "per width bucket / occurrence bucket, the SAME law as "
                "the fused forms — ZERO host syncs, no combining scatter, "
                "f32 kernel outputs",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("kernels", "sparse", "streamed"))
def _contract_tiled_x_passes(device):
    X, w, r = _contract_layout(device)
    mode = K.device_mode(device)

    def both(Xb, wv, rv):
        with K.scope(mode):
            z = tail_matvec_tiled(Xb, wv)
            return z, bucket_rmatvec_tiled(Xb, rv)

    return both, (X, w, r)
