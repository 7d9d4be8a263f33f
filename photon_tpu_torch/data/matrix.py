"""Design-matrix representations (port of the serving and blocked-ELL parts
of `photon_tpu/data/matrix.py`).

- dense: a plain (n, d) tensor;
- `SparseRows`: padded per-row COO — (n, k) int32 indices + (n, k) f32
  values, rows padded to k slots with (index 0, value 0);
- `BlockedEllRows`: the hot columns as a dense (n, d_sel) block, the cold
  tail as power-of-two-width ELL row buckets (matvec) and occurrence
  buckets (rmatvec), in a permuted column space;
- `ShardedBlockedEllRows`: the same laid for S row shards under one
  global permutation, on the host — what a streamed chunk ladder is cut
  from (`shard_blocked_ell`, one `BlockedEllRows` chunk per shard);
- `HybridRows`: the hot columns dense, the cold tail flat row-sorted COO
  in original column ids; `PermutedHybridRows`: the hot block plus a flat
  row-major tail (matvec) and the occurrence buckets (rmatvec) in the
  permuted space of `BlockedEllRows`; `ShardedHybridRows` and
  `ShardedPermutedHybridRows`: both laid for S row shards on the host,
  reaching a mesh one shard per slot (`local`);
- `EntityBlocks`: a random effect's bucket of E entities' padded rows,
  lane-minor, whose lane passes multiply each lane by its own rows.

The host builders (`to_blocked_ell`, `shard_blocked_ell`, `to_hybrid`,
`to_permuted_hybrid`, `shard_hybrid`, `shard_permuted_hybrid`,
`quantize_blocks`) stay numpy, copied from the reference, so every layout
array, int8 block and scale equals the JAX package's bit for bit; only
bf16 leaves numpy (as `torch.bfloat16`, since numpy has no bfloat16).

Every X pass returns f32. A bf16 operand is multiplied as bf16 (the
product of two bf16 values is exact in f32) and the sum accumulates in
f32, as the reference's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch.kernels import blocked_ell as KB
from photon_tpu_torch.parallel.mesh import SlotParts, SlotRows


@dataclasses.dataclass(frozen=True)
class SparseRows:
    indices: torch.Tensor  # (n, k) int32, padded with 0
    values: torch.Tensor  # (n, k) f32, padded with 0.0
    n_features: int
    # the `SegmentPlan` of its Xᵀr, built on the first one (`segment_plan`)
    plan: object = dataclasses.field(default=None, init=False,
                                     compare=False, repr=False)

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_features)

    def to(self, device, non_blocking: bool = False) -> "SparseRows":
        """The same rows as tensors on ``device`` (numpy inputs are
        wrapped first)."""
        return SparseRows(as_tensor(self.indices, device, non_blocking),
                          as_tensor(self.values, device, non_blocking),
                          self.n_features)


@dataclasses.dataclass(frozen=True)
class BlockedEllRows:
    """Blocked-ELL hybrid (reference: `photon_tpu.data.matrix.BlockedEllRows`).

    The ``d_sel`` most frequent columns form a dense (n, d_sel) block; the
    cold tail is laid twice. For matvec, rows are bucketed by tail nnz into
    power-of-two widths, each bucket a dense (r_b, W_b) pair of
    prefix-relative column ids and values; the bucket outputs concatenate
    and ``row_pos`` maps each original row into that concatenation (rows
    with no tail map to the zero slot at B = Σ r_b). For rmatvec, the U
    distinct tail columns are grouped by occurrence count into (c_b, k_b)
    pairs of original row ids and values, in prefix order.

    The solver works in the PERMUTED column space: hot columns at
    [0, d_sel), tail columns at [d_sel, n_prefix) in occurrence-bucket
    order, untouched columns after; `to_model_space` /
    `from_model_space` translate at the public boundary. Padding slots
    hold (column or row 0, value 0).

    ``tail_rows``, the inverse of ``row_pos`` over the concatenation
    ((B,) int32, -1 at a position no row takes), is given by a chunk of a
    ladder (`ShardedBlockedEllRows.chunk`), whose width buckets are padded
    to the largest count over the chunks, so some positions are free; a
    layout from `to_blocked_ell` takes every position and leaves it None
    (the kernels' plan derives it).
    """

    dense: torch.Tensor        # (n, d_sel) hot block, original row order
    ell_pcols: tuple           # per width bucket: (r_b, W_b) int32, ids
    #                            relative to d_sel (padding 0, value 0)
    ell_vals: tuple            # per width bucket: (r_b, W_b) values
    row_pos: torch.Tensor      # (n,) int32 position in the bucket concat
    bucket_rows: tuple         # per occurrence bucket: (c_b, k_b) int32 rows
    bucket_vals: tuple         # per occurrence bucket: (c_b, k_b) values
    perm_cols: torch.Tensor    # (d,) int32 original column per position
    inv_perm: torch.Tensor     # (d,) int32 position of each original column
    n_features: int
    n_prefix: int              # d_sel + U distinct tail columns
    last_col_pos: int          # permuted position of original column d - 1
    tail_nnz: int              # real (unpadded) tail nnz
    tail_rows: torch.Tensor | None = None  # (B,) int32 inverse of row_pos

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    @property
    def d_sel(self) -> int:
        return int(self.dense.shape[1])

    @property
    def ell_slots(self) -> int:
        """Total (padded) ELL slots across the width ladder."""
        return sum(int(v.shape[0]) * int(v.shape[1]) for v in self.ell_vals)

    @property
    def tail_pad_waste(self) -> float:
        """Fraction of ELL slots that are pow2 padding (0.0 = none)."""
        slots = self.ell_slots
        return (slots / self.tail_nnz - 1.0) if self.tail_nnz else 0.0

    def from_model_space(self, v: torch.Tensor) -> torch.Tensor:
        """Original-space (d,) vector (or (d, ...) stack) → permuted space."""
        return torch.index_select(v, 0, self.perm_cols)

    def to_model_space(self, w: torch.Tensor) -> torch.Tensor:
        """Permuted-space (d,) vector (or (d, ...) stack) → original space."""
        return torch.index_select(w, 0, self.inv_perm)

    def to(self, device, non_blocking: bool = False) -> "BlockedEllRows":
        """The same layout with every tensor on ``device``: this layout
        itself when they all are there already, so the kernels' plan for
        it (`kernels.blocked_ell.layout_plan`) is kept."""
        return _to_device(self, device, non_blocking)

    def _tensors(self):
        """Every tensor of the layout, in field order."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, tuple):
                yield from v

    def astype(self, dtype) -> "BlockedEllRows":
        """Every value leaf (hot block, ELL tail, occurrence buckets) in
        ``dtype`` (round to nearest even for bf16, as the reference)."""
        return dataclasses.replace(
            self, dense=self.dense.to(dtype),
            ell_vals=tuple(v.to(dtype) for v in self.ell_vals),
            bucket_vals=tuple(v.to(dtype) for v in self.bucket_vals))


def as_tensor(a, device, non_blocking: bool = False) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a tensor on ``device``. A pinned
    host tensor uploads asynchronously when ``non_blocking``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=non_blocking)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


# ------------------------------------------------------------ host builder
_SCATTER_CHUNK_ELEMS = 1 << 29  # 2 GB f32 scatter chunk, as the reference


def _dense_scatter_chunked(rows_h, pos_h, vals_h, n, d_sel, dtype, device):
    """Hot COO → (n, d_sel) block on ``device``: per row chunk an f32
    ``index_put_(accumulate=True)`` then the storage cast into the
    preallocated result, so the peak is one block plus one f32 chunk
    (reference: `_dense_scatter_chunked`). The hot COO is row-major, so a
    row range is a contiguous slice found by searchsorted."""
    out = torch.empty((n, d_sel), dtype=dtype, device=device)
    row_chunk = max(1, _SCATTER_CHUNK_ELEMS // max(d_sel, 1))
    for r0 in range(0, n, row_chunk):
        r1 = min(n, r0 + row_chunk)
        lo, hi = np.searchsorted(rows_h, [r0, r1])
        chunk = torch.zeros((r1 - r0, d_sel), dtype=torch.float32,
                            device=device)
        r = torch.from_numpy(rows_h[lo:hi] - r0).to(device).long()
        p = torch.from_numpy(pos_h[lo:hi]).to(device).long()
        v = torch.from_numpy(vals_h[lo:hi]).to(device)
        chunk.index_put_((r, p), v, accumulate=True)
        out[r0:r1].copy_(chunk)
    return out


def _hot_cold_split(ind, val, d, d_dense, device_dense_dtype, device):
    """Pick the ``d_dense`` most frequent columns, build the (n, d_sel) hot
    block (on ``device`` when ``device_dense_dtype`` is set, else a host
    chunked bincount), and extract the cold nnz as flat row-major COO.
    Returns (dense, sel, t_rows, t_cols, t_vals) with host t_* arrays."""
    n, k = ind.shape
    nnz_mask = val != 0.0
    counts = np.bincount(ind[nnz_mask].ravel(), minlength=d)
    d_sel = min(d_dense, d)
    sel = np.sort(np.argpartition(-counts, d_sel - 1)[:d_sel])
    col_to_pos = np.full(d, -1, np.int64)
    col_to_pos[sel] = np.arange(d_sel)

    pos = col_to_pos[ind]  # (n, k); -1 = stays sparse
    hot = (pos >= 0) & nnz_mask
    rows = np.repeat(np.arange(n), k).reshape(n, k)
    if device_dense_dtype is not None:
        dense = _dense_scatter_chunked(
            rows[hot].astype(np.int32), pos[hot].astype(np.int32),
            val[hot].astype(np.float32), n, d_sel, device_dense_dtype,
            device)
    else:
        # each cell the float64 sum of its values in row order, rounded to
        # f32: the reference's bincount over every (row, pos) cell, summed
        # here over the occupied cells alone (a stable sort within each
        # row brings a cell's slots together in their order), chunked over
        # row ranges so the scratch stays bounded
        dense = np.zeros((n, d_sel), np.float32)
        key = np.where(hot, pos, d_sel)  # cold slots sort last in a row
        row_chunk = max(1, (1 << 27) // max(d_sel, 1))
        for r0 in range(0, n, row_chunk):
            r1 = min(n, r0 + row_chunk)
            order = np.argsort(key[r0:r1], axis=1, kind="stable")
            ks = np.take_along_axis(key[r0:r1], order, axis=1)
            vs = np.take_along_axis(val[r0:r1], order, axis=1)
            live = ks < d_sel
            cells = (np.arange(r1 - r0)[:, None] * d_sel + ks)[live]
            first = np.ones(cells.shape, bool)
            first[1:] = cells[1:] != cells[:-1]
            sums = np.bincount(np.cumsum(first) - 1,
                               weights=vs[live].astype(np.float64))
            dense[r0:r1].reshape(-1)[cells[first]] = sums.astype(np.float32)
        dense = torch.from_numpy(dense).to(device)
    cold = (~hot) & nnz_mask
    flat = cold.reshape(-1)           # row-major → tail rows ascending
    t_rows = rows.reshape(-1)[flat]
    t_cols = ind.reshape(-1)[flat]
    t_vals = val.reshape(-1)[flat].astype(np.float32)
    return dense, sel, t_rows, t_cols, t_vals


def _bucket_exponents(counts: np.ndarray) -> np.ndarray:
    """pow2 bucket exponent per count (0 for counts ≤ 1)."""
    e = np.zeros(counts.shape, np.int64)
    big = counts > 1
    e[big] = np.ceil(np.log2(counts[big].astype(np.float64))).astype(np.int64)
    return e


def _column_perm(sel, u_cols, order, d):
    """(perm_cols, inv_perm) for the hot-prefix + bucket-ordered-tail +
    untouched-suffix column relabeling."""
    perm_prefix = np.concatenate([sel, u_cols[order]])
    untouched = np.setdiff1d(np.arange(d), perm_prefix)
    perm_cols = np.concatenate([perm_prefix, untouched]).astype(np.int32)
    inv_perm = np.empty(d, np.int64)
    inv_perm[perm_cols] = np.arange(d)
    return perm_cols, inv_perm.astype(np.int32)


def _occurrence_buckets(t_rows, t_vals, pcol, d_sel, e, order, u_counts):
    """Column-major padded occurrence buckets: tail nnz sorted by prefix id
    group each column's occurrences contiguously, in rank (= output)
    order. Returns (bucket_rows, bucket_vals) lists of (c_b, k_b)."""
    m = pcol.shape[0]
    nnz_order = np.argsort(pcol, kind="stable")
    rank_per = pcol[nnz_order].astype(np.int64) - d_sel
    counts_by_rank = u_counts[order]
    col_offsets = np.concatenate([[0], np.cumsum(counts_by_rank)])
    pos_within = np.arange(m) - col_offsets[rank_per]
    es = e[order]                      # exponent per rank, ascending
    bucket_rows, bucket_vals = [], []
    for e_v in np.unique(es):
        r0, r1 = np.searchsorted(es, [e_v, e_v + 1])
        c_b, k_b = int(r1 - r0), 1 << int(e_v)
        lo, hi = int(col_offsets[r0]), int(col_offsets[r1])
        br = np.zeros((c_b, k_b), np.int32)
        bv = np.zeros((c_b, k_b), np.float32)
        lr = rank_per[lo:hi] - r0
        pw = pos_within[lo:hi]
        br[lr, pw] = t_rows[nnz_order[lo:hi]]
        bv[lr, pw] = t_vals[nnz_order[lo:hi]]
        bucket_rows.append(br)
        bucket_vals.append(bv)
    return bucket_rows, bucket_vals


def _tail_ranks(t_cols, counts_of, d_sel):
    """The occurrence-bucket relabeling of the distinct tail columns:
    (u_cols, inv, exponent per column, order, rank, pcol) with
    ``counts_of(inv, u_counts)`` the count that sets each column's bucket
    (the global count, or a sharded layout's largest per-shard one)."""
    u_cols, inv, u_counts = np.unique(t_cols, return_inverse=True,
                                      return_counts=True)
    e = _bucket_exponents(counts_of(inv, u_counts))
    order = np.lexsort((u_cols, e))   # bucket-major, col id within bucket
    rank = np.empty(u_cols.size, np.int64)
    rank[order] = np.arange(u_cols.size)
    pcol = (d_sel + rank[inv]).astype(np.int32)
    return u_cols, inv, u_counts, e, order, rank, pcol


def _max_local_counts(s_ids, S: int):
    """The bucket count of a sharded layout (for `_tail_ranks`): each
    column's largest occurrence count over the S shards (``s_ids``: the
    shard of each tail entry)."""
    def counts_of(inv, u_counts):
        cs = np.bincount(inv * S + s_ids, minlength=u_counts.size * S)
        return cs.reshape(u_counts.size, S).max(axis=1)

    return counts_of


def _row_exponents(counts: np.ndarray) -> np.ndarray:
    """ELL width-bucket exponent per row tail-nnz count (-1 = no tail)."""
    e = np.where(counts > 0, _bucket_exponents(counts), -1)
    return e.astype(np.int64)


def _fill_ell(widths, counts, e_row, starts, pcol, vals):
    """ELL row buckets over the ``widths`` ladder of (exponent, r_b) pairs.
    ``starts``: per-row offset of the row's slice in the flat row-major
    tail. Returns ([(r_b, W_b) pcols], [(r_b, W_b) vals], row_pos), rows
    with no tail mapping to the zero slot at B = Σ r_b."""
    n = counts.shape[0]
    B = sum(r_b for _, r_b in widths)
    row_pos = np.full(n, B, np.int32)
    out_c, out_v = [], []
    base = 0
    for e_v, r_b in widths:
        w_b = 1 << e_v
        rows_b = np.flatnonzero(e_row == e_v)
        pc = np.zeros((r_b, w_b), np.int32)
        pv = np.zeros((r_b, w_b), np.float32)
        if rows_b.size:
            L = counts[rows_b]
            tot = int(L.sum())
            pw = np.arange(tot) - np.repeat(np.cumsum(L) - L, L)
            src = np.repeat(starts[rows_b], L) + pw
            dr = np.repeat(np.arange(rows_b.size), L)
            pc[dr, pw] = pcol[src]
            pv[dr, pw] = vals[src]
            row_pos[rows_b] = base + np.arange(rows_b.size, dtype=np.int64)
        base += r_b
        out_c.append(pc)
        out_v.append(pv)
    return out_c, out_v, row_pos


def to_blocked_ell(X: SparseRows, d_dense: int = 1024,
                   device_dense_dtype=None, device=None) -> BlockedEllRows:
    """Build the blocked-ELL layout (see `BlockedEllRows`) from padded COO
    rows (numpy or CPU-tensor leaves), on ``device`` (default ``cuda``).

    One vectorized numpy pass on the host, the reference's own: hot/cold
    split, occurrence buckets, and rows bucketed by tail nnz into the pow2
    width ladder. ``device_dense_dtype`` (e.g. ``torch.bfloat16``) builds
    the hot block on the device from the compact hot COO in that dtype;
    otherwise it is built on the host in f32 and uploaded."""
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    ind, val = _host(X.indices), _host(X.values)
    n = ind.shape[0]
    d = X.n_features
    d_sel = min(d_dense, d)
    dense, sel, t_rows, t_cols, t_vals = _hot_cold_split(
        ind, val, d, d_dense, device_dense_dtype, dev)
    m = t_rows.size

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if m == 0:
        perm_cols, inv_perm = _column_perm(
            sel, np.zeros(0, np.int64), np.zeros(0, np.int64), d)
        return BlockedEllRows(
            dense=dense, ell_pcols=(), ell_vals=(),
            row_pos=up(np.zeros(n, np.int32)),
            bucket_rows=(), bucket_vals=(),
            perm_cols=up(perm_cols), inv_perm=up(inv_perm),
            n_features=d, n_prefix=d_sel,
            last_col_pos=int(inv_perm[d - 1]), tail_nnz=0)

    u_cols, _, u_counts, e, order, _, pcol = _tail_ranks(
        t_cols, lambda inv, c: c, d_sel)
    U = u_cols.size
    perm_cols, inv_perm = _column_perm(sel, u_cols, order, d)
    bucket_rows, bucket_vals = _occurrence_buckets(
        t_rows, t_vals, pcol, d_sel, e, order, u_counts)

    row_bounds = np.searchsorted(t_rows, np.arange(n + 1)).astype(np.int64)
    counts = np.diff(row_bounds)
    e_row = _row_exponents(counts)
    widths = [(int(ev), int((e_row == ev).sum()))
              for ev in np.unique(e_row[e_row >= 0])]
    # prefix-RELATIVE ids: the tail gather reads w[d_sel:n_prefix]
    pcol_rel = (pcol.astype(np.int64) - d_sel).astype(np.int32)
    pcs, pvs, row_pos = _fill_ell(widths, counts, e_row, row_bounds[:-1],
                                  pcol_rel, t_vals)

    return BlockedEllRows(
        dense=dense, ell_pcols=tuple(map(up, pcs)),
        ell_vals=tuple(map(up, pvs)), row_pos=up(row_pos),
        bucket_rows=tuple(map(up, bucket_rows)),
        bucket_vals=tuple(map(up, bucket_vals)),
        perm_cols=up(perm_cols), inv_perm=up(inv_perm),
        n_features=d, n_prefix=d_sel + U,
        last_col_pos=int(inv_perm[d - 1]), tail_nnz=int(m))


# ------------------------------------------------------ host chunk ladder
@dataclasses.dataclass(frozen=True)
class ShardedBlockedEllRows:
    """A blocked-ELL layout laid for S row shards under ONE global column
    permutation, held on the host as CPU tensors (reference:
    `photon_tpu.data.matrix.ShardedBlockedEllRows`).

    Every per-shard structure is padded to a common shape across the
    shards (shard axis leading): the ELL width ladder is the union of the
    shards' row exponents with r_b the largest per-shard count, the
    occurrence buckets take the largest per-shard occurrence count, and
    ``row_pos`` is (S, n_local) with LOCAL concatenation positions. It is
    the form a streamed chunk ladder is cut from (`chunk`,
    `data.dataset.chunk_blocked_ell`), and a mesh's: shard ``j`` goes to
    slot ``j`` as its own `BlockedEllRows` (`data.dataset.mesh_batch`,
    `mesh_chunk_matrix`)."""

    dense: torch.Tensor        # (n, d_sel) hot block, global rows
    ell_pcols: tuple           # per width bucket: (S, r_b, W_b) int32
    ell_vals: tuple            # per width bucket: (S, r_b, W_b)
    row_pos: torch.Tensor      # (S, n_local) int32 local positions
    bucket_rows: tuple         # per occurrence bucket: (S, c_b, k_b) LOCAL
    bucket_vals: tuple         # per occurrence bucket: (S, c_b, k_b)
    perm_cols: torch.Tensor    # (d,) int32
    inv_perm: torch.Tensor     # (d,) int32
    n_features: int
    n_prefix: int
    last_col_pos: int
    tail_nnz: int

    @property
    def n_shards(self) -> int:
        return int(self.row_pos.shape[0])

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    @property
    def n_local(self) -> int:
        return int(self.row_pos.shape[1])

    def chunk(self, i: int) -> BlockedEllRows:
        """Shard ``i`` as a CPU `BlockedEllRows` (views, no copies of the
        value blocks), with its inverse map ``tail_rows``: every chunk
        shares the common shapes, so the kernels' work plans are shared
        too, and the padded rows of its width buckets map to -1."""
        nl = self.n_local
        row_pos = self.row_pos[i]
        B = sum(int(v.shape[1]) for v in self.ell_vals)
        rp = row_pos.numpy()
        live = np.flatnonzero(rp < B)
        tail_rows = np.full(B, -1, np.int32)
        tail_rows[rp[live]] = live
        return BlockedEllRows(
            dense=self.dense[i * nl:(i + 1) * nl],
            ell_pcols=tuple(b[i] for b in self.ell_pcols),
            ell_vals=tuple(b[i] for b in self.ell_vals),
            row_pos=row_pos,
            bucket_rows=tuple(b[i] for b in self.bucket_rows),
            bucket_vals=tuple(b[i] for b in self.bucket_vals),
            perm_cols=self.perm_cols, inv_perm=self.inv_perm,
            n_features=self.n_features, n_prefix=self.n_prefix,
            last_col_pos=self.last_col_pos, tail_nnz=self.tail_nnz,
            tail_rows=torch.from_numpy(tail_rows))

    local = chunk  # the shard accessor every sharded layout shares

    def shard_slice(self, lo: int, hi: int) -> "ShardedBlockedEllRows":
        """Shards ``lo:hi`` as one smaller ladder (views, no copies)."""
        nl = self.n_local
        return dataclasses.replace(
            self, dense=self.dense[lo * nl:hi * nl],
            ell_pcols=tuple(b[lo:hi] for b in self.ell_pcols),
            ell_vals=tuple(b[lo:hi] for b in self.ell_vals),
            row_pos=self.row_pos[lo:hi],
            bucket_rows=tuple(b[lo:hi] for b in self.bucket_rows),
            bucket_vals=tuple(b[lo:hi] for b in self.bucket_vals))

    def astype(self, dtype) -> "ShardedBlockedEllRows":
        """Every value leaf of every shard in ``dtype``, as
        `BlockedEllRows.astype`."""
        return dataclasses.replace(
            self, dense=self.dense.to(dtype),
            ell_vals=tuple(v.to(dtype) for v in self.ell_vals),
            bucket_vals=tuple(v.to(dtype) for v in self.bucket_vals))


def _sharded_occurrence_buckets(loc_rows, t_vals, rank_nnz, s_ids, S, e,
                                order):
    """Per-shard occurrence buckets (S, c_b, k_b) with LOCAL row ids: nnz
    sorted by (rank, shard); within a (rank, shard) group the row-major
    source keeps local rows ascending."""
    m_tot = rank_nnz.shape[0]
    U = order.shape[0]
    nnz_order = np.lexsort((s_ids, rank_nnz))
    rs_key = (rank_nnz * S + s_ids)[nnz_order]
    counts_rs = np.bincount(rs_key, minlength=U * S)
    offsets_rs = np.concatenate([[0], np.cumsum(counts_rs)])
    pos_within = np.arange(m_tot) - offsets_rs[rs_key]
    rank_sorted = rank_nnz[nnz_order]
    es = e[order]                      # exponent per rank, ascending
    bucket_rows, bucket_vals = [], []
    for e_v in np.unique(es):
        r0, r1 = np.searchsorted(es, [e_v, e_v + 1])
        c_b, k_b = int(r1 - r0), 1 << int(e_v)
        lo, hi = np.searchsorted(rank_sorted, [r0, r1])
        br = np.zeros((S, c_b, k_b), np.int32)
        bv = np.zeros((S, c_b, k_b), np.float32)
        sel_nnz = nnz_order[lo:hi]
        ls = s_ids[sel_nnz]
        lr = rank_nnz[sel_nnz] - r0
        pw = pos_within[lo:hi]
        br[ls, lr, pw] = loc_rows[sel_nnz]
        bv[ls, lr, pw] = t_vals[sel_nnz]
        bucket_rows.append(br)
        bucket_vals.append(bv)
    return bucket_rows, bucket_vals


def shard_blocked_ell(X: SparseRows, n_shards: int,
                      d_dense: int = 1024) -> ShardedBlockedEllRows:
    """Build the sharded blocked-ELL layout (see `ShardedBlockedEllRows`)
    from padded COO rows (numpy or CPU-tensor leaves), on the host. Rows
    must divide ``n_shards`` (pad the batch first).

    The reference's own numpy pass (`photon_tpu.data.matrix.
    shard_blocked_ell` with its host hot block), so every array equals the
    JAX package's: a GLOBAL column permutation (hot prefix from global
    frequencies, tail ranks by the largest per-shard occurrence bucket)
    and per-shard structures padded to common shapes (a (shard, width)
    pair a shard lacks is all-zero rows that contribute nothing)."""
    ind, val = _host(X.indices), _host(X.values)
    n = ind.shape[0]
    d = X.n_features
    if n % n_shards != 0:
        raise ValueError(
            f"{n} rows do not divide {n_shards} shards; pad the batch first "
            "(data.dataset.pad_batch)")
    n_local = n // n_shards
    d_sel = min(d_dense, d)
    dense, sel, t_rows, t_cols, t_vals = _hot_cold_split(
        ind, val, d, d_dense, None, torch.device("cpu"))
    t_vals = t_vals.astype(np.float32)
    m_tot = t_rows.size
    S = n_shards

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if m_tot == 0:
        perm_cols, inv_perm = _column_perm(
            sel, np.zeros(0, np.int64), np.zeros(0, np.int64), d)
        return ShardedBlockedEllRows(
            dense=dense, ell_pcols=(), ell_vals=(),
            row_pos=t(np.zeros((S, n_local), np.int32)),
            bucket_rows=(), bucket_vals=(),
            perm_cols=t(perm_cols), inv_perm=t(inv_perm),
            n_features=d, n_prefix=d_sel,
            last_col_pos=int(inv_perm[d - 1]), tail_nnz=0)

    s_ids = (t_rows // n_local).astype(np.int64)       # (m,) shard per nnz
    loc_rows = (t_rows - s_ids * n_local).astype(np.int64)

    u_cols, inv, _, e, order, rank, pcol = _tail_ranks(
        t_cols, _max_local_counts(s_ids, S), d_sel)
    U = u_cols.size
    perm_cols, inv_perm = _column_perm(sel, u_cols, order, d)
    bucket_rows, bucket_vals = _sharded_occurrence_buckets(
        loc_rows, t_vals, rank[inv], s_ids, S, e, order)

    # per-shard ELL row buckets over a SHARED width ladder (t_rows is
    # ascending, so a shard's slice of the flat tail is contiguous)
    sb = np.searchsorted(t_rows, np.arange(S + 1) * n_local)
    shard_layouts = []
    for s in range(S):
        lo, hi = int(sb[s]), int(sb[s + 1])
        rbs = lo + np.searchsorted(loc_rows[lo:hi], np.arange(n_local + 1))
        counts_s = np.diff(rbs)
        shard_layouts.append((counts_s, _row_exponents(counts_s),
                              rbs[:-1].astype(np.int64)))
    widths: dict = {}
    for counts_s, e_row_s, _ in shard_layouts:
        for ev in np.unique(e_row_s[e_row_s >= 0]):
            r_b = int((e_row_s == ev).sum())
            widths[int(ev)] = max(widths.get(int(ev), 0), r_b)
    ladder = sorted(widths.items())
    pcol_rel = (pcol.astype(np.int64) - d_sel).astype(np.int32)
    per_shard = [_fill_ell(ladder, counts_s, e_row_s, starts_s, pcol_rel,
                           t_vals)
                 for counts_s, e_row_s, starts_s in shard_layouts]
    ell_pcols = tuple(t(np.stack([q[0][b] for q in per_shard]))
                      for b in range(len(ladder)))
    ell_vals = tuple(t(np.stack([q[1][b] for q in per_shard]))
                     for b in range(len(ladder)))
    row_pos = t(np.stack([q[2] for q in per_shard]))

    return ShardedBlockedEllRows(
        dense=dense, ell_pcols=ell_pcols, ell_vals=ell_vals,
        row_pos=row_pos, bucket_rows=tuple(map(t, bucket_rows)),
        bucket_vals=tuple(map(t, bucket_vals)),
        perm_cols=t(perm_cols), inv_perm=t(inv_perm),
        n_features=d, n_prefix=d_sel + U,
        last_col_pos=int(inv_perm[d - 1]), tail_nnz=int(m_tot))


def blocked_ell_from_scipy_csr(csr, d_dense: int = 1024,
                               device_dense_dtype=None, strict: bool = False,
                               device=None) -> BlockedEllRows:
    """scipy CSR → `BlockedEllRows` in one call: `from_scipy_csr` (never
    truncating: k is the largest row nnz; ``strict`` is passed on), then
    `to_blocked_ell` on ``device``."""
    return to_blocked_ell(from_scipy_csr(csr, strict=strict), d_dense,
                          device_dense_dtype=device_dense_dtype,
                          device=device)


# ------------------------------------------------------- hybrid layouts
def _to_device(X, device, non_blocking: bool = False):
    """``X`` (a frozen layout) with every tensor field, and every tuple of
    tensors, on ``device``: ``X`` itself when they all are there already,
    so what is kept with it (a plan) stays."""
    changes, same = {}, True
    for f in dataclasses.fields(X):
        v = getattr(X, f.name)
        if not f.init or not isinstance(v, (torch.Tensor, tuple)):
            continue
        new = (v.to(device, non_blocking=non_blocking)
               if isinstance(v, torch.Tensor) else
               tuple(t.to(device, non_blocking=non_blocking) for t in v))
        same &= (new is v if isinstance(v, torch.Tensor)
                 else all(a is b for a, b in zip(new, v)))
        changes[f.name] = new
    return X if same else dataclasses.replace(X, **changes)


@dataclasses.dataclass(frozen=True)
class HybridRows:
    """Hot columns dense, cold tail flat COO (reference:
    `photon_tpu.data.matrix.HybridRows`).

    The ``d_sel`` most frequent columns form a dense (n, d_sel) block at
    their original ids ``dense_cols``; the other nonzeros are an exact-size
    flat COO sorted by row (one zero sentinel entry when there are none).
    Vectors stay in ORIGINAL column order. The matvec reduces the tail per
    row by `sorted_segment_sum`; the Xᵀr sums it per column through the
    layout's `SegmentPlan` (built on the first one and kept, like a
    `SparseRows`'), then adds the hot block's product at ``dense_cols``."""

    dense: torch.Tensor       # (n, d_sel) hot-column values
    dense_cols: torch.Tensor  # (d_sel,) int32 original column ids
    tail_rows: torch.Tensor   # (m,) int32 row ids, ascending
    tail_cols: torch.Tensor   # (m,) int32 original column ids
    tail_vals: torch.Tensor   # (m,) values (padding: 0.0)
    n_features: int
    plan: object = dataclasses.field(default=None, init=False,
                                     compare=False, repr=False)

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    def to(self, device, non_blocking: bool = False) -> "HybridRows":
        """The same layout with every tensor on ``device`` (itself when
        they are all there, its plan kept)."""
        return _to_device(self, device, non_blocking)

    def astype(self, dtype) -> "HybridRows":
        """The hot block and the tail values in ``dtype``."""
        return dataclasses.replace(self, dense=self.dense.to(dtype),
                                   tail_vals=self.tail_vals.to(dtype))


@dataclasses.dataclass(frozen=True)
class ShardedHybridRows:
    """A `HybridRows` laid for S row shards, held on the host (reference:
    `photon_tpu.data.matrix.ShardedHybridRows`): rows split into S equal
    contiguous shards, each shard's tail padded to one length m with
    LOCAL row ids (padding: row n_local - 1, column 0, value 0, so a
    shard's rows stay ascending). Shard ``i`` reaches a mesh slot as its
    own `HybridRows` (`local`, `data.dataset.mesh_batch`)."""

    dense: torch.Tensor       # (n, d_sel) hot block, global rows
    dense_cols: torch.Tensor  # (d_sel,) int32
    tail_rows: torch.Tensor   # (S, m) int32 LOCAL row ids, ascending
    tail_cols: torch.Tensor   # (S, m) int32 original column ids
    tail_vals: torch.Tensor   # (S, m) values (padding: 0.0)
    n_features: int

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    @property
    def n_shards(self) -> int:
        return int(self.tail_rows.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.dense.shape[0]) // self.n_shards

    def local(self, i: int) -> HybridRows:
        """Shard ``i`` as a `HybridRows` (views, no copies)."""
        nl = self.n_local
        return HybridRows(self.dense[i * nl:(i + 1) * nl], self.dense_cols,
                          self.tail_rows[i], self.tail_cols[i],
                          self.tail_vals[i], self.n_features)

    def astype(self, dtype) -> "ShardedHybridRows":
        return dataclasses.replace(self, dense=self.dense.to(dtype),
                                   tail_vals=self.tail_vals.to(dtype))


@dataclasses.dataclass(frozen=True)
class PermutedHybridRows:
    """The hot block and the cold tail in the permuted column space of
    `BlockedEllRows` (reference: `photon_tpu.data.matrix.
    PermutedHybridRows`): hot columns at [0, d_sel), the U distinct tail
    columns at [d_sel, n_prefix) in occurrence-bucket order, untouched
    columns after. The tail is laid twice: row-major flat (``tail_pcols``,
    ``tail_vals``, row s at ``row_bounds[s]:row_bounds[s + 1]``) for the
    matvec, reduced per row by differences of one prefix sum; and as the
    occurrence buckets for the Xᵀr, which the blocked-ELL rmatvec kernel
    sums with the cotangent NOT rounded to the storage dtype (the
    reference multiplies the upcast values by the f32 cotangent here).
    Solver vectors live in the permuted space; `to_model_space` /
    `from_model_space` translate at the public boundary."""

    dense: torch.Tensor       # (n, d_sel) hot block
    tail_pcols: torch.Tensor  # (m,) int32 PERMUTED column ids, row-major
    tail_vals: torch.Tensor   # (m,) values
    row_bounds: torch.Tensor  # (n + 1,) int32 tail bounds per row
    bucket_rows: tuple        # per occurrence bucket: (c_b, k_b) int32 rows
    bucket_vals: tuple        # per occurrence bucket: (c_b, k_b) values
    perm_cols: torch.Tensor   # (d,) int32 original column per position
    inv_perm: torch.Tensor    # (d,) int32 position of each original column
    n_features: int
    n_prefix: int             # d_sel + U distinct tail columns
    last_col_pos: int         # permuted position of original column d - 1

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    @property
    def d_sel(self) -> int:
        return int(self.dense.shape[1])

    def from_model_space(self, v: torch.Tensor) -> torch.Tensor:
        """Original-space (d,) vector (or (d, ...) stack) → permuted space."""
        return torch.index_select(v, 0, self.perm_cols)

    def to_model_space(self, w: torch.Tensor) -> torch.Tensor:
        """Permuted-space (d,) vector (or (d, ...) stack) → original space."""
        return torch.index_select(w, 0, self.inv_perm)

    def to(self, device, non_blocking: bool = False) -> "PermutedHybridRows":
        """The same layout with every tensor on ``device`` (itself when
        they are all there, so the kernels' plan for it is kept)."""
        return _to_device(self, device, non_blocking)

    def astype(self, dtype) -> "PermutedHybridRows":
        """Every value leaf (hot block, flat tail, occurrence buckets) in
        ``dtype``."""
        return dataclasses.replace(
            self, dense=self.dense.to(dtype),
            tail_vals=self.tail_vals.to(dtype),
            bucket_vals=tuple(v.to(dtype) for v in self.bucket_vals))


@dataclasses.dataclass(frozen=True)
class ShardedPermutedHybridRows:
    """A `PermutedHybridRows` laid for S row shards under ONE global column
    permutation, held on the host (reference: `photon_tpu.data.matrix.
    ShardedPermutedHybridRows`): per shard a row-major flat tail padded to
    one length (padding: column d_sel, value 0, past the shard's last row
    bound) and occurrence buckets with LOCAL row ids. Every shard carries
    all U bucket columns (a column a shard lacks is zero slots), so the
    bucket work a shard does does not shrink with S. Shard ``i`` reaches a
    mesh slot as its own `PermutedHybridRows` (`local`)."""

    dense: torch.Tensor       # (n, d_sel) hot block, global rows
    tail_pcols: torch.Tensor  # (S, m) int32 PERMUTED column ids
    tail_vals: torch.Tensor   # (S, m) values (padding: 0)
    row_bounds: torch.Tensor  # (S, n_local + 1) int32
    bucket_rows: tuple        # per occurrence bucket: (S, c_b, k_b) LOCAL
    bucket_vals: tuple        # per occurrence bucket: (S, c_b, k_b)
    perm_cols: torch.Tensor   # (d,) int32
    inv_perm: torch.Tensor    # (d,) int32
    n_features: int
    n_prefix: int
    last_col_pos: int

    @property
    def shape(self):
        return (self.dense.shape[0], self.n_features)

    @property
    def d_sel(self) -> int:
        return int(self.dense.shape[1])

    @property
    def n_shards(self) -> int:
        return int(self.tail_pcols.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.dense.shape[0]) // self.n_shards

    def local(self, i: int) -> PermutedHybridRows:
        """Shard ``i`` as a `PermutedHybridRows` (views, no copies)."""
        nl = self.n_local
        return PermutedHybridRows(
            dense=self.dense[i * nl:(i + 1) * nl],
            tail_pcols=self.tail_pcols[i], tail_vals=self.tail_vals[i],
            row_bounds=self.row_bounds[i],
            bucket_rows=tuple(b[i] for b in self.bucket_rows),
            bucket_vals=tuple(b[i] for b in self.bucket_vals),
            perm_cols=self.perm_cols, inv_perm=self.inv_perm,
            n_features=self.n_features, n_prefix=self.n_prefix,
            last_col_pos=self.last_col_pos)

    def from_model_space(self, v: torch.Tensor) -> torch.Tensor:
        return torch.index_select(v, 0, self.perm_cols.to(v.device))

    def to_model_space(self, w: torch.Tensor) -> torch.Tensor:
        return torch.index_select(w, 0, self.inv_perm.to(w.device))

    def astype(self, dtype) -> "ShardedPermutedHybridRows":
        return dataclasses.replace(
            self, dense=self.dense.to(dtype),
            tail_vals=self.tail_vals.to(dtype),
            bucket_vals=tuple(v.to(dtype) for v in self.bucket_vals))


# the permuted-space layouts: a solve on one runs in its column space
PERMUTED_LAYOUTS = (BlockedEllRows, PermutedHybridRows)
# the layouts laid for one device's rows: a mesh takes their sharded forms
SINGLE_DEVICE_LAYOUTS = (BlockedEllRows, HybridRows, PermutedHybridRows)
# the host containers laid for S row shards, one per mesh slot
SHARDED_LAYOUTS = (ShardedBlockedEllRows, ShardedHybridRows,
                   ShardedPermutedHybridRows)


def to_hybrid(X: SparseRows, d_dense: int = 1024, device_dense_dtype=None,
              device=None) -> HybridRows:
    """Split padded COO rows into a `HybridRows` on ``device`` (default
    ``cuda``): the ``d_dense`` columns with the most nonzeros dense, the
    rest compacted into exact-size flat COO sorted by row (the reference's
    numpy pass, the same arrays). ``device_dense_dtype`` builds the hot
    block on the device in that dtype, as `to_blocked_ell`."""
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    ind, val = _host(X.indices), _host(X.values)
    dense, sel, t_rows, t_cols, t_vals = _hot_cold_split(
        ind, val, X.n_features, d_dense, device_dense_dtype, dev)
    if t_rows.size == 0:  # one zero sentinel keeps the arrays non-empty
        t_rows = np.zeros(1, np.int64)
        t_cols = np.zeros(1, np.int64)
        t_vals = np.zeros(1, np.float32)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)

    return HybridRows(dense, up(sel, np.int32), up(t_rows, np.int32),
                      up(t_cols, np.int32), up(t_vals, np.float32),
                      X.n_features)


def to_permuted_hybrid(X: SparseRows, d_dense: int = 1024,
                       device_dense_dtype=None,
                       device=None) -> PermutedHybridRows:
    """Build the `PermutedHybridRows` of padded COO rows on ``device``
    (default ``cuda``): the reference's numpy pass (the same arrays as
    `photon_tpu.data.matrix.to_permuted_hybrid`), sharing the hot/cold
    split, the column permutation and the occurrence buckets with
    `to_blocked_ell`."""
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    ind, val = _host(X.indices), _host(X.values)
    n, d = ind.shape[0], X.n_features
    d_sel = min(d_dense, d)
    dense, sel, t_rows, t_cols, t_vals = _hot_cold_split(
        ind, val, d, d_dense, device_dense_dtype, dev)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if t_rows.size == 0:
        perm_cols, inv_perm = _column_perm(
            sel, np.zeros(0, np.int64), np.zeros(0, np.int64), d)
        return PermutedHybridRows(
            dense=dense, tail_pcols=up(np.zeros(1, np.int32)),
            tail_vals=up(np.zeros(1, np.float32)),
            row_bounds=up(np.zeros(n + 1, np.int32)),
            bucket_rows=(), bucket_vals=(), perm_cols=up(perm_cols),
            inv_perm=up(inv_perm), n_features=d, n_prefix=d_sel,
            last_col_pos=int(inv_perm[d - 1]))
    row_bounds = np.searchsorted(t_rows, np.arange(n + 1)).astype(np.int32)
    u_cols, _, u_counts, e, order, _, pcol = _tail_ranks(
        t_cols, lambda inv, c: c, d_sel)
    perm_cols, inv_perm = _column_perm(sel, u_cols, order, d)
    bucket_rows, bucket_vals = _occurrence_buckets(
        t_rows, t_vals, pcol, d_sel, e, order, u_counts)
    return PermutedHybridRows(
        dense=dense, tail_pcols=up(pcol),
        tail_vals=up(t_vals.astype(np.float32)), row_bounds=up(row_bounds),
        bucket_rows=tuple(map(up, bucket_rows)),
        bucket_vals=tuple(map(up, bucket_vals)),
        perm_cols=up(perm_cols), inv_perm=up(inv_perm), n_features=d,
        n_prefix=d_sel + u_cols.size, last_col_pos=int(inv_perm[d - 1]))


def _cpu(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_hybrid(X, n_shards: int, d_dense: int = 1024) -> ShardedHybridRows:
    """Re-lay a `HybridRows` (or padded COO rows, through `to_hybrid`) for
    ``n_shards`` row shards, on the host (the reference's pass: each
    shard's slice of the row-sorted tail, the sentinel and any padding
    dropped, padded to the longest shard's length). Rows must divide
    ``n_shards`` (pad the batch first); the hot block stays where it
    is."""
    if isinstance(X, SparseRows):
        X = to_hybrid(X, d_dense, device="cpu")
    n = int(X.dense.shape[0])
    if n % n_shards != 0:
        raise ValueError(
            f"{n} rows do not divide {n_shards} shards; pad the batch first "
            "(data.dataset.shard_hybrid_batch)")
    n_local = n // n_shards
    tv = _cpu(X.tail_vals)
    keep = (tv != 0).numpy()   # drop the sentinel / any padding
    tr, tc = _host(X.tail_rows)[keep], _host(X.tail_cols)[keep]
    tv = tv[torch.from_numpy(keep)]
    bounds = np.searchsorted(tr, np.arange(n_shards + 1) * n_local)
    m = max(1, int(np.max(np.diff(bounds))))
    rows = np.full((n_shards, m), n_local - 1, np.int32)
    cols = np.zeros((n_shards, m), np.int32)
    vals = torch.zeros((n_shards, m), dtype=tv.dtype)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        c = hi - lo
        rows[s, :c] = tr[lo:hi] - s * n_local
        cols[s, :c] = tc[lo:hi]
        vals[s, :c] = tv[lo:hi]
    return ShardedHybridRows(X.dense, _cpu(X.dense_cols),
                             torch.from_numpy(rows), torch.from_numpy(cols),
                             vals, X.n_features)


def shard_permuted_hybrid(X: SparseRows, n_shards: int, d_dense: int = 1024,
                          device_dense_dtype=None
                          ) -> ShardedPermutedHybridRows:
    """Build the `ShardedPermutedHybridRows` of padded COO rows on the host
    (the reference's numpy pass, the same arrays): a GLOBAL column
    permutation (hot prefix from global frequencies, tail ranks by the
    largest per-shard occurrence count) and per-shard flat tails and
    occurrence buckets with local rows. Rows must divide ``n_shards``
    (pad the batch first); ``device_dense_dtype`` builds the hot block in
    that dtype."""
    ind, val = _host(X.indices), _host(X.values)
    n, d = ind.shape[0], X.n_features
    if n % n_shards != 0:
        raise ValueError(
            f"{n} rows do not divide {n_shards} shards; pad the batch first "
            "(data.dataset.shard_permuted_batch)")
    n_local = n // n_shards
    d_sel = min(d_dense, d)
    dense, sel, t_rows, t_cols, t_vals = _hot_cold_split(
        ind, val, d, d_dense, device_dense_dtype, torch.device("cpu"))
    t_vals = t_vals.astype(np.float32)
    S = n_shards

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if t_rows.size == 0:
        perm_cols, inv_perm = _column_perm(
            sel, np.zeros(0, np.int64), np.zeros(0, np.int64), d)
        return ShardedPermutedHybridRows(
            dense=dense, tail_pcols=t(np.zeros((S, 1), np.int32)),
            tail_vals=t(np.zeros((S, 1), np.float32)),
            row_bounds=t(np.zeros((S, n_local + 1), np.int32)),
            bucket_rows=(), bucket_vals=(), perm_cols=t(perm_cols),
            inv_perm=t(inv_perm), n_features=d, n_prefix=d_sel,
            last_col_pos=int(inv_perm[d - 1]))
    s_ids = (t_rows // n_local).astype(np.int64)       # (m,) shard per nnz
    loc_rows = (t_rows - s_ids * n_local).astype(np.int64)

    u_cols, inv, _, e, order, rank, pcol = _tail_ranks(
        t_cols, _max_local_counts(s_ids, S), d_sel)
    perm_cols, inv_perm = _column_perm(sel, u_cols, order, d)
    # per-shard row-major flat tails (t_rows ascending: a shard's slice is
    # contiguous); padding (pcol d_sel, value 0) sits past the last bound
    sb = np.searchsorted(t_rows, np.arange(S + 1) * n_local)
    m = max(1, int(np.max(np.diff(sb))))
    tail_pcols = np.full((S, m), d_sel, np.int32)
    tail_vals = np.zeros((S, m), np.float32)
    row_bounds = np.zeros((S, n_local + 1), np.int32)
    for s in range(S):
        lo, hi = int(sb[s]), int(sb[s + 1])
        tail_pcols[s, :hi - lo] = pcol[lo:hi]
        tail_vals[s, :hi - lo] = t_vals[lo:hi]
        row_bounds[s] = np.searchsorted(
            loc_rows[lo:hi], np.arange(n_local + 1)).astype(np.int32)
    bucket_rows, bucket_vals = _sharded_occurrence_buckets(
        loc_rows, t_vals, rank[inv], s_ids, S, e, order)
    return ShardedPermutedHybridRows(
        dense=dense, tail_pcols=t(tail_pcols), tail_vals=t(tail_vals),
        row_bounds=t(row_bounds), bucket_rows=tuple(map(t, bucket_rows)),
        bucket_vals=tuple(map(t, bucket_vals)), perm_cols=t(perm_cols),
        inv_perm=t(inv_perm), n_features=d, n_prefix=d_sel + u_cols.size,
        last_col_pos=int(inv_perm[d - 1]))


# --------------------------------------------------------------- X passes
# A contraction of at least twice this many terms (an Xᵀr over the rows)
# runs as one batched product over chunks of this many, then one f32 sum
# of the chunk results. In one cuBLAS call over 2^21 rows the hot block's
# Xᵀr was off by up to 1.6e-4 of its largest output (5.5e-5 at 8
# columns), in chunks of 4,096 rows by 2.2e-6 (3.4e-6), in about the same
# time, and a column's result no longer depends on how many columns share
# the call (NVIDIA H100; chip_smoke.py's phase G measures both).
_MM_CHUNK = 4096


def _mm(a: torch.Tensor, b: torch.Tensor, batched: bool = False):
    """``a @ b`` (or ``torch.bmm``) with an f32 result for bf16 or f32
    operands: cuBLAS with an f32 output on the card (``out_dtype``, the
    counterpart of ``preferred_element_type``); on the CPU both operands
    upcast to f32, where each bf16×bf16 product is exact."""
    mm = torch.bmm if batched else torch.mm
    if a.dtype == torch.float32:
        return mm(a, b)
    if a.is_cuda:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


# (X∘X)ᵀr squares this many rows of X at a time (a multiple of
# `_MM_CHUNK`): 2^18 rows of T2's 1,024-column bf16 hot block are 0.5 GB,
# where squaring the whole block formed a second 4.29 GB copy of it.
_SQ_ROWS = 1 << 18


def _chunked(t: torch.Tensor, C: int, c: int) -> torch.Tensor:
    """(C, rows, c) strided view of the first C·c columns of ``t``."""
    return t.as_strided((C, t.shape[0], c),
                        (c * t.stride(1), t.stride(0), t.stride(1)))


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            square: bool = False) -> torch.Tensor:
    """``a @ b`` (``(a∘a) @ b`` with ``square``) with f32 accumulation and
    an f32 result, for ``b`` already in ``a``'s dtype (vector or matrix);
    a long contraction is summed in chunks of `_MM_CHUNK` terms (strided
    views, no copies). ``square`` squares ``a`` in the storage dtype,
    `_SQ_ROWS` columns at a time, so no second copy of ``a`` forms; the
    chunk products are summed in the same order either way."""
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    K = a.shape[1]

    def sq(t):  # in the layout of the whole block's square
        return (t.t() * t.t()).t() if square else t

    if K < 2 * _MM_CHUNK:
        out = _mm(sq(a), b2)
    else:
        c = _MM_CHUNK
        C = K // c
        step = (max(1, _SQ_ROWS // c) if square else C) * c
        parts = []
        for k0 in range(0, C * c, step):
            ak = sq(a[:, k0:k0 + step])
            bk = b2[k0:k0 + step]
            Ck = ak.shape[1] // c
            parts.append(_mm(
                _chunked(ak, Ck, c),
                bk.as_strided((Ck, c, bk.shape[1]),
                              (c * bk.stride(0), bk.stride(0),
                               bk.stride(1))),
                batched=True))
        out = (parts[0] if len(parts) == 1 else torch.cat(parts)).sum(dim=0)
        if C * c < K:
            out += _mm(sq(a[:, C * c:]), b2[C * c:])
    return out[:, 0] if vec else out


def _bell_matvec(X: BlockedEllRows, w: torch.Tensor) -> torch.Tensor:
    """w: (d,) or (d, G) PERMUTED. The hot block against bf16(w[:d_sel])
    (storage dtype), then the ELL tail added into that product in place
    through the kernel seam (fused or tiled by `kernels.route`): per row
    one f32 add of the same two terms as ``hot + tail``."""
    hot = _mm_f32(X.dense, w[:X.d_sel].to(X.dense.dtype))
    if not X.ell_vals:
        return hot
    tail = (KB.tail_matvec if K.route(X, w) == "fused"
            else KB.tail_matvec_tiled)
    return tail(X, w, out=hot)


def _bell_rmatvec(X, r: torch.Tensor, square: bool = False) -> torch.Tensor:
    """Xᵀr (or (X∘X)ᵀr) of a permuted layout (`BlockedEllRows` or
    `PermutedHybridRows`) in prefix order, in one (d,)/(d, G) f32 result:
    the hot block's transpose product (for ``square`` each row chunk
    squared in the storage dtype as it goes) in ``[:d_sel]``, the
    occurrence-bucket block written by the kernel seam into
    ``[d_sel:n_prefix]``, zeros for the untouched suffix. r: (n,) or
    (n, G). The blocked-ELL block rounds r to the storage dtype; the
    permuted hybrid's does not (each reference's recipe)."""
    out = torch.empty((X.n_features,) + tuple(r.shape[1:]),
                      dtype=torch.float32, device=r.device)
    out[:X.d_sel] = _mm_f32(X.dense.t(), r.to(X.dense.dtype), square=square)
    if X.bucket_vals:
        rmv = (KB.bucket_rmatvec if K.route(X, r) == "fused"
               else KB.bucket_rmatvec_tiled)
        rmv(X, r, square=square, out=out[X.d_sel:X.n_prefix],
            round_r=isinstance(X, BlockedEllRows))
    out[X.n_prefix:].zero_()
    return out


def _gather_product(vals: torch.Tensor, vec: torch.Tensor,
                    idx: torch.Tensor, square: bool = False) -> torch.Tensor:
    """(m,) or (m, G) f32 products ``f32(vals) · vec[idx]`` (the values
    squared first for ``square``), the cotangent or coefficients taken
    unrounded, as the reference's hybrids."""
    v = vals.to(torch.float32)
    if square:
        v = v * v
    g = vec.index_select(0, idx)
    return v[:, None] * g if g.dim() == 2 else v * g


def _hybrid_matvec(X: HybridRows, w: torch.Tensor) -> torch.Tensor:
    """w: (d,) or (d, G) in original order. The tail's products summed
    per row by `sorted_segment_sum` over the sorted ``tail_rows``, plus
    the hot block against bf16(w[dense_cols]) (storage dtype)."""
    tail = sorted_segment_sum(_gather_product(X.tail_vals, w, X.tail_cols),
                              X.tail_rows, int(X.dense.shape[0]))
    return tail + _mm_f32(X.dense,
                          w.index_select(0, X.dense_cols).to(X.dense.dtype))


def _hybrid_rmatvec(X: HybridRows, r: torch.Tensor,
                    square: bool = False) -> torch.Tensor:
    """Xᵀr (or (X∘X)ᵀr): each live tail entry's product summed per column
    by the layout's `SegmentPlan` (no atomic add: the same bits every
    run), then the hot block's transpose product written at the unique
    ``dense_cols`` (which hold no tail entry) on top of what is there."""
    plan = segment_plan(X)
    out = segment_sums(plan, _gather_product(
        X.tail_vals.index_select(0, plan.src), r, plan.rows, square))
    hot = _mm_f32(X.dense.t(), r.to(X.dense.dtype), square=square)
    cols = X.dense_cols.long()
    return out.index_copy_(0, cols, out.index_select(0, cols) + hot)


def _perm_matvec(X: PermutedHybridRows, w: torch.Tensor) -> torch.Tensor:
    """w: (d,) or (d, G) PERMUTED. The hot block against bf16(w[:d_sel])
    (storage dtype), plus the flat tail's products reduced per row by
    differences of one prefix sum over ``row_bounds``."""
    hot = _mm_f32(X.dense, w[:X.d_sel].to(X.dense.dtype))
    return hot + _tail_rowsum(
        _gather_product(X.tail_vals, w, X.tail_pcols), X.row_bounds)


def _sparse_rmatvec(X: SparseRows, r: torch.Tensor,
                    square: bool = False) -> torch.Tensor:
    """Xᵀr (or (X∘X)ᵀr) of padded COO rows, r (n,) or (n, G): each live
    slot's product in column order (the matrix's `SegmentPlan`), summed
    per column by `segment_sums` — no atomic add, so the same bits on
    every run."""
    plan = segment_plan(X)
    v = X.values.reshape(-1).index_select(0, plan.src).to(torch.float32)
    if square:
        v = v * v
    rr = r.index_select(0, plan.rows)
    return segment_sums(plan, v[:, None] * rr if r.dim() == 2 else v * rr)


def _slot_matvec(X: SlotRows, w: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` (a row pass) of every local slot's shard on its own device
    (w copied there once per device), the margins assembled in slot order
    on the home device: (n_local,) or (n_local, G)."""
    mesh, s = X.mesh, X.rows_per_slot
    out = torch.empty((X.n_local_rows,) + tuple(w.shape[1:]),
                      dtype=torch.float32, device=mesh.home)
    on: dict = {}
    for k, (part, dev) in enumerate(zip(X.parts, mesh.slot_devices)):
        if dev not in on:
            on[dev] = w.to(dev)
        out[k * s:(k + 1) * s] = fn(part, on[dev])
    return out


def _slot_rmatvec(X: SlotRows, r, fn) -> SlotParts:
    """``fn`` (a transpose pass) of every local slot's shard against its
    rows of ``r`` (the local rows, slot-major, on the home device, or one
    tensor per slot — `ops.objective.slot_map`'s): one partial per slot,
    left on its device for the evaluation's one reduction
    (`parallel.mesh.psum`)."""
    s = X.rows_per_slot
    if not isinstance(r, SlotParts):
        r = [r[k * s:(k + 1) * s] for k in range(len(X.parts))]
    return SlotParts(fn(part, rk.to(dev)) for part, dev, rk in
                     zip(X.parts, X.mesh.slot_devices, r))


def matvec(X, w: torch.Tensor) -> torch.Tensor:
    """X @ w -> (n,) f32, the GLM margin (w (d, G) gives (n, G)).

    Dense storage multiplies in its own dtype and accumulates in f32.
    Sparse rows gather ``w[indices]`` and take the rowwise dot in f32.
    `BlockedEllRows` and `PermutedHybridRows` take w in their permuted
    space, `HybridRows` in original order. A row-sharded `SlotRows` gives
    this process's rows, slot by slot."""
    if isinstance(X, SlotRows):
        return _slot_matvec(X, w, matvec)
    if isinstance(X, BlockedEllRows):
        return _bell_matvec(X, w)
    if isinstance(X, PermutedHybridRows):
        return _perm_matvec(X, w)
    if isinstance(X, HybridRows):
        return _hybrid_matvec(X, w)
    if isinstance(X, SparseRows):
        eq = "nk,nkg->ng" if w.dim() == 2 else "nk,nk->n"
        return torch.einsum(eq, X.values.to(torch.float32),
                            w[X.indices.long()])
    if isinstance(X, EntityBlocks):
        raise TypeError("EntityBlocks are lane-minor per-entity blocks: "
                        "use matvec_lanes")
    return _mm_f32(X, w.to(X.dtype))


def rmatvec(X, r: torch.Tensor) -> torch.Tensor:
    """Xᵀ @ r -> (d,) f32, the gradient aggregation (f32 accumulation,
    storage-dtype operands as `matvec`; r (n, G) gives (d, G)). A
    `SlotRows` gives one partial per local slot (`SlotParts`)."""
    if isinstance(X, SlotRows):
        return _slot_rmatvec(X, r, rmatvec)
    if isinstance(X, PERMUTED_LAYOUTS):
        return _bell_rmatvec(X, r)
    if isinstance(X, HybridRows):
        return _hybrid_rmatvec(X, r)
    if isinstance(X, SparseRows):
        return _sparse_rmatvec(X, r)
    if isinstance(X, EntityBlocks):
        raise TypeError("EntityBlocks are lane-minor per-entity blocks: "
                        "use rmatvec_lanes")
    return _mm_f32(X.t(), r.to(X.dtype))


def matvec_lanes(X, W: torch.Tensor) -> torch.Tensor:
    """X @ W -> (n, G) f32 for LANE-MINOR coefficients W: (d, G), G
    contiguous (a `BlockedEllRows` W in its permuted space): the hot block
    (or dense X) as one (n, ·) × (·, G) product, the tail kernel gathering
    G contiguous floats per index; `SparseRows` gather (n, k, G). An
    `EntityBlocks` matrix gives each lane its own entity's rows: (m, E)."""
    if isinstance(X, EntityBlocks):
        return X.matvec_lanes(W)
    return matvec(X, W)


def rmatvec_lanes(X, R: torch.Tensor) -> torch.Tensor:
    """Xᵀ @ R -> (d, G) f32 for lane-minor per-row cotangents R: (n, G)
    (`EntityBlocks`: each lane's cotangent through its own rows)."""
    if isinstance(X, EntityBlocks):
        return X.rmatvec_lanes(R)
    return rmatvec(X, R)


def sq_rmatvec(X, r: torch.Tensor) -> torch.Tensor:
    """(X∘X)ᵀ @ r -> (d,): the Hessian-diagonal building block (per-slot
    partials for a `SlotRows`)."""
    if isinstance(X, SlotRows):
        return _slot_rmatvec(X, r, sq_rmatvec)
    if isinstance(X, PERMUTED_LAYOUTS):
        return _bell_rmatvec(X, r, square=True)
    if isinstance(X, HybridRows):
        return _hybrid_rmatvec(X, r, square=True)
    if isinstance(X, SparseRows):
        return _sparse_rmatvec(X, r, square=True)
    return _mm_f32(X.t(), r.to(X.dtype), square=True)


def sq_rmatvec_lanes(X, R: torch.Tensor) -> torch.Tensor:
    """(X∘X)ᵀ @ R -> (d, G) for lane-minor R: (n, G)."""
    if isinstance(X, EntityBlocks):
        return X.rmatvec_lanes(R, square=True)
    return sq_rmatvec(X, R)


MAX_GRAM_FEATURES = 20_000


def _gram_too_wide(X, d: int) -> None:
    if d > MAX_GRAM_FEATURES:
        raise ValueError(
            f"weighted_gram densifies {type(X).__name__}: d={d} exceeds "
            f"MAX_GRAM_FEATURES={MAX_GRAM_FEATURES}; use hess_diag/SIMPLE "
            "variances for large feature spaces")


def _densify(X) -> torch.Tensor:
    """An f32 (n, d) copy of a sparse layout (a permuted layout in its
    permuted space, the space of every other X pass on it)."""
    n, d = X.shape
    if isinstance(X, PERMUTED_LAYOUTS):
        dev = X.dense.device
        rows = torch.zeros((n, d), dtype=torch.float32, device=dev)
        rows[:, :X.d_sel] += X.dense.to(torch.float32)
        off = X.d_sel
        for br, bv in zip(X.bucket_rows, X.bucket_vals):
            c_b = br.shape[0]
            cols = torch.arange(off, off + c_b, device=dev)[:, None]
            rows.index_put_((br.long(), cols.expand_as(br)),
                            bv.to(torch.float32), accumulate=True)
            off += c_b
        return rows
    if isinstance(X, HybridRows):
        rows = torch.zeros((n, d), dtype=torch.float32,
                           device=X.dense.device)
        rows[:, X.dense_cols.long()] += X.dense.to(torch.float32)
        rows.index_put_((X.tail_rows.long(), X.tail_cols.long()),
                        X.tail_vals.to(torch.float32), accumulate=True)
        return rows
    rows = torch.zeros((n, d), dtype=torch.float32,
                       device=X.values.device)
    ridx = torch.arange(n, device=rows.device)[:, None].expand_as(X.indices)
    rows.index_put_((ridx, X.indices.long()),
                    X.values.to(torch.float32), accumulate=True)
    return rows


def weighted_gram(X, r: torch.Tensor) -> torch.Tensor:
    """Xᵀ diag(r) X -> (d, d) f32, for FULL variances on small feature
    spaces. Sparse layouts are densified (a permuted one in its permuted
    space), so d is capped at `MAX_GRAM_FEATURES` (the reference's guard);
    dense storage is taken in f32 whatever its dtype. A `SlotRows` gives
    per-slot partials."""
    if isinstance(X, SlotRows):
        return _slot_rmatvec(X, r, weighted_gram)
    if isinstance(X, (SparseRows,) + SINGLE_DEVICE_LAYOUTS):
        _gram_too_wide(X, X.n_features)
        rows = _densify(X)
    else:
        rows = X.to(torch.float32)
    return (rows * r[:, None]).t() @ rows


def _host_col(dense, j: int) -> np.ndarray:
    """Column ``j`` on the host, sliced before the transfer."""
    col = dense[:, j]
    if isinstance(col, torch.Tensor):
        return col.to(torch.float32).cpu().numpy()
    return np.asarray(col)


def last_column_is_intercept(X) -> bool:
    """True when the design matrix's last column is constant 1 — the
    intercept-last convention of the feature builders."""
    if isinstance(X, PERMUTED_LAYOUTS):
        if X.last_col_pos < X.d_sel:  # an intercept is maximally hot
            return bool((_host_col(X.dense, X.last_col_pos) == 1.0).all())
        if X.last_col_pos >= X.n_prefix:
            return False  # untouched by these rows: it has zeros
        # a column in every row may still sit in the tail (ties in the hot
        # selection): n entries, all 1.0, rows a permutation of range(n)
        n = X.dense.shape[0]
        off = X.d_sel
        for br, bv in zip(X.bucket_rows, X.bucket_vals):
            c_b = br.shape[0]
            if X.last_col_pos < off + c_b:
                r = _host(br[X.last_col_pos - off])
                v = _host(bv[X.last_col_pos - off].to(torch.float32))
                real = v != 0.0
                return bool(int(real.sum()) == n and (v[real] == 1.0).all()
                            and (np.sort(r[real]) == np.arange(n)).all())
            off += c_b
        return False
    if isinstance(X, HybridRows):
        d = X.n_features
        cols = _host(X.dense_cols)
        if d - 1 in cols:  # an intercept is maximally hot: dense block
            return bool((_host_col(X.dense, int(np.flatnonzero(
                cols == d - 1)[0])) == 1.0).all())
        tc = _host(X.tail_cols)
        tv = _host(X.tail_vals.to(torch.float32))
        hit = (tc == d - 1) & (tv != 0.0)
        per_row = np.zeros(X.shape[0], bool)
        per_row[_host(X.tail_rows)[hit]] = True
        return bool(per_row.all() and (tv[hit] == 1.0).all())
    if isinstance(X, SparseRows):
        d = X.n_features
        ind = _host(X.indices)
        val = X.values
        val = _host(val.to(torch.float32) if isinstance(val, torch.Tensor)
                    else val)
        hit = (ind == d - 1) & (val != 0.0)
        return bool(hit.any(axis=1).all() and (val[hit] == 1.0).all())
    return bool((_host_col(X, X.shape[1] - 1) == 1.0).all())


def nnz_stats(X) -> tuple:
    """(rows, stored entries) of a design matrix, as the reference counts
    them: padded slots for `SparseRows`, the hot block plus the tail for
    the permuted and blocked-ELL layouts, n·d otherwise."""
    n = int(X.shape[0])
    if isinstance(X, SparseRows):
        return n, int(np.prod(tuple(X.values.shape)))
    if isinstance(X, PermutedHybridRows):
        return n, int(np.prod(tuple(X.dense.shape))) + int(
            X.tail_vals.shape[0])
    if isinstance(X, (BlockedEllRows, ShardedBlockedEllRows)):
        return n, int(np.prod(tuple(X.dense.shape))) + X.tail_nnz
    return n, int(np.prod(tuple(X.shape)))


# ------------------------------------------------ sorted segment sums
_SCAN_BLOCK = 1024


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 whose bits do not depend on the
    run. ``torch.cumsum`` of a float CUDA tensor with one column is one
    CUB device scan (decoupled look-back), whose additions group by the
    timing of its blocks: the same input gives other bits from call to
    call. Several columns scan one thread per column, in row order: a
    fixed order, but as many dependent steps as rows. Both take
    `_blocked_prefix_sum` on the card. The CPU's scan is sequential and
    keeps ``torch.cumsum``."""
    if x.is_cuda and x.is_floating_point() and (
            x.dim() in (1, 2) or x[0].numel() == 1):
        return _blocked_prefix_sum(x)
    return torch.cumsum(x, dim=0)


def _blocked_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """`prefix_sum` in a fixed order: the rows cut into blocks of 1,024,
    each block scanned along its rows, and the block totals prefix-summed
    the same way, recursively, then added back. One column scans as a
    flat vector (each block one row of 1,024 values); (n, G) columns as
    (blocks, 1,024, G), one thread per block and column."""
    v = x.reshape(-1) if x.dim() == 1 or x[0].numel() == 1 else x
    n, rest = int(v.shape[0]), tuple(v.shape[1:])
    m = _SCAN_BLOCK
    rows = max(-(-n // m), 1)
    pad = (0, 0) * len(rest) + (0, rows * m - n)
    blocks = torch.nn.functional.pad(v, pad).reshape((rows, m) + rest)
    if rows == 1:
        # a second block keeps the scan along the block (one block of one
        # column alone is the single-column case again)
        out = torch.cumsum(torch.cat([blocks, torch.zeros_like(blocks)]),
                           dim=1)[0]
    else:
        inner = torch.cumsum(blocks, dim=1)
        carry = _blocked_prefix_sum(inner[:, -1])
        out = torch.cat([inner[:1], inner[1:] + carry[:-1, None]]).reshape(
            (rows * m,) + rest)
    return out[:n].reshape(x.shape)


def _tail_rowsum(contrib: torch.Tensor,
                 row_bounds: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of flat contributions (m,) or (m, G) whose
    segment s spans ``row_bounds[s]:row_bounds[s + 1]``: cumulative-sum
    differences (`prefix_sum`: the same bits every run), no scatter."""
    zero = contrib.new_zeros((1,) + tuple(contrib.shape[1:]))
    cs = torch.cat([zero, prefix_sum(contrib)])
    b = cs[row_bounds]
    return b[1:] - b[:-1]


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sums for ids SORTED ascending (reference:
    `sorted_segment_sum`): the bounds by a binary search, the sums by
    cumulative-sum differences — no atomic or combining scatter, so the
    same bits on every run. ``data`` (m,) or (m, G); ``segment_ids``
    (m,) nondecreasing; returns (num_segments,) or (num_segments, G)."""
    ids = segment_ids.to(torch.int64)
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, dtype=torch.int64,
                          device=ids.device))
    return _tail_rowsum(data, bounds)


# ------------------------------------------------ SparseRows column sums
# A column's sorted slots are summed in chunks of this many: inside a
# chunk a segmented scan adds only slots of one column (a tree of adds, so
# no column's sum cancels against another's — a cumulative sum over T2's
# 17.3M slots would, and so would a difference of prefix sums inside a
# chunk), and a column whose run crosses chunks sums its chunk partials
# the same way at the next level, until one is left.
_SEG_CHUNK = 256
_SEGMENT_PLAN_BUILDS = 0


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The column sums of a `SparseRows` matrix (or of a `HybridRows`' flat
    tail), planned once: its live
    slots (value ≠ 0, so padding never touches column 0) sorted by column,
    stably, and the levels that sum each column's run. Indices are int32."""

    src: torch.Tensor  # (L,) flat slot of each live slot, in column order
    rows: torch.Tensor  # (L,) its row
    # per level: (padded length, its sorted columns as (·, _SEG_CHUNK)
    # padded with -1, the last position of each piece (a column's run
    # inside one chunk), the pieces that complete their column, those
    # columns, the pieces carried to the next level)
    levels: tuple
    n_features: int


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _plan_levels(keys: torch.Tensor) -> tuple:
    """The levels of sorted column ``keys`` (int64): each cuts every
    column's run at chunk bounds into pieces; a column with one piece is
    done, the pieces of the others are the next level's slots."""
    C = _SEG_CHUNK
    levels = []
    while keys.shape[0]:
        L = int(keys.shape[0])
        padded = -(-L // C) * C
        last = torch.arange(L, device=keys.device) % C == C - 1
        last[-1] = True
        last[:-1] |= keys[:-1] != keys[1:]
        ends = torch.nonzero(last).squeeze(1)
        pk = keys[ends]
        alone = torch.ones_like(last[:pk.shape[0]])
        alone[1:] &= pk[1:] != pk[:-1]
        alone[:-1] &= pk[:-1] != pk[1:]
        done = torch.nonzero(alone).squeeze(1)
        carry = torch.nonzero(~alone).squeeze(1)
        grid = torch.full((padded,), -1, dtype=torch.int32,
                          device=keys.device)
        grid[:L] = keys
        levels.append((padded, grid.reshape(-1, C), _i32(ends), _i32(done),
                       _i32(pk[done]), _i32(carry)))
        keys = pk[carry]
    return tuple(levels)


def segment_plan(X) -> SegmentPlan:
    """The `SegmentPlan` of a `SparseRows` (its padded slots) or of a
    `HybridRows` (its flat tail), built on the first call for this matrix
    object (on its device) and kept with it."""
    global _SEGMENT_PLAN_BUILDS
    if X.plan is None:
        if isinstance(X, HybridRows):
            cols, vals = X.tail_cols, X.tail_vals
        else:
            cols, vals = X.indices.reshape(-1), X.values.reshape(-1)
        live = torch.nonzero(vals != 0).squeeze(1)
        keys, order = torch.sort(cols.long()[live], stable=True)
        src = live[order]
        rows = (X.tail_rows.index_select(0, src)
                if isinstance(X, HybridRows) else
                torch.div(src, X.indices.shape[1], rounding_mode="floor"))
        object.__setattr__(X, "plan", SegmentPlan(
            _i32(src), _i32(rows), _plan_levels(keys), X.n_features))
        _SEGMENT_PLAN_BUILDS += 1
    return X.plan


def segment_plan_builds() -> int:
    """How many `SegmentPlan`s this process has built."""
    return _SEGMENT_PLAN_BUILDS


def segment_sums(plan: SegmentPlan, x: torch.Tensor) -> torch.Tensor:
    """Per-column sums of ``x`` (L,) or (L, G), f32 in the plan's slot
    order: (n_features,) or (n_features, G), zeros where a column has no
    live slot. Each level scans its chunks (log2 `_SEG_CHUNK` passes, each
    adding a slot's partial into the slot ``off`` after it where both hold
    one column), so every sum is a fixed tree of adds of one column's
    values: the same bits on every run."""
    C = _SEG_CHUNK
    lanes = tuple(x.shape[1:])
    tail = (1,) * len(lanes)
    out = torch.zeros((plan.n_features,) + lanes, dtype=torch.float32,
                      device=x.device)
    for padded, keys, ends, done, cols, carry in plan.levels:
        if padded > x.shape[0]:
            x = torch.cat([x, x.new_zeros((padded - x.shape[0],) + lanes)])
        x = x.reshape((-1, C) + lanes)
        off = 1
        while off < C:
            same = (keys[:, off:] == keys[:, :-off]).reshape(
                (keys.shape[0], C - off) + tail)
            x = torch.cat([x[:, :off], x[:, off:] + torch.where(
                same, x[:, :-off], 0.0)], dim=1)
            off *= 2
        pieces = x.reshape((-1,) + lanes).index_select(0, ends)
        out[cols] = pieces.index_select(0, done)
        x = pieces.index_select(0, carry)
    return out


# ------------------------------------------------ per-entity blocks
def _column_segments(indices: torch.Tensor, n_features: int) -> tuple:
    """The plan of a sparse entity block's column sums: each lane's
    (m·k) slots sorted by column (stable: slot order within a column),
    as ``order`` (L, E) and the sorted columns ``keys`` (L, E), and
    ``last`` (d, E), the sorted position of each column's last slot in
    each lane (L where the lane has none)."""
    m, k, E = indices.shape
    L = m * k
    keys, order = torch.sort(indices.reshape(L, E).long(), dim=0,
                             stable=True)
    end = torch.ones((L, E), dtype=torch.bool, device=indices.device)
    end[:-1] = keys[:-1] != keys[1:]
    pos = torch.arange(L, device=indices.device)[:, None].expand(L, E)
    # every slot but a column's last writes row d, which is dropped:
    # each kept row has one writer
    last = torch.full((n_features + 1, E), L, dtype=torch.int64,
                      device=indices.device)
    last.scatter_(0, torch.where(end, keys, n_features), pos.contiguous())
    return order, keys.to(torch.int32), last[:n_features].contiguous()


@dataclasses.dataclass(frozen=True)
class EntityBlocks:
    """E entities' padded row blocks as one lane-minor design matrix: lane
    e is entity e, and a lane pass multiplies each lane by its own
    entity's rows (the reference `vmap`s one solve over the entity axis;
    the port runs its lane solvers with lanes = entities).

    Either ``dense`` (m, d, E) rows, or padded COO ``indices``/``values``
    (m, k, E) over ``n_features`` columns; E is the contiguous axis, as
    every lane tensor of the lane solvers. Padding rows carry weight 0 in
    the batch (and zero values here). Every pass sums in an order fixed
    by the block alone (no two adds race for one output), so a solve
    gives the same bits on every run.

    A regularization grid over the entities (`game.grid`) runs G lanes
    per entity: with ``lanes_per_entity`` G the block has E·G lanes,
    entity-major, and lane l reads the rows of entity l // G — the block
    itself is shared by an entity's G lanes, never copied (`grid`)."""

    dense: torch.Tensor | None
    indices: torch.Tensor | None
    values: torch.Tensor | None
    n_features: int
    # the sparse form's `_column_segments`, built once with the block
    segments: tuple | None = dataclasses.field(default=None, compare=False,
                                               repr=False)
    lanes_per_entity: int = 1

    def __post_init__(self):
        if self.indices is not None and self.segments is None:
            object.__setattr__(self, "segments", _column_segments(
                self.indices, self.n_features))

    def lanes(self, lo: int, hi: int) -> "EntityBlocks":
        """Entities lo..hi (with their lanes) as a block of their own (its
        plan sliced, not rebuilt)."""
        def cut(t):
            return None if t is None else t[..., lo:hi].contiguous()

        return EntityBlocks(cut(self.dense), cut(self.indices),
                            cut(self.values), self.n_features,
                            None if self.segments is None else
                            tuple(cut(t) for t in self.segments),
                            self.lanes_per_entity)

    def take(self, idx, pad_lanes: int | None = None) -> "EntityBlocks":
        """Entities ``idx`` (in that order) as a block of ``pad_lanes``
        entities, zero entities after them: the lane-minor counterpart of
        `parallel.mesh.compact_rows` (lanes are the last axis here). The
        sparse form's plan is gathered along the lanes, not rebuilt; a
        zero entity (indices 0, values 0) gets the plan of an all-zero
        lane, so its slots still sort by column."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.asarray(idx, np.int64).reshape(-1))
        src = self.dense if self.dense is not None else self.indices
        idx = idx.long().to(src.device)
        n = int(idx.shape[0])
        pad = n if pad_lanes is None else int(pad_lanes)
        if pad < n:
            raise ValueError(f"pad_lanes={pad} is below the {n} taken")

        def cut(t, fill=None):
            if t is None:
                return None
            g = t.index_select(t.dim() - 1, idx)
            if pad == n:
                return g.contiguous()
            if fill is None:
                fill = t.new_zeros(tuple(t.shape[:-1]) + (1,))
            return torch.cat([g, fill.expand(tuple(t.shape[:-1])
                                             + (pad - n,))], dim=-1)

        segments = None
        if self.segments is not None:
            m, k, _ = self.indices.shape
            zero = _column_segments(self.indices.new_zeros((m, k, 1)),
                                    self.n_features)
            segments = tuple(cut(t, z) for t, z in zip(self.segments, zero))
        return EntityBlocks(cut(self.dense), cut(self.indices),
                            cut(self.values), self.n_features, segments,
                            self.lanes_per_entity)

    def to(self, device) -> "EntityBlocks":
        """The same block on ``device`` (a no-op for tensors there)."""
        def mv(t):
            return None if t is None else t.to(device)

        return EntityBlocks(mv(self.dense), mv(self.indices),
                            mv(self.values), self.n_features,
                            None if self.segments is None else
                            tuple(mv(t) for t in self.segments),
                            self.lanes_per_entity)

    def grid(self, G: int) -> "EntityBlocks":
        """The same block with G lanes per entity (the tensors shared)."""
        return dataclasses.replace(self, lanes_per_entity=int(G))

    def _by_entity(self, W: torch.Tensor) -> torch.Tensor:
        """A lane tensor (·, E·G) as its (·, E, G) view."""
        return W.reshape(W.shape[0], -1, self.lanes_per_entity)

    def _rows(self, Wv: torch.Tensor) -> torch.Tensor:
        """The (m, k, E, G) gathered coefficients of the sparse form, from
        (d, E, G) lanes."""
        m, k, E = self.indices.shape
        idx = self.indices.reshape(m * k, E, 1).long().expand(
            m * k, E, Wv.shape[2])
        return torch.gather(Wv, 0, idx).reshape(m, k, E, -1)

    def _f32(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.dtype == torch.float32 else t.to(torch.float32)

    def matvec_lanes(self, W: torch.Tensor) -> torch.Tensor:
        """(m, E·G): z[i, l] = Σ_j X_e[i, j] W[j, l], e = l // G."""
        Wv = self._by_entity(W)
        if self.dense is not None:
            Wc = self._f32(Wv.to(self.dense.dtype))
            z = torch.sum(self._f32(self.dense)[..., None] * Wc[None], dim=1)
        else:
            z = torch.sum(self._f32(self.values)[..., None] * self._rows(Wv),
                          dim=1)
        return z.reshape(z.shape[0], -1)

    def rmatvec_lanes(self, R: torch.Tensor,
                      square: bool = False) -> torch.Tensor:
        """(d, E·G): each lane's Xᵀr (or (X∘X)ᵀr) over its entity's rows.
        The sparse form sums each column's slots by a segmented scan over
        the entity's slots sorted by column (log2(m·k) passes)."""
        Rv = self._by_entity(R)
        G = Rv.shape[2]
        if self.dense is not None:
            X = self._f32(self.dense)
            if square:
                X = X * X
            Rc = self._f32(Rv.to(self.dense.dtype))
            out = torch.sum(X[..., None] * Rc[:, None], dim=0)
            return out.reshape(out.shape[0], -1)
        v = self._f32(self.values)
        if square:
            v = v * v
        m, k, E = self.indices.shape
        L = m * k
        order, keys, last = (t[..., None] for t in self.segments)
        x = torch.gather((v[..., None] * Rv[:, None]).reshape(L, E, G), 0,
                         order.expand(L, E, G))
        off = 1
        while off < L:  # x[p] += x[p - off] within p's column
            x = torch.cat([x[:off], x[off:] + torch.where(
                keys[off:] == keys[:-off], x[:-off], 0.0)])
            off *= 2
        x = torch.cat([x, x.new_zeros((1, E, G))])
        out = torch.gather(x, 0, last.expand(last.shape[0], E, G))
        return out.reshape(out.shape[0], -1)

    def weighted_gram_lanes(self, R: torch.Tensor) -> torch.Tensor:
        """(E·G, d, d): each lane's Xᵀ diag(r) X, f32."""
        Rv = self._by_entity(R)
        if self.dense is not None:
            X = self._f32(self.dense)
        else:
            _gram_too_wide(self, self.n_features)
            m, k, E = self.indices.shape
            X = torch.zeros((m, self.n_features, E), dtype=torch.float32,
                            device=R.device)
            v = self._f32(self.values)
            for s in range(k):  # one writer per cell in each pass
                X.scatter_add_(1, self.indices[:, s:s + 1],
                               v[:, s:s + 1])
        H = torch.einsum("mde,meg,mfe->egdf", X, Rv, X)
        return H.reshape((-1,) + tuple(H.shape[2:]))


def next_pow2(x: int, floor: int = 2) -> int:
    """Smallest power of two ≥ x (≥ floor)."""
    m = floor
    while m < x:
        m *= 2
    return m


def quantize_rows(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` ≥ n (≥ quantum) — the linear rung of
    the height ladder (the scoring driver's chunks, which cluster around
    one chunk size); open-ended heights bucket by `next_pow2`."""
    q = int(quantum)
    return max((max(int(n), 1) + q - 1) // q * q, q)


def from_scipy_csr(csr, k: int | None = None,
                   strict: bool = False) -> SparseRows:
    """Pad a scipy CSR matrix to fixed nnz-per-row, vectorized (the
    reference's `from_scipy_csr`, the same arrays): a numpy-backed
    `SparseRows` (the port's ingest stays on the host).

    If ``k`` is smaller than some row's nnz, the row keeps its k
    largest-|value| entries and a UserWarning reports how many rows were
    truncated and what fraction of the total |value| mass was dropped;
    ``strict=True`` raises ValueError instead."""
    n, d = csr.shape
    indptr = np.asarray(csr.indptr)
    row_nnz = np.diff(indptr)
    max_nnz = int(row_nnz.max()) if n else 0
    if k is None:
        k = max(1, max_nnz)
    col = np.asarray(csr.indices)
    dat = np.asarray(csr.data, np.float32)
    row = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    truncating = max_nnz > k
    if truncating:
        # within each row by descending |value|: the first k are kept
        order = np.lexsort((-np.abs(dat), row))
        col, dat, row = col[order], dat[order], row[order]
    pos = np.arange(row.shape[0], dtype=np.int64) - np.repeat(
        indptr[:-1].astype(np.int64), row_nnz)
    keep = pos < k
    if truncating:
        n_trunc = int((row_nnz > k).sum())
        n_drop = int((~keep).sum())
        total_mass = float(np.abs(dat).sum())
        frac = float(np.abs(dat[~keep]).sum()) / total_mass \
            if total_mass > 0.0 else 0.0
        detail = (f"{n_trunc} rows exceed k={k} nnz (max row nnz = "
                  f"{max_nnz}); dropping {n_drop} smallest-|value| entries "
                  f"= {frac:.4%} of the total |value| mass")
        if strict:
            raise ValueError(f"from_scipy_csr(strict=True): {detail}")
        warnings.warn(
            f"from_scipy_csr: {detail}; keeping the k largest-|value| "
            "entries per row", stacklevel=2)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), np.float32)
    indices[row[keep], pos[keep]] = col[keep]
    values[row[keep], pos[keep]] = dat[keep]
    return SparseRows(indices, values, d)


def quantize_blocks(block, mode: str = "int8"):
    """Row-wise symmetric quantization of a serving coefficient block.

    ``block``: a (d,) fixed-effect vector (ONE scale) or an (E + 1, d)
    random-effect block (one scale PER ROW).

    ``mode="int8"`` → ``(q int8, scales f32)`` numpy, ``scales =
    max|row| / 127`` and ``q = round(row / scale)``; dequant is
    ``q * scale``. All-zero rows (the cold-miss row E) take scale 1.0 so
    they dequantize to EXACT zeros. ``mode="bf16"`` → ``(q, None)`` with
    ``q`` a CPU `torch.bfloat16` tensor (round to nearest even, as the
    reference's cast)."""
    arr = np.ascontiguousarray(np.asarray(block, np.float32))
    if mode == "bf16":
        return torch.from_numpy(arr).to(torch.bfloat16), None
    if mode != "int8":
        raise ValueError(f"quantize mode must be 'int8' or 'bf16', "
                         f"got {mode!r}")
    vec = arr.ndim == 1
    rows = arr[None] if vec else arr
    scales = np.abs(rows).max(axis=1) / 127.0
    scales = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    if vec:
        return q[0], np.float32(scales[0])
    return q, scales


# ----------------------------------------------------------------- contracts
# The blocked-ELL law, registered next to the layout it pins: both X passes
# run no combining scatter, and every bf16 product accumulates f32.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import SCATTER_PRIMITIVES  # noqa: E402


def _contract_blocked_ell(device, n=256, d=512, k=8, d_dense=64,
                          bf16=False) -> BlockedEllRows:
    """A small zipf blocked-ELL matrix (hot block, a multi-width ELL tail
    and occurrence buckets all populated, an intercept column last);
    ``bf16`` casts its storage as `dataset.cast_features` does."""
    rng = np.random.default_rng(0)
    col = (rng.zipf(1.5, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    ind = np.concatenate([col, np.full((n, 1), d - 1)], 1).astype(np.int32)
    va = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    X = to_blocked_ell(SparseRows(ind, va, d), d_dense, device=device)
    return X.astype(torch.bfloat16) if bf16 else X


def _contract_vectors(X, device, lanes=None):
    rng = np.random.default_rng(1)
    n, d = X.shape
    shape = () if lanes is None else (lanes,)
    w = torch.from_numpy(rng.normal(size=(d,) + shape).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(n,) + shape).astype(np.float32))
    return w.to(device), r.to(device)


@register_contract(
    name="blocked_ell_x_passes",
    description="BlockedEllRows matvec + rmatvec (bf16 storage) as one "
                "call: no combining scatter in either X pass, every bf16 "
                "product accumulating f32",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("resident", "sparse"))
def _contract_blocked_ell_x_passes(device):
    X = _contract_blocked_ell(device, bf16=True)
    w, r = _contract_vectors(X, device)

    def both(Xb, wv, rv):
        z = matvec(Xb, wv)             # X pass 1: the margin
        return z, rmatvec(Xb, rv * z)  # X pass 2: the gradient backprop

    return both, (X, w, r)


@register_contract(
    name="blocked_ell_lane_x_passes",
    description="BlockedEllRows lane-minor X passes (matvec_lanes + "
                "rmatvec_lanes, G=4, bf16 storage): no combining scatter, "
                "f32 accumulation — the reg-sweep form of the same law",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("resident", "lane", "sparse"))
def _contract_blocked_ell_lane_x_passes(device):
    X = _contract_blocked_ell(device, bf16=True)
    W, R = _contract_vectors(X, device, lanes=4)

    def both(Xb, Wv, Rv):
        Z = matvec_lanes(Xb, Wv)
        return Z, rmatvec_lanes(Xb, Rv * Z)

    return both, (X, W, R)
