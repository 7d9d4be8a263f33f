"""The yardstick's table of peaks and its counts of the least work: what a
blocked-ELL X pass, a fit's X passes and its history sweeps must move and
compute, counted from the generated data alone, never from the program.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W power limit.

A pass reads each stored value and index once. The counts are of what the
data needs, so a share of a peak computed from them cannot exceed 100%
unless the time leaves part of the work out:

- the hot block: ``rows x d_dense`` cells of its storage dtype (2 B for
  bfloat16) on every X pass, and 2 FLOPs a cell and lane on the tensor
  cores;
- the tail on a matvec (the ELL kernel): each real tail entry's int32
  index and float32 value, the distinct tail coefficients it gathers
  (``U x lanes`` floats) and one float32 output a tail row and lane;
- the tail on an X^T r (the occurrence-bucket kernel): each real tail
  entry's int32 row id and float32 value, the cotangent rows it gathers
  (``tail rows x lanes`` floats) and one float32 output a distinct tail
  column and lane;
- a multiply-add (2 FLOPs) per tail entry and lane, in float32;
- the L-BFGS two-loop recursion: the S and Y slots held at that
  iteration, ``2 x slots x d x lanes`` floats of 4 B, and 4 FLOPs an
  element (a dot product and an update).

The byte count of the two tail kernels is the one of ``chip_smoke.py``'s
``blocked_ell_bounds`` (frozen here), taken over real entries in place of
the layout's padded slots, and without its ``row_pos`` read (a layout
detail, not a need of the data).
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12     # HBM3, 80 GB
BF16_FLOPS_PER_S = 989e12     # dense tensor-core bfloat16
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
F32, I32 = 4, 4


@dataclasses.dataclass(frozen=True)
class DataCounts:
    """What one generated matrix holds, under a hot block of ``d_dense``
    columns (the most frequent; ties to the lower column id)."""

    rows: int
    n_features: int
    d_dense: int
    hot_bytes_per_cell: int
    tail_nnz: int       # stored tail entries (a repeated id counts twice)
    tail_columns: int   # distinct tail columns (U)
    tail_rows: int      # rows with at least one tail entry


def count_data(indices: torch.Tensor, values: torch.Tensor, n_features: int,
               d_dense: int, hot_bytes_per_cell: int) -> DataCounts:
    """`DataCounts` of padded COO rows (on any device)."""
    live = values != 0
    counts = torch.bincount(indices[live].long(), minlength=n_features)
    order = torch.sort(-counts, stable=True).indices
    hot = torch.zeros(n_features, dtype=torch.bool, device=counts.device)
    hot[order[:min(d_dense, n_features)]] = True
    tail = live & ~hot[indices.long()]
    return DataCounts(
        rows=int(indices.shape[0]), n_features=n_features,
        d_dense=min(d_dense, n_features),
        hot_bytes_per_cell=hot_bytes_per_cell,
        tail_nnz=int(tail.sum()),
        tail_columns=int(((counts > 0) & ~hot).sum()),
        tail_rows=int(tail.any(1).sum()))


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes and FLOPs; ``dense`` FLOPs run on the tensor cores."""

    bytes: float = 0.0
    dense_flops: float = 0.0
    flops: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.dense_flops + o.dense_flops,
                    self.flops + o.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.dense_flops * k, self.flops * k)

    def least_s(self) -> tuple:
        """(seconds, "bytes" or "flops"): the least time the card needs."""
        tb = self.bytes / HBM_BYTES_PER_S
        tf = (self.dense_flops / BF16_FLOPS_PER_S
              + self.flops / F32_FLOPS_PER_S)
        return (tb, "bytes") if tb >= tf else (tf, "flops")


def tail_matvec(c: DataCounts, lanes: int) -> Work:
    return Work(bytes=c.tail_nnz * (I32 + F32)
                + F32 * lanes * (c.tail_columns + c.tail_rows),
                flops=2.0 * c.tail_nnz * lanes)


def bucket_rmatvec(c: DataCounts, lanes: int) -> Work:
    return Work(bytes=c.tail_nnz * (I32 + F32)
                + F32 * lanes * (c.tail_rows + c.tail_columns),
                flops=2.0 * c.tail_nnz * lanes)


def hot_product(c: DataCounts, lanes: int) -> Work:
    cells = c.rows * c.d_dense
    return Work(bytes=cells * c.hot_bytes_per_cell,
                dense_flops=2.0 * cells * lanes)


def history_sweeps(c: DataCounts, lanes: int, lockstep_iters: int,
                   history: int) -> Work:
    """The two-loop recursions of ``lockstep_iters`` iterations: before
    iteration i the history holds min(i, history) slots."""
    slots = sum(min(i, history) for i in range(lockstep_iters))
    elems = 2.0 * slots * c.n_features * lanes
    return Work(bytes=elems * F32, flops=4.0 * elems)


def fit_work(c: DataCounts, lanes: int, matvecs: int, rmatvecs: int,
             lockstep_iters: int, history: int) -> Work:
    """The least work of one fit that made ``matvecs`` X passes and
    ``rmatvecs`` X^T passes over ``lockstep_iters`` iterations."""
    hot = hot_product(c, lanes)
    return ((hot + tail_matvec(c, lanes)) * matvecs
            + (hot + bucket_rmatvec(c, lanes)) * rmatvecs
            + history_sweeps(c, lanes, lockstep_iters, history))
