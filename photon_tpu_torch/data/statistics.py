"""Per-feature summary statistics (the port's copy of
`photon_tpu/data/statistics.py`).

Reference parity: com.linkedin.photon.ml.stat.{BasicStatistics,
BasicStatisticalSummary} / FeatureDataStatistics — per-feature mean,
variance, min, max, |x|max, L1/L2 norms and nonzero counts over the whole
dataset (the GAME training driver can persist the summary, and
NormalizationContext is built from it).

`compute` is one device pass, as the reference's: f32 sums, then the
mean and variance in f64. Dense matrices reduce by column; `SparseRows`
sum each column's live slots through the matrix's sorted segments (the
plan its Xᵀr uses: no atomic add decides a sum), with implicit zeros
folded in afterwards — a column whose nonzero count is below the row
count includes 0 in its min/max, matching the reference's full-vector
semantics. The streamed reads summarize each host chunk with
`compute_host` (numpy, f64) and fold the chunks with `merge` (Chan's
parallel update).
"""
from __future__ import annotations

import dataclasses
import json
from functools import partial

import numpy as np
import torch

from photon_tpu_torch.checkpoint.store import commit_bytes
from photon_tpu_torch.data.matrix import (BlockedEllRows, SparseRows,
                                          as_tensor, segment_plan,
                                          segment_sums)
from photon_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FeatureSummary:
    """Reference: BasicStatisticalSummary's per-feature vectors."""

    count: int  # rows (full vectors, incl. implicit sparse zeros)
    mean: np.ndarray  # (d,) float64
    variance: np.ndarray  # (d,) float64 population variance
    minimum: np.ndarray  # (d,)
    maximum: np.ndarray  # (d,)
    abs_max: np.ndarray  # (d,) max |x| (SCALE_WITH_MAX_MAGNITUDE input)
    norm_l1: np.ndarray  # (d,) sum |x|
    norm_l2: np.ndarray  # (d,) sqrt(sum x^2)
    num_nonzeros: np.ndarray  # (d,) int64

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)

    # ------------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """One JSON document (small: 8 vectors of d floats) — the analog of
        the reference driver's summarization output Avro. Committed
        atomically: a normalization context derived from a torn summary
        would silently skew every downstream solve."""
        doc = {"count": self.count}
        for f in dataclasses.fields(self):
            if f.name != "count":
                doc[f.name] = np.asarray(getattr(self, f.name),
                                         np.float64).tolist()
        commit_bytes(path, json.dumps(doc).encode())

    @staticmethod
    def load(path: str) -> "FeatureSummary":
        with open(path) as fh:
            doc = json.load(fh)
        kwargs = {"count": int(doc["count"])}
        for f in dataclasses.fields(FeatureSummary):
            if f.name == "count":
                continue
            dt = np.int64 if f.name == "num_nonzeros" else np.float64
            kwargs[f.name] = np.asarray(doc[f.name], dt)
        return FeatureSummary(**kwargs)

    # ----------------------------------------------------------------- merging
    def merge(self, other: "FeatureSummary") -> "FeatureSummary":
        """Combine two summaries of disjoint row sets into the summary of
        their union (reference: the treeAggregate combOp over per-partition
        summarizers). Means/variances merge with Chan's parallel update in
        float64, so a chunk-streamed summary matches the one-shot pass to
        ~1e-12 relative — this is what lets the streaming drivers build
        normalization contexts without materializing the dataset."""
        na, nb = self.count, other.count
        n = na + nb
        delta = other.mean - self.mean
        mean = self.mean + delta * (nb / n)
        m2 = (self.variance * na + other.variance * nb
              + delta * delta * (na * nb / n))
        return FeatureSummary(
            count=n,
            mean=mean,
            variance=m2 / n,
            minimum=np.minimum(self.minimum, other.minimum),
            maximum=np.maximum(self.maximum, other.maximum),
            abs_max=np.maximum(self.abs_max, other.abs_max),
            norm_l1=self.norm_l1 + other.norm_l1,
            norm_l2=np.sqrt(self.norm_l2 ** 2 + other.norm_l2 ** 2),
            num_nonzeros=self.num_nonzeros + other.num_nonzeros,
        )

    # ------------------------------------------------------------ construction
    @staticmethod
    def compute_host(X) -> "FeatureSummary":
        """Numpy twin of `compute` for one host chunk — the streaming chunk
        hook (the chunk is decoded on the host and summarized there, with
        no device round trip). Accumulates in float64, so chunk merges
        match the one-shot pass to ~1e-12 relative."""
        if isinstance(X, SparseRows):
            n, d = X.shape
            idx = np.asarray(X.indices).reshape(-1)
            val = np.asarray(X.values, np.float64).reshape(-1)
            live = val != 0.0
            idx, val = idx[live], val[live]
            s1 = np.zeros(d)
            s2 = np.zeros(d)
            l1 = np.zeros(d)
            nnz = np.zeros(d, np.int64)
            np.add.at(s1, idx, val)
            np.add.at(s2, idx, val * val)
            np.add.at(l1, idx, np.abs(val))
            np.add.at(nnz, idx, 1)
            mn = np.full(d, np.inf)
            mx = np.full(d, -np.inf)
            np.minimum.at(mn, idx, val)
            np.maximum.at(mx, idx, val)
            # implicit zeros: all-zero columns and columns with nnz < n
            mn = np.where(nnz == 0, 0.0, mn)
            mx = np.where(nnz == 0, 0.0, mx)
            has_zero = nnz < n
            mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
            mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
            mean = s1 / n
            # mean-shifted second pass, like compute(): the one-pass
            # E[x²]−E[x]² form cancels catastrophically for large-mean,
            # small-variance columns. Stored entries contribute (v−μ)²;
            # the n−nnz implicit zeros contribute μ² each.
            c = val - mean[idx]
            ssq = np.zeros(d)
            np.add.at(ssq, idx, c * c)
            var = np.maximum((ssq + (n - nnz) * mean * mean) / n, 0.0)
        else:
            Xn = np.asarray(X, np.float64)
            n, d = Xn.shape
            mean = Xn.mean(0)
            var = np.mean((Xn - mean) ** 2, 0)
            mn = Xn.min(0)
            mx = Xn.max(0)
            l1 = np.abs(Xn).sum(0)
            s2 = (Xn * Xn).sum(0)
            nnz = np.count_nonzero(Xn, axis=0).astype(np.int64)
        return FeatureSummary(
            count=int(n), mean=mean, variance=var, minimum=mn, maximum=mx,
            abs_max=np.maximum(np.abs(mn), np.abs(mx)),
            norm_l1=l1, norm_l2=np.sqrt(s2), num_nonzeros=nnz)

    # ------------------------------------------------------------ construction
    @staticmethod
    def compute(X, mesh=None, device=None) -> "FeatureSummary":
        """Summarize a design matrix in one device pass, on the matrix's
        device when it holds tensors, else on ``device`` (default
        ``cuda``). Meshes wait for ROADMAP queue A item 10."""
        if mesh is not None:
            raise NotImplementedError(
                "FeatureSummary.compute over a mesh is not ported yet "
                "(ROADMAP queue A item 10)")
        if isinstance(X, BlockedEllRows):
            raise TypeError(
                "FeatureSummary.compute takes the original SparseRows/dense "
                "matrix, not a blocked-ELL re-layout; compute the summary "
                "before to_blocked_ell (the statistics are unaffected by "
                "storage re-layout)")
        n = X.shape[0]
        sparse = isinstance(X, SparseRows)
        held = X.values if sparse else X
        dev = (held.device if isinstance(held, torch.Tensor)
               else resolve_device(device))
        X = X.to(dev) if sparse else as_tensor(X, dev)
        out = _summarize_sparse(X) if sparse else _summarize_dense(X)
        s1, s2, mn, mx, l1, nnz = (v.cpu().numpy().astype(np.float64)
                                   for v in out)
        mean = s1 / n
        # Variance via a SECOND, mean-shifted pass: Σ(x−μ)² accumulates
        # small numbers, where the one-pass E[x²]−E[x]² form cancels
        # catastrophically in f32 for large-mean features.
        shift = torch.from_numpy(mean.astype(np.float32)).to(dev)
        if sparse:
            ssq = _shifted_ssq_sparse(X, shift).cpu().numpy().astype(
                np.float64)
            # stored entries contribute (v−μ)²; the n−nnz implicit zeros
            # contribute μ² each — no cancellation in either term.
            var = (ssq + (n - nnz) * mean * mean) / n
        else:
            var = _shifted_ssq_dense(X, shift).cpu().numpy().astype(
                np.float64) / n
        var = np.maximum(var, 0.0)
        # Fold implicit zeros into extrema (reference: full-vector summary).
        has_zero = nnz < n
        mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
        mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
        f64 = partial(np.asarray, dtype=np.float64)
        return FeatureSummary(
            count=n, mean=f64(mean), variance=f64(var), minimum=f64(mn),
            maximum=f64(mx), abs_max=f64(np.maximum(np.abs(mn), np.abs(mx))),
            norm_l1=f64(l1), norm_l2=f64(np.sqrt(s2)),
            num_nonzeros=np.asarray(nnz, np.int64))


def _shifted_ssq_dense(X: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    c = X.to(torch.float32) - shift[None, :]
    return torch.sum(c * c, 0)


def _live(X: SparseRows) -> tuple:
    """(f32 values, columns) of the live slots, in the plan's order."""
    plan = segment_plan(X)
    val = X.values.reshape(-1).index_select(0, plan.src).to(torch.float32)
    col = X.indices.reshape(-1).index_select(0, plan.src).long()
    return plan, val, col


def _shifted_ssq_sparse(X: SparseRows, shift: torch.Tensor) -> torch.Tensor:
    plan, val, col = _live(X)
    c = val - shift[col]
    return segment_sums(plan, c * c)


def _summarize_dense(X: torch.Tensor) -> tuple:
    Xf = X.to(torch.float32)
    return (torch.sum(Xf, 0), torch.sum(Xf * Xf, 0), torch.amin(Xf, 0),
            torch.amax(Xf, 0), torch.sum(torch.abs(Xf), 0),
            torch.sum(Xf != 0.0, 0))


def _summarize_sparse(X: SparseRows) -> tuple:
    """Column sums of the live slots (padding, value 0 at index 0, is not
    one) by sorted segments; minima and maxima by a combining scatter,
    whose result does not depend on the order of its updates; counts as
    integers."""
    plan, val, col = _live(X)
    d = X.n_features
    nnz = torch.bincount(col, minlength=d)
    empty = nnz == 0
    mn = torch.full((d,), float("inf"), device=val.device).scatter_reduce(
        0, col, val, reduce="amin")
    mx = torch.full((d,), float("-inf"), device=val.device).scatter_reduce(
        0, col, val, reduce="amax")
    # all-implicit-zero columns: their extrema are 0
    mn = torch.where(empty, 0.0, mn)
    mx = torch.where(empty, 0.0, mx)
    return (segment_sums(plan, val), segment_sums(plan, val * val), mn, mx,
            segment_sums(plan, torch.abs(val)), nnz)
