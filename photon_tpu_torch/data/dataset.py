"""Labeled data containers (port of `GLMBatch`, `make_batch`, `pad_batch`,
`with_offsets`, `cast_features` and `total_weight` of
`photon_tpu/data/dataset.py`).

Reference parity: com.linkedin.photon.ml.data.LabeledPoint (label,
features, offset, weight). A GLMBatch is the whole dataset as tensors on
one device; rows of weight 0 are padding that every reduction ignores.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch.data.matrix import BlockedEllRows, SparseRows, as_tensor
from photon_tpu_torch.device import resolve_device


class GLMBatch(NamedTuple):
    X: object  # dense (n, d) tensor, SparseRows or BlockedEllRows
    y: torch.Tensor  # (n,)
    weights: torch.Tensor  # (n,) — 0.0 marks padding
    offsets: torch.Tensor  # (n,)

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    def to(self, device) -> "GLMBatch":
        """The same batch with every tensor on ``device`` (a no-op for
        tensors already there)."""
        return GLMBatch(self.X.to(device), self.y.to(device),
                        self.weights.to(device), self.offsets.to(device))


def _f32(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float32)
    return as_tensor(a, device).to(torch.float32)


def make_batch(X, y, weights=None, offsets=None, device=None) -> GLMBatch:
    """A batch on ``device`` (default ``cuda``). A dense X from numpy
    arrives as f32; a floating tensor keeps its storage dtype; layouts
    move as they are."""
    dev = resolve_device(device)
    y = _f32(y, dev)
    n = int(y.shape[0])
    if isinstance(X, (SparseRows, BlockedEllRows)):
        X = X.to(dev)
    elif isinstance(X, torch.Tensor) and X.is_floating_point():
        X = X.to(dev)
    else:
        X = as_tensor(np.asarray(X, np.float32), dev)
    weights = (torch.ones(n, dtype=torch.float32, device=dev)
               if weights is None else _f32(weights, dev))
    offsets = (torch.zeros(n, dtype=torch.float32, device=dev)
               if offsets is None else _f32(offsets, dev))
    return GLMBatch(X, y, weights, offsets)


def pad_batch(batch: GLMBatch, target_n: int) -> GLMBatch:
    """The batch grown to ``target_n`` rows with zero-weight padding rows
    (zero features, label, weight and offset), which every reduction
    ignores. A `BlockedEllRows` grows its hot block, and the new rows'
    ``row_pos`` point at the zero slot (no tail)."""
    n = batch.n
    if target_n == n:
        return batch
    if target_n < n:
        raise ValueError(f"cannot pad {n} rows down to {target_n}")
    extra = target_n - n
    X = batch.X

    def grow(t, fill=0):
        pad = torch.full((extra,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=t.device)
        return torch.cat([t, pad])

    if isinstance(X, BlockedEllRows):
        B = sum(int(v.shape[0]) for v in X.ell_vals)
        X = dataclasses.replace(X, dense=grow(X.dense),
                                row_pos=grow(X.row_pos, B))
    elif isinstance(X, SparseRows):
        X = SparseRows(grow(X.indices), grow(X.values), X.n_features)
    else:
        X = grow(X)
    return GLMBatch(X, grow(batch.y), grow(batch.weights),
                    grow(batch.offsets))


def with_offsets(batch: GLMBatch, offsets) -> GLMBatch:
    """The batch with new (n,) offsets (f32, on the batch's device)."""
    return batch._replace(offsets=_f32(offsets, batch.y.device))


def total_weight(batch: GLMBatch) -> float:
    return float(np.sum(batch.weights.cpu().numpy()))


def cast_features(batch: GLMBatch, dtype=torch.bfloat16) -> GLMBatch:
    """Recast feature STORAGE (dense X, SparseRows values, or every value
    leaf of a BlockedEllRows) — typically to bf16. The X passes then
    multiply in that dtype and accumulate in f32; labels, weights,
    offsets and all solver state stay f32."""
    X = batch.X
    if isinstance(X, BlockedEllRows):
        X = X.astype(dtype)
    elif isinstance(X, SparseRows):
        X = SparseRows(X.indices, X.values.to(dtype), X.n_features)
    else:
        X = X.to(dtype)
    return batch._replace(X=X)
