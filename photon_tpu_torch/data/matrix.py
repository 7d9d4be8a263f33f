"""Design-matrix representations (port of the serving subset of
`photon_tpu/data/matrix.py`).

- dense: a plain (n, d) tensor;
- `SparseRows`: padded per-row COO — (n, k) int32 indices + (n, k) f32
  values, rows padded to k slots with (index 0, value 0).

`quantize_blocks` stays numpy on the host, so its int8 blocks and scales
equal the JAX package's bit for bit; only the bf16 form leaves numpy (as a
CPU `torch.bfloat16` tensor, since numpy has no bfloat16).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparseRows:
    indices: torch.Tensor  # (n, k) int32, padded with 0
    values: torch.Tensor  # (n, k) f32, padded with 0.0
    n_features: int

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_features)

    def to(self, device, non_blocking: bool = False) -> "SparseRows":
        """The same rows as tensors on ``device`` (numpy inputs are
        wrapped first)."""
        return SparseRows(as_tensor(self.indices, device, non_blocking),
                          as_tensor(self.values, device, non_blocking),
                          self.n_features)


def as_tensor(a, device, non_blocking: bool = False) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a tensor on ``device``. A pinned
    host tensor uploads asynchronously when ``non_blocking``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=non_blocking)


def matvec(X, w: torch.Tensor) -> torch.Tensor:
    """X @ w -> (n,) f32, the GLM margin.

    Dense bf16 storage multiplies bf16 operands and accumulates in f32
    (a bf16×bf16 product is exact in f32, so upcasting both operands
    before the f32 matmul is the same arithmetic). Sparse rows gather
    ``w[indices]`` and take the rowwise dot in f32."""
    if isinstance(X, SparseRows):
        return torch.einsum("nk,nk->n", X.values.to(torch.float32),
                            w[X.indices.long()])
    return torch.matmul(X.to(torch.float32),
                        w.to(X.dtype).to(torch.float32))


def next_pow2(x: int, floor: int = 2) -> int:
    """Smallest power of two ≥ x (≥ floor)."""
    m = floor
    while m < x:
        m *= 2
    return m


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
