"""The int8 serving rung as one hand-written CUDA kernel (port of the Pallas
kernel `photon_tpu/kernels/serving.py::fused_int8_margin`).

`int8_margin` scores one whole int8 rung — offsets in, (B,) f32 margin
out, every coordinate's dequant + contraction in coordinate order — in
ONE launch of `csrc/serving_int8.cu`. `int8_margin_reference` is the plain
PyTorch version of the same function: the CPU path runs it, the tests
hold the JAX package against it, and `chip_smoke.py` holds the kernel
against it on the card. The inverse link applies outside, in the ladder.

Every int8 rung takes the kernel on the card (there is no VMEM budget to
fit, so no feasibility test as on the TPU). The kernel is built from the
source on first use with `torch.utils.cpp_extension.load` into
``kernels/_build/``. Its entry point is a plain C function bound with
ctypes: a source that includes PyTorch's headers takes minutes to compile,
a plain CUDA file seconds. A build or launch failure raises; nothing falls
back to the plain version on its own.

Operand contract (checked before the launch): every tensor contiguous, on
the offsets' device; offsets (B,) f32; a sparse shard (B, k) int32
indices + (B, k) f32 values, a dense shard (B, d) f32; fixed (q (d,) int8,
s (1,) f32); random (q (E+1, d) int8, s (E+1,) f32) with ids (B,) int32.
Indices must lie in [0, d) and ids in [0, E]: the dispatcher's collation
guarantees both.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch.data.matrix import SparseRows, matvec
from photon_tpu_torch.game.model import score_rows

KERNEL = "serving_int8"
SOURCE = Path(__file__).parent / "csrc" / "serving_int8.cu"
# CoordDesc in csrc/serving_int8.cu: one int64 per field, in this order
_DESC_FIELDS = ("kind", "sparse", "d", "k", "x", "idx", "ids", "q", "s")

_lib = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The built kernel library (built on first call; raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = K.load_library(SOURCE)
            fn = lib.photon_serving_int8_margin
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.photon_cuda_error_string.argtypes = [ctypes.c_int]
            lib.photon_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def int8_margin_reference(coords, offsets, shards, ids, fixed_ws, re_cs):
    """The plain PyTorch rung margin: per coordinate, dequant ``q·s`` then
    the fixed matvec or the per-entity gather + rowwise dot, summed in
    ``coords`` order from the offsets (the JAX rung's XLA body)."""
    f32 = torch.float32
    margin = offsets
    for name, kind, shard in coords:
        X = shards[shard]
        if kind == "fixed":
            q, s = fixed_ws[name]
            margin = margin + matvec(X, q.to(f32) * s)
        else:
            q, s = re_cs[name]
            e = ids[name].long()
            # row E carries scale 1.0 over zeros -> exact-zero cold rows
            margin = margin + score_rows(X, q[e].to(f32) * s[e][:, None])
    return margin


def int8_margin(coords, offsets, shards, ids, fixed_ws, re_cs):
    """The rung margin: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see `kernels` for the mode seam).

    ``coords`` is the ladder's ``((name, kind, feature_shard), ...)``."""
    if not K.use_kernel(offsets):
        return int8_margin_reference(coords, offsets, shards, ids,
                                     fixed_ws, re_cs)
    return _launch(coords, offsets, shards, ids, fixed_ws, re_cs)


def _check(t, dtype, shape, device, what: str) -> int:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.data_ptr()


def _launch(coords, offsets, shards, ids, fixed_ws, re_cs):
    dev = offsets.device
    B = int(offsets.shape[0])
    i32, f32 = torch.int32, torch.float32
    off_ptr = _check(offsets, f32, (B,), dev, "offsets")
    rows = []
    for name, kind, shard in coords:
        X = shards[shard]
        if kind == "fixed":
            q, s = fixed_ws[name]
            d = int(q.shape[0])
            q_ptr = _check(q, torch.int8, (d,), dev, f"{name} q")
            s_ptr = _check(s, f32, (1,), dev, f"{name} scale")
            ids_ptr = 0
        else:
            q, s = re_cs[name]
            e1, d = (int(n) for n in q.shape)
            q_ptr = _check(q, torch.int8, (e1, d), dev, f"{name} q")
            s_ptr = _check(s, f32, (e1,), dev, f"{name} scales")
            ids_ptr = _check(ids[name], i32, (B,), dev, f"{name} ids")
        if isinstance(X, SparseRows):
            k = int(X.indices.shape[1])
            idx_ptr = _check(X.indices, i32, (B, k), dev, f"{shard} indices")
            x_ptr = _check(X.values, f32, (B, k), dev, f"{shard} values")
        else:
            k, idx_ptr = 0, 0
            x_ptr = _check(X, f32, (B, d), dev, f"{shard} rows")
        rows.append((int(kind == "random"), int(k > 0), d, k, x_ptr,
                     idx_ptr, ids_ptr, q_ptr, s_ptr))
    desc = torch.tensor(rows, dtype=torch.int64).reshape(
        len(rows), len(_DESC_FIELDS)).pin_memory().to(dev, non_blocking=True)
    out = torch.empty(B, dtype=f32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.photon_serving_int8_margin(
            off_ptr, desc.data_ptr(), len(rows), B, out.data_ptr(), stream)
    if code:
        raise RuntimeError(
            f"{KERNEL} launch failed: "
            f"{lib.photon_cuda_error_string(code).decode()}")
    K.count_launch(KERNEL)
    return out
