"""The int8 serving rung as one hand-written CUDA kernel (port of the Pallas
kernel `photon_tpu/kernels/serving.py::fused_int8_margin`).

`int8_margin` scores one whole int8 rung — offsets in, (B,) f32 margin
out, every coordinate's dequant + contraction in coordinate order — with
`csrc/serving_int8.cu`: one launch per `MAX_COORDS` coordinates (one for
every rung the repo builds). `int8_margin_reference` is the plain PyTorch
version of the same function: the CPU path runs it, the tests hold the JAX
package against it, and `chip_smoke.py` holds the kernel against it on
the card. The inverse link applies outside, in the ladder.

Every int8 rung takes the kernel on the card (there is no VMEM budget to
fit, so no feasibility test as on the TPU). The kernel is built from the
source on first use with `torch.utils.cpp_extension.load` into
``kernels/_build/``. Its entry point is a plain C function bound with
ctypes: a source that includes PyTorch's headers takes minutes to compile,
a plain CUDA file seconds. A build or launch failure raises; nothing falls
back to the plain version on its own.

Host side (`rung_plan`): the coefficient half of each coordinate's
descriptor — kind, layout, widths, the q/s tensors — is checked once per
coefficient generation and kept in a ctypes array of `CoordDesc`, keyed by
the coefficient tensors' ids beside weak references (a hot swap brings new
q/s tensors, so a new plan). A call checks only its request tensors,
writes their addresses into that array, allocates the output and makes one
ctypes call, which passes the descriptors to the kernel by value.

Operand contract (checked before the launch): every tensor contiguous, on
the offsets' device; offsets (B,) f32; a sparse shard (B, k) int32
indices + (B, k) f32 values, a dense shard (B, d) f32; fixed (q (d,) int8,
s (1,) f32); random (q (E+1, d) int8, s (E+1,) f32) with ids (B,) int32.
Indices must lie in [0, d) and ids in [0, E]: the dispatcher's collation
guarantees both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from pathlib import Path

import torch

from photon_tpu_torch import kernels as K
from photon_tpu_torch.data.matrix import SparseRows, matvec
from photon_tpu_torch.game.model import score_rows

KERNEL = "serving_int8"
SOURCE = Path(__file__).parent / "csrc" / "serving_int8.cu"
# CoordDesc in csrc/serving_int8.cu: one int64 per field, in this order
_DESC_FIELDS = ("kind", "sparse", "d", "k", "x", "idx", "ids", "q", "s")
# kMaxCoords there: the coordinates one launch takes
MAX_COORDS = 16


class CoordDesc(ctypes.Structure):
    """One coordinate's descriptor as the kernel reads it."""
    _fields_ = [(f, ctypes.c_int64) for f in _DESC_FIELDS]


_lib = None
_lib_lock = threading.Lock()
_plans_lock = threading.Lock()
_PLANS: dict = {}
_PLAN_BUILDS = [0]


def library() -> ctypes.CDLL:
    """The built kernel library (built on first call; raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = K.load_library(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.photon_serving_int8_margin
            fn.argtypes = [p, p, i, i, p, p]
            fn.restype = i
            lib.photon_serving_int8_empty.argtypes = [i, p]
            lib.photon_serving_int8_empty.restype = i
            lib.photon_cuda_error_string.argtypes = [i]
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


# --------------------------------------------------------------- rung plan
@dataclasses.dataclass(frozen=True, eq=False)
class RungPlan:
    """A rung's coefficient half, checked once (`rung_plan`): the device
    of its coefficients (None for a rung of no coordinate); ``descs``,
    the ctypes array of `CoordDesc` the C entry point takes, its static
    fields filled and its request pointers (x, idx, ids) written by each
    call under ``lock``; per coordinate ``(desc, name, random, shard,
    sparse, k, d)``, ``desc`` its entry of ``descs`` (k = 0 for a dense
    shard); and the launches one call makes."""

    device: torch.device
    coords: tuple
    descs: ctypes.Array
    launches: int
    lock: threading.Lock


# the reference's name for the rung (`photon_tpu/kernels/serving.py`)
fused_int8_margin = int8_margin


def rung_plan(coords, shards, fixed_ws, re_cs) -> RungPlan:
    """The `RungPlan` of these coordinates over these coefficient tensors,
    keyed by the tensors' ids and kept while they live (each one's
    weak-reference finalizer drops it); the shard layouts (sparse or
    dense, k) are taken from ``shards`` when it is built. Raises if a
    coefficient tensor is not what the kernel takes. Builds no kernel and
    launches nothing (CPU tensors are fine)."""
    key = [coords]
    for name, kind, _ in coords:
        qs = fixed_ws[name] if kind == "fixed" else re_cs[name]
        key += (id(qs[0]), id(qs[1]))
    key = tuple(key)
    hit = _PLANS.get(key)
    if hit is not None:
        for ref in hit[0]:
            if ref() is None:
                break
        else:
            return hit[1]
    blocks = tuple(fixed_ws[name] if kind == "fixed" else re_cs[name]
                   for name, kind, _ in coords)
    plan = _build_plan(coords, shards, blocks)
    tensors = tuple(t for qs in blocks for t in qs)
    with _plans_lock:
        _PLANS[key] = (tuple(weakref.ref(t) for t in tensors), plan)
        _PLAN_BUILDS[0] += 1
    for t in tensors:
        weakref.finalize(t, _PLANS.pop, key, None)
    return plan


def plan_builds() -> int:
    """How many rung plans this process has built."""
    with _plans_lock:
        return _PLAN_BUILDS[0]


def _build_plan(coords, shards, blocks) -> RungPlan:
    dev = blocks[0][0].device if blocks else None
    descs = (CoordDesc * len(coords))()
    info = []
    for desc, (name, kind, shard), (q, s) in zip(descs, coords, blocks):
        if kind == "fixed":
            d = _dim(q, 1, 0, f"{name} q")
            _check(q, torch.int8, (d,), dev, f"{name} q")
            _check(s, torch.float32, (1,), dev, f"{name} scale")
        else:
            e1, d = _dim(q, 2, 0, f"{name} q"), _dim(q, 2, 1, f"{name} q")
            _check(q, torch.int8, (e1, d), dev, f"{name} q")
            _check(s, torch.float32, (e1,), dev, f"{name} scales")
        sparse = isinstance(shards[shard], SparseRows)
        k = int(shards[shard].indices.shape[1]) if sparse else 0
        desc.kind, desc.sparse, desc.d, desc.k = int(kind == "random"), \
            int(sparse), d, k
        desc.q, desc.s = q.data_ptr(), s.data_ptr()
        info.append((desc, name, kind == "random", shard, sparse, k, d))
    return RungPlan(device=dev, coords=tuple(info), descs=descs,
                    launches=max(1, -(-len(coords) // MAX_COORDS)),
                    lock=threading.Lock())


# ------------------------------------------------------------------ launch
def _dim(t, ndim: int, axis: int, what: str) -> int:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dimensions, got "
                         f"{tuple(t.shape)}")
    return int(t.shape[axis])


def _check(t, dtype, shape, device, what: str) -> int:
    """``t``'s address, once it is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``; raises otherwise."""
    try:
        if t.dtype is dtype and t.shape == shape and t.device == device \
                and t.is_contiguous():
            return t.data_ptr()
    except AttributeError:
        raise TypeError(f"{what}: expected a tensor, got {type(t)}") \
            from None
    raise ValueError(
        f"{what}: expected a contiguous {dtype} tensor of shape {shape} "
        f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _bind(plan: RungPlan, offsets, shards, ids) -> int:
    """Check the request tensors against ``plan`` — the shards in the
    layouts it was built for — and write their addresses into its
    descriptors (the caller holds ``plan.lock``); returns B."""
    f32, i32 = torch.float32, torch.int32
    dev = offsets.device if plan.device is None else plan.device
    B = int(offsets.shape[0])
    _check(offsets, f32, (B,), dev, "offsets")
    for desc, name, random, shard, sparse, k, d in plan.coords:
        X = shards[shard]
        if sparse:
            if not isinstance(X, SparseRows):
                raise ValueError(f"{shard}: the rung plan takes (B, {k}) "
                                 f"sparse rows, got {type(X).__name__}")
            shape = (B, k)
            desc.idx = _check(X.indices, i32, shape, dev, f"{shard} indices")
            desc.x = _check(X.values, f32, shape, dev, f"{shard} values")
        else:
            desc.x = _check(X, f32, (B, d), dev, f"{shard} rows")
        if random:
            desc.ids = _check(ids[name], i32, (B,), dev, f"{name} ids")
    return B


def _launch(coords, offsets, shards, ids, fixed_ws, re_cs):
    plan = rung_plan(coords, shards, fixed_ws, re_cs)
    with plan.lock:
        B = _bind(plan, offsets, shards, ids)
        out = torch.empty(B, dtype=torch.float32, device=offsets.device)
        lib = _lib if _lib is not None else library()
        code = K.launch(lib.photon_serving_int8_margin, out.get_device(),
                        offsets.data_ptr(), plan.descs, len(plan.coords), B,
                        out.data_ptr())
    if code:
        raise RuntimeError(
            f"{KERNEL} launch failed: "
            f"{lib.photon_cuda_error_string(code).decode()}")
    K.count_launch(KERNEL, plan.launches, out)
    return out


# ----------------------------------------------------------------- contracts
# The kernel-side pins: an int8 rung routed through the hand-written
# kernel keeps the serving law (no collective, no host sync, no combining
# scatter, an f32 output) and builds its rung plan once; the kernel seam
# never moves a rung's dispatch signature.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import SCATTER_PRIMITIVES  # noqa: E402


def _contract_int8_ladder(device):
    from photon_tpu_torch.serving.programs import (ProgramLadder,
                                                   _contract_rung_args,
                                                   _tiny_store)

    ladder = ProgramLadder(_tiny_store(device), ladder=(8,),
                           sparse_k={"member": 3}, output_mean=True,
                           quantize="int8")
    return ladder, _contract_rung_args(ladder, 8)


@register_contract(
    name="serving_kernel_fused_rung",
    description="one int8 serving rung routed through the hand-written "
                "kernel (kernels.scope('on') on the card): dequant + "
                "fixed matvec + per-entity gather-dot in one launch, ZERO "
                "collectives, ZERO host syncs, no combining scatter, an "
                "f32 margin",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("serving", "kernels"))
def _contract_fused_rung(device):
    ladder, args = _contract_int8_ladder(device)
    mode = K.device_mode(device)

    def rung(*a):
        with K.scope(mode):
            return ladder._fn(*a)

    return rung, args


@register_contract(
    name="serving_kernel_mode_invariance",
    description="the serving-kernel seam is signature-invariant: the "
                "same int8 rung args record IDENTICAL dispatch signatures "
                "kernels-on and kernels-off (the builder replays both "
                "modes through the signature log and raises on "
                "divergence); the rung's plan is built once",
    collectives={}, tags=("serving", "kernels"))
def _contract_mode_invariance(device):
    from photon_tpu_torch.analysis.rules import TraceSignatureLog

    ladder, args = _contract_int8_ladder(device)
    log = TraceSignatureLog()
    modes = (("off", "on", "off") if torch.device(device).type == "cuda"
             else ("off", "auto", "off"))
    for m in modes:
        with K.scope(m):
            log.record("serving.kernel_rung", args)
    if len(log.signatures("serving.kernel_rung")) != 1:
        raise AssertionError(
            "serving kernel seam drifted: rung args signature moved "
            "across mode flips (expected 1 signature)")
    mode = K.device_mode(device)

    def rung(*a):
        with K.scope(mode):
            return ladder._fn(*a)

    return rung, args
