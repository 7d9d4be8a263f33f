"""Hand-written Hopper kernels of the port, and the seam that routes to them
(port of `photon_tpu/kernels/__init__.py`).

Every kernel module holds three things: the CUDA kernel (source under
`csrc/`, built on first use), its plain PyTorch version, and a wrapper
that picks between them by the seam below and counts its launches here.

MODES (``PHOTON_TPU_TORCH_KERNELS`` env knob, or `scope` for a block):

- ``auto`` (default): the kernel for CUDA tensors, the plain version for
  CPU tensors (there is no kernel on the CPU);
- ``on``: the kernel is required — a CPU tensor raises;
- ``off``: the plain version everywhere, GPU included — the explicit
  switch for comparing against the kernel.

A wrapper never falls back on its own: a kernel that fails to build or
launch raises.

ROUTE (`route`, the counterpart of the reference's VMEM ladder): the
blocked-ELL X passes take the single-launch ``fused`` form unless
``PHOTON_TPU_TORCH_KERNELS_BUDGET`` sets a byte budget that the vector the
kernel gathers from at random exceeds; then the per-bucket ``tiled`` form.
0 forces ``tiled``. Neither form keeps the vector resident on the card
(both gather from global memory), and the fused form measured faster on
the training path's full-width shapes, so there is no default budget.
There is no floor below which neither form runs, so a CUDA tensor never
routes to the plain version.

BUILD (`load_library`): each CUDA source under ``csrc/`` is a plain C
entry point, built for ``sm_90a`` into ``_build/`` on first use by
`torch.utils.cpp_extension.load` and bound with ctypes.

LAUNCH (`launch`): every wrapper calls its C entry point through one
helper that appends the raw handle of the device's current stream
(`current_stream`), so a call builds no Stream object and, when its
tensors lie on the current device, enters no device context.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path

import torch

from photon_tpu_torch.utils.env import get_raw

ENV_KNOB = "PHOTON_TPU_TORCH_KERNELS"
ENV_BUDGET = "PHOTON_TPU_TORCH_KERNELS_BUDGET"
_MODES = ("on", "off", "auto")

BUILD_DIR = Path(__file__).parent / "_build"

# Override stack (innermost wins) pushed by `scope`; process-wide, so a
# scope set on the caller's thread also governs the dispatcher's threads.
_OVERRIDES: list = []

_launch_lock = threading.Lock()
_LAUNCH_HOOKS: list = []
_LOADS = [0]
_LAUNCHES: dict = {}


def _canon(m) -> str:
    m = str(m).strip().lower()
    m = {"1": "on", "true": "on", "0": "off", "false": "off",
         "": "auto"}.get(m, m)
    if m not in _MODES:
        raise ValueError(f"{ENV_KNOB} must be one of {_MODES} (or 0/1), "
                         f"got {m!r}")
    return m


def mode() -> str:
    """The requested mode: innermost `scope` override, else the env knob,
    else ``auto``."""
    if _OVERRIDES:
        return _OVERRIDES[-1]
    return _canon(get_raw(ENV_KNOB, "auto"))


def use_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its kernel (True) or runs its
    plain version (False)."""
    m = mode()
    if m == "off":
        return False
    if t.is_cuda:
        return True
    if m == "on":
        raise RuntimeError(
            f"{ENV_KNOB}=on requires CUDA tensors: the kernels run only on "
            f"the GPU, got a tensor on {t.device}")
    return False


@contextlib.contextmanager
def scope(m=None):
    """Push a mode override for the duration (None = inherit)."""
    if m is None:
        yield
        return
    _OVERRIDES.append(_canon(m))
    try:
        yield
    finally:
        _OVERRIDES.pop()


def device_mode(device) -> str:
    """The mode that makes a call on ``device`` take the kernel: ``on`` on
    the card (a CUDA tensor must launch), ``auto`` on the CPU (the plain
    versions: there is no kernel there). The kernel contracts run under
    it."""
    return "on" if torch.device(device).type == "cuda" else "auto"


def count_launch(name: str, n: int = 1, out=None) -> None:
    """Called by a wrapper where it launches its kernel (``n`` launches
    made by one call, writing ``out``), and nowhere else. Each hook added
    by `add_launch_hook` sees ``(name, n, out)``."""
    with _launch_lock:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n
        hooks = tuple(_LAUNCH_HOOKS)
    for hook in hooks:
        hook(name, n, out)


def add_launch_hook(hook) -> None:
    """Call ``hook(name, n, out)`` at every counted launch (the contract
    recorder reads the kernels' output dtypes through it)."""
    with _launch_lock:
        _LAUNCH_HOOKS.append(hook)


def remove_launch_hook(hook) -> None:
    with _launch_lock:
        _LAUNCH_HOOKS.remove(hook)


def library_loads() -> int:
    """How many kernel libraries this process has loaded."""
    with _launch_lock:
        return _LOADS[0]


def plan_builds() -> int:
    """How many kernel plans this process has built: blocked-ELL layout
    plans, int8 rung plans and fused value+grad geometries."""
    from photon_tpu_torch.kernels import blocked_ell, fused, serving

    return (blocked_ell.plan_builds() + serving.plan_builds()
            + fused.plan_builds())


def launch_counts() -> dict:
    with _launch_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _launch_lock:
        _LAUNCHES.clear()


def budget():
    """The fused form's byte budget (``PHOTON_TPU_TORCH_KERNELS_BUDGET``),
    None when the knob is unset (no budget); a malformed knob raises here,
    naming it."""
    raw = get_raw(ENV_BUDGET)
    if raw is None:
        return None
    try:
        b = int(raw)
    except ValueError:
        raise ValueError(f"{ENV_BUDGET} must be an integer byte budget, "
                         f"got {raw!r}") from None
    if b < 0:
        raise ValueError(f"{ENV_BUDGET} must be >= 0 bytes, got {b}")
    return b


def route(X, vec: torch.Tensor) -> str:
    """``"fused"`` or ``"tiled"`` for a blocked-ELL X pass of ``vec``: fused
    unless a `budget` is set and the vector its kernel gathers from — the
    tail slice ``w[d_sel:n_prefix]`` of a coefficient vector (row count ≠
    n) or the whole cotangent of an rmatvec (row count n) — exceeds it."""
    b = budget()
    if b is None:
        return "fused"
    rows = int(vec.shape[0])
    if rows != int(X.shape[0]):  # coefficient vector: only the tail slice
        rows = int(X.n_prefix - X.d_sel)
    resident = rows * (vec.numel() // max(int(vec.shape[0]), 1)) \
        * vec.element_size()
    return "fused" if resident <= b else "tiled"


_build_locks_lock = threading.Lock()
_BUILD_LOCKS: dict = {}


def load_library(source: Path) -> ctypes.CDLL:
    """The shared library built from the CUDA ``source`` into
    ``_build/<stem>/`` (compiled on first call, and again only when the
    source changes; raises with the compiler's output if the build
    fails). Builds of different sources may run at once, from different
    threads."""
    from torch.utils.cpp_extension import load

    source = Path(source)
    build_dir = BUILD_DIR / source.stem
    with _build_locks_lock:
        lock = _BUILD_LOCKS.setdefault(source.stem, threading.Lock())
    with lock:
        build_dir.mkdir(parents=True, exist_ok=True)
        path = load(name=f"photon_tpu_torch_{source.stem}",
                    sources=[str(source)], build_directory=str(build_dir),
                    extra_cuda_cflags=["-O3",
                                       "-gencode=arch=compute_90a,"
                                       "code=sm_90a"],
                    is_python_module=False, verbose=False)
    lib = ctypes.CDLL(path)
    with _launch_lock:
        _LOADS[0] += 1
    return lib


def current_stream(index: int) -> int:
    """The handle of CUDA device ``index``'s current stream, the value of
    ``torch.cuda.current_stream(index).cuda_stream``, read without building
    a Stream object (the larger part of a call's host time,
    chip_host_parts.py)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)``: the C entry point ``fn`` called with the
    current stream of CUDA device ``index``; returns its code. The device
    is made current around the call only when it is not already (tensors
    on another device than the current one)."""
    if index == torch.cuda.current_device():
        return fn(*args, current_stream(index))
    with torch.cuda.device(index):
        return fn(*args, current_stream(index))
