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
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

ENV_KNOB = "PHOTON_TPU_TORCH_KERNELS"
_MODES = ("on", "off", "auto")

# Override stack (innermost wins) pushed by `scope`; process-wide, so a
# scope set on the caller's thread also governs the dispatcher's threads.
_OVERRIDES: list = []

_launch_lock = threading.Lock()
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
    return _canon(os.environ.get(ENV_KNOB, "auto"))


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


def count_launch(name: str) -> None:
    """Called by a wrapper where it launches its kernel, and nowhere else."""
    with _launch_lock:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict:
    with _launch_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _launch_lock:
        _LAUNCHES.clear()
