"""The ``PHOTON_TPU_*`` environment knobs (the port's copy of the part of
`photon_tpu/utils/env.py` that the mesh spine, the attribution ledger and
the logger read, plus the kernel seam's three knobs).

Every knob is declared ONCE here, with its one-line contract; modules read raw values through :func:`get_raw`, which
refuses an undeclared name. Parsing stays with the owner module named in
each doc line.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["KNOB_DOCS", "get_raw", "declared"]

KNOB_DOCS = {
    "PHOTON_TPU_COORDINATOR": (
        "Multi-process coordinator address (host:port) for "
        "torch.distributed's TCP rendezvous — set it to join an externally "
        "launched cluster (parallel.launch passes the address to its "
        "children as an argument). Owner: photon_tpu_torch.parallel.mesh "
        "(initialize_distributed())."),
    "PHOTON_TPU_NUM_PROCESSES": (
        "Multi-process cluster size (integer >= 1; read with "
        "PHOTON_TPU_COORDINATOR/PHOTON_TPU_PROCESS_ID). Owner: "
        "photon_tpu_torch.parallel.mesh (initialize_distributed())."),
    "PHOTON_TPU_PROCESS_ID": (
        "This process's rank in the multi-process cluster (integer in "
        "[0, PHOTON_TPU_NUM_PROCESSES)). Owner: "
        "photon_tpu_torch.parallel.mesh (initialize_distributed())."),
    "PHOTON_TPU_BARRIER_TIMEOUT_S": (
        "Multi-process barrier timeout in seconds (default 120): how long "
        "a cluster barrier — the checkpoint store's begin and pre-manifest "
        "barriers among them — waits for every process before it raises "
        "(a dead peer fails the barrier loudly instead of hanging it). "
        "Owner: photon_tpu_torch.parallel.mesh (barrier_timeout_s())."),
    "PHOTON_TPU_PEAK_FLOPS": (
        "Per-device FLOP/s ceiling for the attribution ledger's "
        "roofline-utilization denominators (overrides the device's table "
        "entry). Owner: photon_tpu_torch.profiling.ledger "
        "(resolve_peaks())."),
    "PHOTON_TPU_LOG_LEVEL": (
        "Default level of the package's loggers (a standard level name "
        "such as DEBUG/warning, or a numeric level); unset or "
        "unparseable keeps the logger's own default. Owner: "
        "photon_tpu_torch.utils.logging (photon_logger())."),
    "PHOTON_TPU_TORCH_KERNELS": (
        "The kernel dispatch mode: auto (default; the hand-written kernel "
        "for CUDA tensors, the plain version for CPU tensors), on (the "
        "kernel required: a CPU tensor raises), off (the plain version "
        "everywhere); 1/true and 0/false alias on and off. Owner: "
        "photon_tpu_torch.kernels (mode())."),
    "PHOTON_TPU_TORCH_KERNELS_BUDGET": (
        "Byte budget of the fused blocked-ELL form (integer >= 0): a "
        "vector the kernel gathers from that exceeds it routes to the "
        "tiled form; unset means no budget (always fused), 0 forces "
        "tiled. Owner: photon_tpu_torch.kernels (budget(), route())."),
    "PHOTON_TPU_TORCH_KERNELS_TILE": (
        "Work-item tile of the tiled blocked-ELL forms (rows 3 and 5): a "
        "power of two >= 32, rows per tail-matvec item or columns per "
        "rmatvec item, that beats the autotuned per-card choice "
        "(tuning/tile_tuner.py); clamped to what one block takes. Unset "
        "(default) = the tuner's winner, else DEFAULT_TILE. Owner: "
        "photon_tpu_torch.kernels (tile_override())."),
    "PHOTON_TPU_PEAK_BYTES_PER_S": (
        "Per-device memory bytes/s ceiling for the attribution ledger's "
        "roofline-utilization denominators (overrides the device's table "
        "entry). Owner: photon_tpu_torch.profiling.ledger "
        "(resolve_peaks())."),
}


def declared(name: str) -> bool:
    return name in KNOB_DOCS


def get_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ.get`` behind the registry: ``name`` must be declared
    in :data:`KNOB_DOCS` (an undeclared read raises)."""
    if name not in KNOB_DOCS:
        raise KeyError(
            f"{name!r} is not a declared PHOTON_TPU_* knob of the port — "
            "add it to photon_tpu_torch.utils.env.KNOB_DOCS first")
    return os.environ.get(name, default)
