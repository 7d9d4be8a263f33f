"""The multi-process ``PHOTON_TPU_*`` environment knobs (the port's copy of
the part of `photon_tpu/utils/env.py` the mesh spine reads).

Every knob the multi-process spine reads is declared ONCE here, with its
one-line contract; modules read raw values through :func:`get_raw`, which
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
        "torch.distributed's TCP rendezvous — the launcher exports it to "
        "every child; set it by hand to join an externally launched "
        "cluster. Owner: photon_tpu_torch.parallel.mesh "
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
