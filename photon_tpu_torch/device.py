"""Device policy of the port: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else
    ``cuda``. Asking for CUDA (explicitly or by default) on a machine with
    no GPU raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "photon_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' to run on the CPU")
    return dev
