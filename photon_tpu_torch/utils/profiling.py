"""Profiler hooks (port of `photon_tpu/utils/profiling.py`): capture a
host/device timeline around any region, name spans on it, and count the
region's host↔device syncs.

    from photon_tpu_torch.utils.profiling import trace
    with trace("out/photon-trace"):
        train_glm(batch, task, config)

`trace` runs `torch.profiler` (CPU activity, and CUDA's when a card is
present) and writes a Chrome-trace JSON into ``log_dir`` (TensorBoard's
profiler plugin, Perfetto or chrome://tracing read it). `annotate` names
a span on that timeline; the telemetry spans of an attached run
(`telemetry.span`) land on it the same way, with an NVTX range each.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import torch

__all__ = ["trace", "annotate", "count_syncs"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed region into ``log_dir``;
    yields the `torch.profiler.profile` object."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def annotate(name: str):
    """A named span on the trace timeline (host-side scope; the device
    ops launched within are attributed to it)."""
    return torch.profiler.record_function(name)


_READBACKS = ("item", "tolist", "__bool__", "__float__", "__int__")


@contextlib.contextmanager
def count_syncs(device):
    """Count the host↔device synchronizations made inside the block;
    yields a dict whose ``"n"`` holds the count once the block ends (and
    on CUDA ``"sites"``: the count by the Python file and line that made
    each).

    On CUDA the count is the warnings of torch's sync debug mode: every
    call that waits for the device. On the CPU nothing waits, so it
    counts the host read-backs of tensor values (`Tensor.item`,
    ``tolist``, ``bool``, ``float``, ``int``) — the calls that would wait
    on a card. Both are process-wide: keep other threads quiet."""
    out = {"n": 0}
    if torch.device(device).type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield out
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        out["n"] = len(syncs)
        sites: dict = {}
        for w in syncs:
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
        out["sites"] = sites
        return
    saved = {name: torch.Tensor.__dict__.get(name) for name in _READBACKS}

    def counted(name):
        base = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            out["n"] += 1
            return base(self, *a, **kw)

        return read

    for name in _READBACKS:
        setattr(torch.Tensor, name, counted(name))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
