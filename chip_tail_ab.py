#!/usr/bin/env python3
"""Time the blocked-ELL tail matvec kernel as committed against variants
of its source, at the training path's headline layout, on one GPU.

    python3 chip_tail_ab.py [--seed N] [--reps N]

Variants (each a copy of csrc/blocked_ell.cu with one change, built into
the kernels' build directory beside the committed library):

- ``slots2`` / ``slots8`` / ``slots16``: kTailSlotsPerThread 2, 8 or 16
  instead of 4 (the rows a thread takes per width; the work plan is
  rebuilt to match);
- ``minblocks6``: ``__launch_bounds__(kThreads, 6)`` on the tail kernel
  (at most 40 registers, six blocks per SM);
- ``ldg``: the slot stream loaded cached (``__ldg``) instead of
  evict-first (``__ldcs``).

Lays out chip_smoke.py's T2 problem (2^21 rows, 10,000,000 features,
bf16), checks that every variant gives the committed kernel's bits on a
vector, then times each variant's fused form (one launch) and tiled form
(one launch per width bucket), warm and cold L2 (chip_smoke.events_ms:
device time by CUDA events, the host's enqueue hidden), in turns, and the
tiled form's device µs per launch (torch.profiler). Prints one line per
measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import threading

import numpy as np

import chip_smoke as cs

KERNEL_HEAD = ("__global__ void __launch_bounds__(kThreads)\n"
               "bell_tail_matvec_kernel(")
SLOTS = "kTailSlotsPerThread = 4;"
VARIANTS = {
    "committed": (4, lambda s: s),
    "slots2": (2, lambda s: s.replace(SLOTS, SLOTS.replace("4", "2"))),
    "slots8": (8, lambda s: s.replace(SLOTS, SLOTS.replace("4", "8"))),
    "slots16": (16, lambda s: s.replace(SLOTS, SLOTS.replace("4", "16"))),
    "minblocks6": (4, lambda s: s.replace(
        KERNEL_HEAD, KERNEL_HEAD.replace("(kThreads)", "(kThreads, 6)"))),
    "ldg": (4, lambda s: s.replace("__ldcs(", "__ldg(")),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_tail_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import cast_features, make_batch
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.kernels import blocked_ell as KB

    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    src = KB.SOURCE.read_text()
    for name, (_, edit) in VARIANTS.items():
        if name != "committed" and edit(src) == src:
            raise AssertionError(f"variant {name} changes nothing")
    libs, errors = {}, []

    def build(name: str) -> None:
        try:
            if name == "committed":
                libs[name] = KB.library()
                return
            path = K.BUILD_DIR / "ab" / f"blocked_ell_{name}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(VARIANTS[name][1](src))
            lib = K.load_library(path)
            lib.photon_bell_tail_matvec.argtypes = \
                KB.library().photon_bell_tail_matvec.argtypes
            lib.photon_bell_tail_matvec.restype = ctypes.c_int
            libs[name] = lib
        except Exception as e:  # reported by the main thread
            errors.append(e)

    KB.library()
    threads = [threading.Thread(target=build, args=(v,)) for v in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    ind, va, y = cs.sparse_problem(args.seed, cs.T_ROWS)
    X = to_blocked_ell(SparseRows(ind, va, cs.T_FEATURES), cs.T_DENSE,
                       device_dense_dtype=torch.bfloat16, device=dev)
    X = cast_features(make_batch(X, y, device=dev)).X
    del ind, va
    n = int(X.shape[0])
    plan = KB.layout_plan(X)
    shapes = [tuple(int(s) for s in v.shape) for v in X.ell_vals]
    items = {}
    for name, (slots, _) in VARIANTS.items():
        old = KB.TAIL_SLOTS_PER_THREAD
        KB.TAIL_SLOTS_PER_THREAD = slots
        try:
            host = KB.tail_plan(shapes)
        finally:
            KB.TAIL_SLOTS_PER_THREAD = old
        ranges = KB.plan_ranges(host, len(shapes))
        items[name] = (torch.from_numpy(host).to(dev),
                       KB._host_ranges([(0, int(host.shape[0]))]),
                       KB._host_ranges(ranges))
    w = torch.from_numpy(np.random.default_rng(23).normal(
        size=X.n_features).astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {v: torch.zeros(n, device=dev) for v in VARIANTS}

    def call(name: str, tiled: bool) -> None:
        dev_items, fused, per_bucket = items[name]
        flat, n_ranges, _ = per_bucket if tiled else fused
        desc, nb, _, rows, bf16 = plan.tail_args
        code = libs[name].photon_bell_tail_matvec(
            desc, nb, dev_items.data_ptr(), rows, bf16, flat, n_ranges,
            w.data_ptr() + X.d_sel * 4, 1, outs[name].data_ptr(), 0, stream)
        if code:
            raise RuntimeError(f"{name}: launch failed: {code}")

    for name in VARIANTS:
        call(name, False)
    torch.cuda.synchronize()
    for name in VARIANTS:
        if not torch.equal(outs[name], outs["committed"]):
            raise AssertionError(f"variant {name} differs from the "
                                 "committed kernel")
    print("tail variants give the committed kernel's bits: "
          + ", ".join(VARIANTS), flush=True)
    turns = list(VARIANTS) + list(reversed(VARIANTS))
    for tiled in (False, True):
        for cold in (False, True):
            got = {v: [] for v in VARIANTS}
            for _ in range(args.reps):
                for v in turns:
                    got[v].append(cs.events_ms(lambda: call(v, tiled),
                                               cold=cold))
            print(f"tail {'tiled' if tiled else 'fused'} "
                  f"{'cold' if cold else 'warm'} L2 (device ms): "
                  + "; ".join(f"{v} {np.mean(t):.5f} (min {min(t):.5f}, "
                              f"max {max(t):.5f})" for v, t in got.items())
                  + f"  [{gpu}]", flush=True)
    for v in VARIANTS:
        us = cs.launch_us(lambda: call(v, True), "bell_tail_matvec_kernel",
                          len(shapes))
        print(f"tail tiled {v} per launch (W_b: device us): "
              + ", ".join(f"{w_b}: {u:.2f}" for (_, w_b), u in zip(shapes,
                                                                     us))
              + f"  [{gpu}]", flush=True)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
