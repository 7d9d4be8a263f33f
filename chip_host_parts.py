#!/usr/bin/env python3
"""Time the host side of a blocked-ELL tail matvec call and of an int8
serving rung call, part by part, on one GPU.

    python3 chip_host_parts.py [--calls N]

On chip_smoke.py's small T1 layout (bf16), where a call's device work is a
few µs, each part below runs N times in a loop on the host clock (the
device may still be busy; nothing waits for it): the kernel seam's mode
check, the plan lookup and operand checks, the output's allocation, the
stream and device queries, the C entry point with no, one and five
launches (and the zero fill), the three wrappers whole, one PyTorch
elementwise op and cuSPARSE's SpMV of the same tail. Then the same for a
B = 64 rung of three sparse coordinates (one fixed, two random effects,
as the serving path's): the rung plan's lookup, the request checks with
the pointer writes, the output's allocation, the C entry point (the rung,
and an empty kernel of its grid) and the wrapper whole. Prints µs per
call of each and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args()

    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_host_parts: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.kernels import serving as KS

    dev = torch.device("cuda", 0)
    lib = KB.library()
    X = cs.small_layout(dev, True)
    n, d = X.shape
    w = torch.randn(d, device=dev)
    h = torch.zeros(n, device=dev)
    plan = KB.layout_plan(X)
    stream = torch.cuda.current_stream().cuda_stream
    csr = cs.tail_csr(X, transpose=False)
    wt = w[X.d_sel:X.n_prefix].to(X.dense.dtype).float()[:, None]
    no_ranges = ((ctypes.c_int * 0)(), ctypes.c_int(0))

    def entry(ranges, zero_bytes=0):
        return lambda: lib.photon_bell_tail_matvec(
            *plan.tail_args, *ranges[:2], w.data_ptr() + X.d_sel * 4, 1,
            h.data_ptr(), zero_bytes, stream)

    parts = [
        ("an empty lambda", lambda: None),
        ("K.use_kernel, mode from the environment",
         lambda: K.use_kernel(w)),
        ("KB.layout_plan", lambda: KB.layout_plan(X)),
        ("KB._check_tail", lambda: KB._check_tail(X, w)),
        ("KB._tail_out, out given", lambda: KB._tail_out(X, w, h)),
        ("KB._tail_out, a new output (torch.empty)",
         lambda: KB._tail_out(X, w, None)),
        ("torch.cuda.current_device()", torch.cuda.current_device),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("K.current_stream(0)", lambda: K.current_stream(0)),
        ("K.count_launch", lambda: K.count_launch("host_parts", 1)),
        ("C entry point, no launch", entry(no_ranges)),
        ("C entry point, one launch", entry(plan.tail_fused)),
        ("C entry point, one launch and the zero fill",
         entry(plan.tail_fused, 4 * n)),
        ("C entry point, five launches (tiled)", entry(plan.tail_tiled)),
        ("torch.add (one PyTorch op)", lambda: torch.add(h, h)),
        ("torch.sparse.mm (cuSPARSE SpMV)", lambda: torch.sparse.mm(csr, wt)),
    ]

    def run(name, fn) -> None:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        us = (time.perf_counter() - t0) / args.calls * 1e6
        torch.cuda.synchronize()
        print(f"host: {name}: {us:.2f} us per call", flush=True)

    for name, fn in parts:
        run(name, fn)
    with K.scope("on"):  # as chip_smoke.py's T3 calls them
        run("K.use_kernel under scope('on')", lambda: K.use_kernel(w))
        run("tail_matvec(X, w, out=h)", lambda: KB.tail_matvec(X, w, out=h))
        run("tail_matvec(X, w)", lambda: KB.tail_matvec(X, w))
        run("tail_matvec_tiled(X, w)", lambda: KB.tail_matvec_tiled(X, w))

    # the int8 rung: B = 64, one fixed and two random sparse coordinates
    rung, _ = cs.small_case(np.random.default_rng(5), [
        ("fixed", True), ("random", True), ("random", True)], dev, B=64)
    coords, offsets, shards, ids, fixed_ws, re_cs = rung
    slib = KS.library()
    plan = KS.rung_plan(coords, shards, fixed_ws, re_cs)
    KS._bind(plan, offsets, shards, ids)
    out = torch.empty(64, device=dev)
    rung_parts = [
        ("KS.rung_plan (lookup)",
         lambda: KS.rung_plan(coords, shards, fixed_ws, re_cs)),
        ("KS._bind (request checks, pointer writes)",
         lambda: KS._bind(plan, offsets, shards, ids)),
        ("torch.empty(64) on the card", lambda: torch.empty(64, device=dev)),
        ("C entry point, the rung (one launch)",
         lambda: slib.photon_serving_int8_margin(
             offsets.data_ptr(), plan.descs, len(coords), 64,
             out.data_ptr(), stream)),
        ("C entry point, an empty kernel of the rung's grid",
         lambda: slib.photon_serving_int8_empty(64, stream)),
        ("K.launch of the rung (device and stream queries included)",
         lambda: K.launch(slib.photon_serving_int8_margin, 0,
                          offsets.data_ptr(), plan.descs, len(coords), 64,
                          out.data_ptr())),
    ]
    for name, fn in rung_parts:
        run(name, fn)
    with K.scope("on"):
        run("KS._launch (the wrapper less its mode check)",
            lambda: KS._launch(*rung))
        run("int8_margin (B=64, 3 coordinates)",
            lambda: KS.int8_margin(*rung))
    run("int8_margin, mode from the environment",
        lambda: KS.int8_margin(*rung))
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
