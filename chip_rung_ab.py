#!/usr/bin/env python3
"""Time the int8 serving rung kernel as committed against a variant of its
source, at the serving path's shapes, on one GPU.

    python3 chip_rung_ab.py [--seed N] [--reps N]

Variant (a copy of csrc/serving_int8.cu with one change, built into the
kernels' build directory beside the committed library): ``unrolled16``,
every launch takes the 16-coordinate instantiation (loops unrolled to 16
coordinates, those past the rung's skipped by a test) instead of the
smallest that holds the rung's.

Builds chip_smoke.py's serving store (a fixed effect over 10,000,000
features with 32 slots per row, two random effects of 100,000 and 50,000
entities with 8 slots), collates the rung operands of the first B
requests for B = 8 and 64, checks that the variant gives the committed
kernel's bits, then times each one's device time — the kernel alone
(torch.profiler) and one call between CUDA events with the host's enqueue
hidden, warm and cold L2 — in turns, beside an empty kernel of the same
grid. Prints one line per measurement and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

import chip_smoke as cs

VARIANTS = {
    "committed": lambda s: s,
    "unrolled16": lambda s: s.replace("switch (coords_bound(p.n_coords))",
                                      "switch (kMaxCoords)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_rung_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import serving as KS
    from photon_tpu_torch.serving import ProgramLadder
    from photon_tpu_torch.serving.dispatcher import _Pending, collate_rung_args

    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    src = KS.SOURCE.read_text()
    libs = {"committed": KS.library()}
    for name, edit in VARIANTS.items():
        if name == "committed":
            continue
        if edit(src) == src:
            raise AssertionError(f"variant {name} changes nothing")
        path = K.BUILD_DIR / "ab" / f"serving_int8_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(edit(src))
        lib = K.load_library(path)
        for fn in ("photon_serving_int8_margin", "photon_serving_int8_empty"):
            getattr(lib, fn).argtypes = getattr(libs["committed"],
                                                fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    store = cs.build_store(args.seed, dev)
    ladder = ProgramLadder(store, quantize="int8", quant_epsilon=cs.EPSILON,
                           floor=8, max_batch=cs.MAX_BATCH,
                           sparse_k={"global": cs.K_FIXED,
                                     "userFeatures": cs.K_RE,
                                     "itemFeatures": cs.K_RE})
    ladder.warmup()
    reqs = cs.make_requests(args.seed, cs.MAX_BATCH)
    quant = ladder._quant_blocks()
    for B in (8, cs.MAX_BATCH):
        pend = [_Pending(r) for r in reqs[:B]]
        offsets, shards, ids, _ = collate_rung_args(ladder, pend, B)
        rung = (ladder.coords,) + ladder._upload(offsets, shards, ids) + quant
        coords, offsets, shards, ids, fixed_ws, re_cs = rung
        plan = KS.rung_plan(coords, shards, fixed_ws, re_cs)
        KS._bind(plan, offsets, shards, ids)
        outs = {v: torch.empty(B, device=dev) for v in libs}

        def call(v: str) -> None:
            code = K.launch(libs[v].photon_serving_int8_margin, 0,
                            offsets.data_ptr(), plan.descs, len(coords), B,
                            outs[v].data_ptr())
            if code:
                raise RuntimeError(f"{v}: launch failed: {code}")

        for v in libs:
            call(v)
        torch.cuda.synchronize()
        want = KS.int8_margin_reference(*rung)
        np.testing.assert_allclose(outs["committed"].cpu().numpy(),
                                   want.cpu().numpy(), **cs.TOL)
        for v in libs:
            if not torch.equal(outs[v], outs["committed"]):
                raise AssertionError(f"B={B}: {v} differs from the committed "
                                     "kernel")
        turns = list(libs) + list(reversed(libs))
        got = {(v, m): [] for v in libs for m in ("prof", "warm", "cold")}
        for _ in range(args.reps):
            for v in turns:
                got[(v, "prof")].append(cs.device_ms(
                    lambda: call(v), "serving_int8_margin_kernel") or np.nan)
                got[(v, "warm")].append(cs.events_ms(lambda: call(v),
                                                     cold=False))
                got[(v, "cold")].append(cs.events_ms(lambda: call(v),
                                                     cold=True))

        def empty() -> None:
            K.launch(libs["committed"].photon_serving_int8_empty, 0, B)

        empty_prof = cs.device_ms(empty, "serving_int8_empty_kernel")
        empty_ev = cs.events_ms(empty, cold=False)
        for v in libs:
            print(f"rung B={B} {v}: device us, kernel alone (profiler) "
                  f"{np.nanmedian(got[(v, 'prof')]) * 1e3:.3f}; one call by "
                  f"events, warm L2 {np.median(got[(v, 'warm')]) * 1e3:.3f}, "
                  f"cold L2 {np.median(got[(v, 'cold')]) * 1e3:.3f}  [{gpu}]",
                  flush=True)
        print(f"rung B={B} empty kernel of the same grid: "
              + ("not measured" if empty_prof is None
                 else f"{empty_prof * 1e3:.3f}")
              + f" us (profiler), {empty_ev * 1e3:.3f} us (events)  [{gpu}]",
              flush=True)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
