#!/usr/bin/env python3
"""Time the occurrence-bucket rmatvec kernel as committed (its slot stream
loaded evict-first, ``__ldcs``) against the same source with cached slot
loads (``__ldg``), at the training path's headline layout, on one GPU.

    python3 chip_rmatvec_ab.py [--seed N] [--reps N]

Builds both variants (the second from a copy of csrc/blocked_ell.cu with
every ``__ldcs(`` made ``__ldg(``, into the kernels' build directory),
lays out chip_smoke.py's T2 problem (2^21 rows, 10,000,000 features, bf16),
checks that the two give the same bits, then times each on a vector and an
8-lane cotangent, warm and cold L2 (chip_smoke.events_ms: device time by
CUDA events, the host's enqueue hidden), in turns A B B A per repetition.
Prints one line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_rmatvec_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import cast_features, make_batch
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.kernels import blocked_ell as KB

    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    src = KB.SOURCE.read_text()
    if "__ldcs(" not in src:
        raise AssertionError("the committed source has no __ldcs slot loads")
    variant = K.BUILD_DIR / "ab" / "blocked_ell_ldg.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(src.replace("__ldcs(", "__ldg("))
    libs = {"ldcs": KB.library(), "ldg": K.load_library(variant)}
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["ldg"].photon_bell_bucket_rmatvec.argtypes = [
        p, p, i, ctypes.POINTER(ctypes.c_int), i, p, i, i, p, p]
    libs["ldg"].photon_bell_bucket_rmatvec.restype = i

    ind, va, y = cs.sparse_problem(args.seed, cs.T_ROWS)
    X = to_blocked_ell(SparseRows(ind, va, cs.T_FEATURES), cs.T_DENSE,
                       device_dense_dtype=torch.bfloat16, device=dev)
    X = cast_features(make_batch(X, y, device=dev)).X
    del ind, va
    n, U = int(X.shape[0]), X.n_prefix - X.d_sel
    plan = KB.layout_plan(X)
    rng = np.random.default_rng(23)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, r, out):
        lanes = 1 if r.dim() == 1 else int(r.shape[1])
        ranges, n_ranges, _ = plan.occ_fused
        code = lib.photon_bell_bucket_rmatvec(
            *plan.occ_args, ranges, n_ranges, r.data_ptr(), lanes, 0,
            out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    for lanes in (None, 8):
        shape = (n,) if lanes is None else (n, lanes)
        r = torch.from_numpy(rng.uniform(-1, 1, size=shape).astype(
            np.float32)).to(dev)
        outs = {v: torch.empty((U,) + shape[1:], device=dev) for v in libs}
        for v, lib in libs.items():
            call(lib, r, outs[v])
        torch.cuda.synchronize()
        if not torch.equal(outs["ldcs"], outs["ldg"]):
            raise AssertionError("the two variants differ")
        for cold in (False, True):
            got = {v: [] for v in libs}
            for _ in range(args.reps):
                for v in ("ldcs", "ldg", "ldg", "ldcs"):
                    got[v].append(cs.events_ms(
                        lambda: call(libs[v], r, outs[v]), cold=cold))
            print(f"rmatvec lanes={lanes} {'cold' if cold else 'warm'} L2: "
                  + "; ".join(f"{v} {np.mean(t):.5f} ms (min {min(t):.5f}, "
                              f"max {max(t):.5f})" for v, t in got.items())
                  + f"  [{gpu}]", flush=True)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
