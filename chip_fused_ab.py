#!/usr/bin/env python3
"""Time the fused value+grad kernel's ring geometries against each other
at the dense training path's shape, on one GPU.

    python3 chip_fused_ab.py [--seed N] [--reps N]

Geometries: 2, 3 or 4 stages of 16, 32 or 64 rows (those whose shared
memory fits ``kernels.fused.SMEM_BUDGET``), each launched through the
committed C entry point with its own grid (one wave of resident blocks);
and, at the committed geometry, the variant ``rolled``: a copy of
csrc/fused_vg.cu without the unroll pragmas of the margin and column
loops, built beside the committed library. On chip_smoke.py's D2 problem
(2^19 x 256 f32, logistic), checks that each one holds the plain version
(loss rel err and max|dg|/max|g| <= 1e-5), repeats bit for bit and gives
the committed kernel's bits at its geometry, then times each one's device
time by CUDA events (chip_smoke.events_ms: the host's enqueue hidden),
warm and cold L2, in turns over --reps rounds. Prints one line per
measurement (the committed one marked), then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

import chip_smoke as cs

STAGES = (2, 3, 4)
ROWS = (16, 32, 64)
UNROLLS = ("#pragma unroll 4\n", "#pragma unroll 8\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_fused_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.ops.losses import TaskType

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    libs = {"committed": KF.library()}
    src = KF.SOURCE.read_text()
    rolled = src
    for line in UNROLLS:
        if line not in rolled:
            raise AssertionError(f"the source has no {line.strip()!r}")
        rolled = rolled.replace(line, "")
    path = K.BUILD_DIR / "ab" / "fused_vg_rolled.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(rolled)
    libs["rolled"] = K.load_library(path)
    for name in ("photon_fused_vg", "photon_fused_vg_grid"):
        fn, ref = getattr(libs["rolled"], name), getattr(libs["committed"],
                                                         name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    lib = libs["committed"]
    X, y = cs.dense_problem(args.seed)
    batch = make_batch(X, y, device=dev)
    del X
    X = batch.X
    n, d = (int(s) for s in X.shape)
    w = torch.from_numpy(np.random.default_rng(args.seed + 7).normal(
        size=d, scale=0.1).astype(np.float32)).to(dev)
    task = TaskType.LOGISTIC_REGRESSION
    call_args = (task, X, w, batch.y, batch.weights, batch.offsets)
    want = KF.fused_value_and_grad_reference(*call_args)
    committed = (KF.tile_rows(d, 4), KF.stages(d, 4))  # (rows, stages)

    geoms = {}
    for stages in STAGES:
        for rows in ROWS:
            smem = KF.smem_bytes(rows, stages, d, 4)
            if smem > KF.SMEM_BUDGET:
                print(f"fused {stages} stages x {rows} rows: {smem} B of "
                      "shared memory, over the budget: skipped", flush=True)
                continue
            ctas = ctypes.c_int(0)
            code = lib.photon_fused_vg_grid(n, d, 0, rows, stages,
                                            ctypes.byref(ctas))
            if code:
                raise RuntimeError(f"grid query failed: {code}")
            for variant in libs:
                if variant == "committed" or (rows, stages) == committed:
                    buf = torch.empty(((ctas.value + 1) * (d + 1),),
                                      device=dev)
                    geoms[(variant, rows, stages)] = (ctas.value, smem, buf)

    def call(g) -> torch.Tensor:
        variant, rows, stages = g
        ctas, _, buf = geoms[g]
        out = buf[ctas * (d + 1):]
        code = K.launch(libs[variant].photon_fused_vg, 0, X.data_ptr(),
                        w.data_ptr(),
                        batch.y.data_ptr(), batch.weights.data_ptr(),
                        batch.offsets.data_ptr(), n, d, 0, 0, rows, stages,
                        ctas, buf.data_ptr(), out.data_ptr())
        if code:
            raise RuntimeError(f"{g}: launch failed: {code}")
        return out

    outs = {}
    for g in geoms:
        first = call(g).clone()
        again = call(g)
        torch.cuda.synchronize()
        outs[g] = first
        if not torch.equal(first, again):
            raise AssertionError(f"{g}: a second call differs")
        rel_loss, rel_g = cs.fused_errors((first[d], first[:d]), want)
        if not (rel_loss <= 1e-5 and rel_g <= 1e-5):
            raise AssertionError(f"{g}: loss rel err {rel_loss:.3g}, "
                                 f"max|dg|/max|g| {rel_g:.3g}")
    if not torch.equal(outs[("rolled",) + committed],
                       outs[("committed",) + committed]):
        raise AssertionError("the rolled variant changes the bits")
    print(f"fused ring variants hold the plain version and repeat bit for "
          f"bit ({len(geoms)} measurements); the rolled variant gives the "
          f"committed kernel's bits", flush=True)
    turns = list(geoms) + list(reversed(geoms))
    got = {(g, cold): [] for g in geoms for cold in (False, True)}
    for _ in range(args.reps):
        for cold in (False, True):
            for g in turns:
                got[(g, cold)].append(cs.events_ms(lambda: call(g),
                                                   cold=cold))
    bound = (n * d * 4 + 3 * n * 4 + 2 * d * 4) / cs.HBM_BYTES_PER_S * 1e3
    for g, (ctas, smem, _) in geoms.items():
        variant, rows, stages = g
        warm, cold = got[(g, False)], got[(g, True)]
        mark = " (committed)" if g == ("committed",) + committed else ""
        print(f"fused {variant} {stages} stages x {rows} rows{mark}: "
              f"{smem} B shared, {ctas} blocks ({ctas / 132:.2f} per SM on "
              f"132 SMs), {stages * rows * d * 4 * ctas // 132 >> 10} KB of "
              f"tiles per SM; device ms warm {np.median(warm):.5f} (min "
              f"{min(warm):.5f}, max {max(warm):.5f}), cold "
              f"{np.median(cold):.5f} (min {min(cold):.5f}, max "
              f"{max(cold):.5f}); bound {bound:.5f} ms, "
              f"{bound / np.median(warm):.3f} of it warm  [{gpu}]",
              flush=True)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
