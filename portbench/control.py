"""The judge's readings on the card, at a cell's own size: the sound
program, the control (the program's own lower-precision path) and each
planted fault, one recorded fit each, over a few seeds in one process.
The limits in ``portbench/limits/`` are set from these and from the
benchmark runs' readings; the benchmark's own runs do not run this.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \\
        [--variants program control_bf16_history]

One JSON line a seed: {variant: {number: reading}}; the variants are the
cell's entry's (``control_readings`` in ``portbench/entries/<entry>.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the variants to run (default: all)")
    args = ap.parse_args(argv)

    import torch

    from portbench import spec
    from portbench.run import prepare_checkout

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    prepare_checkout(spec.ROOT)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    E = spec.entry(cell["traffic"]["entry"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = E.control_readings(cell, seed, variants=args.variants)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
