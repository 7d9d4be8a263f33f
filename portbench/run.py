"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the data from the seed on the card, builds the layout
through the port, and warms up with one whole fit of the cell's shapes.
The window then fits whole grids back to back until ``--seconds`` have
passed; the fit in progress finishes, and the window is the span of those
whole fits. ``--trace 1`` also profiles two whole fits after the window
and counts one fit's host-device synchronizations, and reports the
per-layer metrics in place of the end-to-end ones.

The traffic mix names the entry the window drives, a module of
``portbench/entries/`` that sets the cell up, runs one fit, and judges
what the timed fits produced against the plain reference
(``portbench/reference/``). Once the window has closed and the peak
memory is read, one more fit of the same problem keeps the solver's state
at an iteration drawn from the seed, the program's state is freed, and
the reference judges. The last lines on standard error, and the
``checks`` key that ends the result line, give each number compared
beside its limit (``portbench/limits/<cell>.json``).

Without a CUDA card (or with fewer than the cell asks for) it exits with
code 2 and prints no result. It exits with code 3, printing no result,
if JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import resource
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "photon_tpu")
TRACE_FITS = 2


def process_start() -> float:
    """The wall-clock time this process started, from the kernel's record
    of it (``/proc/self/stat``); where that cannot be read, now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def prepare_checkout(root: Path) -> None:
    """Fixed cache directories inside the checkout, and no stale build
    lock: a lock left by a killed build makes the next load wait forever."""
    build = root / "photon_tpu_torch" / "kernels" / "_build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for d in (build, root / "photon_tpu_torch" / "native" / "_build"):
        for lock in d.glob("**/lock"):
            lock.unlink()


@dataclasses.dataclass
class Run:
    """What one run recorded; the per-layer readers read it."""

    cell: dict
    rows: int
    lanes: int
    history: int
    counts: object              # roofline.DataCounts
    layout_build_s: float
    setup_s: float = 0.0
    fits: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    trace: dict | None = None
    syncs: dict | None = None
    replay_gap: float | None = None   # the recorded fit against the kept
    check_iteration: int | None = None  # where the recorded state is from


def replay_gap(a: dict, b: dict):
    """How far two fits' loss histories lie apart (0 where they agree bit
    for bit, NaNs of stopped lanes included); None without histories."""
    import numpy as np

    if "history" not in a or "history" not in b:
        return None
    x, y = np.asarray(a["history"]), np.asarray(b["history"])
    if x.shape != y.shape or not (np.isnan(x) == np.isnan(y)).all():
        return float("inf")
    ok = ~np.isnan(x)
    return float(np.max(np.abs(x[ok] - y[ok]) / np.abs(y[ok]), initial=0))


def measure(cell: dict, seed: int, seconds: float, trace: bool,
            device="cuda", hooks=None):
    """Set-up, window, optional trace, then the reference's judgement.
    Returns (Run, numbers, memory_peak_bytes). ``hooks`` (faults):
    ``{"batch": f}`` for the entry's ``Session``; ``{"fit": f}``, where
    ``f(session)`` gives the hook of ``Session.fit``."""
    import torch

    from portbench import devtrace, spec

    E = spec.entry(cell["traffic"]["entry"])
    hooks = hooks or {}
    s = E.Session(cell, seed, device, hooks.get("batch"))
    run = Run(cell=cell, rows=s.rows, lanes=s.lanes, history=s.history,
              counts=s.counts, layout_build_s=s.layout_build_s)
    fit = hooks["fit"](s) if "fit" in hooks else None
    s.fit(fit)  # warm: builds the kernels, the plans and the caches
    run.setup_s = time.time() - T_PROCESS

    # window: whole fits until `seconds` have passed; one fit's output,
    # drawn from the seed (reservoir), is kept for the check
    rng = random.Random(seed)
    kept = None
    t_start = time.perf_counter()
    while True:
        res, rec = s.fit(fit)
        run.fits.append(rec)
        if rng.random() * len(run.fits) < 1.0:
            kept = s.kept(res, rec)
        del res
        if time.perf_counter() - t_start >= seconds:
            break
    run.window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(s.dev) if s.dev.type == "cuda"
            else 0)

    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACE_FITS):
                s.fit(fit)
            traced_s = time.perf_counter() - t0
        run.trace = devtrace.read_trace(prof, traced_s)
        del prof
        counted = {}

        def count(call):  # the program's syncs, not the record's reads
            with devtrace.count_syncs() as syncs:
                out = call() if fit is None else fit(call)
            counted.update(syncs)
            return out

        rec = s.fit(count)[1]
        run.syncs = dict(counted, lockstep_iters=rec["lockstep_iters"])

    # the solver's state at an iteration drawn from the seed, in one more
    # fit of the same problem
    rec, _, at = s.record(fit)
    run.replay_gap = replay_gap(rec, kept[1])
    run.check_iteration = None if at is None else at.get("it")
    del rec
    s.release()
    numbers = s.reference().judge(run.fits, kept, at)
    return run, numbers, peak


def end_to_end(run: Run) -> dict:
    fits = run.fits
    rows_iters = run.rows * sum(f["iters_sum"] for f in fits)
    return {"rows_iters_per_s": rows_iters / run.window_s,
            "fit_s": run.window_s / len(fits),
            "setup_s": run.setup_s}


def result_line(run: Run, numbers: dict, peak: int, trace: bool) -> dict:
    """The result's JSON object (``checks`` last)."""
    import torch

    from portbench import judge, spec

    cell = run.cell
    limits = cell["limits"]
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(run)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["entry"]["chips"]),
              "memory_peak_bytes": int(peak)}
    out = {"correct": judge.verdict(numbers, limits),
           "attempted": len(run.fits) * run.lanes,
           "failed": sum(f["failed"] for f in run.fits),
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": numbers.get(k, float("nan")),
                         "limit": limits[k]} for k in limits}
    return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    prepare_checkout(spec.ROOT)
    run, numbers, peak = measure(cell, args.seed, args.seconds,
                                 bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the benchmark measures the "
              f"port alone", file=sys.stderr)
        return 3
    out = result_line(run, numbers, peak, bool(args.trace))
    info = {"card": power_limit(), "fits": len(run.fits),
            "host_peak_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "layout_build_s": run.layout_build_s,
            "fit_walls": [round(f["wall_s"], 4) for f in run.fits],
            "iterations": [f["iterations"].tolist() for f in run.fits[:1]],
            "check_iteration": run.check_iteration,
            "replay_gap": run.replay_gap}
    if args.trace:
        from portbench import roofline

        f = run.fits[0]
        work = roofline.fit_work(
            run.counts, run.lanes, f["launches"].get("tail_matvec", 0),
            f["launches"].get("bucket_rmatvec", 0), f["lockstep_iters"],
            run.history)
        info["iter_mfu_bound"] = work.least_s()[1]
        info["syncs_by_site"] = run.syncs["sites"]
    print("portbench: " + json.dumps(info, default=str), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
