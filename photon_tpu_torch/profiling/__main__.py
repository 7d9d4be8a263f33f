"""CLI: render the performance attribution ledger (port of
`photon_tpu/profiling/__main__.py`).

    python -m photon_tpu_torch.profiling --report [--json]
    python -m photon_tpu_torch.profiling --report --rows N --chunk-rows C
    python -m photon_tpu_torch.profiling --report --bench-dir DIR
    python -m photon_tpu_torch.profiling --selftest [--json]

Each runs on the card unless given ``--device cpu``.

``--report`` attaches a process-wide `Ledger` (and a telemetry run),
drives a STREAMED-DENSE solve — the regime whose passes close at host
read-backs, so their measured seconds are device plus stream time —
through the instrumented `optim/streamed.py` path, then renders: per
(program, phase) attribution entries with static FLOP and byte
estimates, measured seconds and a roofline share in (0, 1] against the
device's own peaks (named by ``peaks_source``); per-program first-call
accounts and signature counts; per-phase device memory. With
``--bench-dir`` it also embeds the bench sentinel's per-leg verdicts over
that directory's BENCH_r*.json trajectory; without one, no gate (the
repo's own rounds are the JAX package's, TPU and CPU, not the port's).

``--selftest`` runs the report on a small problem and checks the
acceptance facts: every streamed attribution entry has static estimates,
a measured time and a roofline share in (0, 1]; the first-call account
adds up; and the ledger is free when off and when on — a resident
L-BFGS solve gives the same bits and the same host↔device syncs
(`utils.profiling.count_syncs`) with the ledger armed and disarmed; and
the ``contracts`` check holds the registered ``ledger_off_is_free``
contract (`analysis/`) on the same device. The umbrella ``python -m
photon_tpu_torch --selfcheck`` aggregates it.
"""
from __future__ import annotations

import argparse
import json
import sys


def run_report(rows: int = 1 << 14, chunk_rows: int = 1 << 12,
               d: int = 32, max_iters: int = 6, bench_dir=None,
               device: str = "cuda") -> dict:
    """Drive one streamed-dense solve on ``device`` under a fresh ledger
    and telemetry run; returns {"ledger": ..., "device": ...} and, with a
    ``bench_dir`` whose history is not empty, "gate"."""
    import numpy as np

    from photon_tpu_torch import profiling, telemetry
    from photon_tpu_torch.data.dataset import chunk_batch, make_batch
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=rows) < p).astype(np.float32)
    cb = chunk_batch(make_batch(X, y, device="cpu"), chunk_rows)
    cfg = OptimizerConfig(max_iters=max_iters, tolerance=0.0, reg=l2(),
                          reg_weight=1e-3, history=5)

    led = profiling.start_ledger("profiling_report", devices=dev)
    telemetry.start_run("profiling_report")
    try:
        led.sample_hbm("start")
        train_glm(cb, TaskType.LOGISTIC_REGRESSION, cfg, device=dev)
        led.sample_hbm("streamed_dense")
    finally:
        telemetry.finish_run()
        profiling.finish_ledger()
    out = {"ledger": led.report(), "device": _device_name(dev)}

    if bench_dir:
        history = profiling.sentinel.load_history(bench_dir)
        if history:
            _, candidate, env = history[-1]
            verdicts = profiling.sentinel.gate(
                candidate, profiling.sentinel.same_env(history[:-1], env))
            out["gate"] = {leg: v.to_json() for leg, v in verdicts.items()}
    return out


def _device_name(dev) -> str:
    import torch

    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def _render_human(out: dict) -> None:
    rep = out["ledger"]
    peaks = rep["peaks"]

    def g(v):
        return "none" if v is None else f"{v:.3g}"

    print(f"attribution ledger '{rep['name']}' on {out['device']} "
          f"({rep['duration_s']:.3f}s wall, peaks: "
          f"{g(peaks['flops_per_s'])} FLOP/s, {g(peaks['bytes_per_s'])} "
          f"B/s from {rep['peaks_source']})")
    print("top programs by measured time:")
    for e in rep["attribution"][:12]:
        util = e.get("utilization")
        tail = ""
        if util is not None:
            tail = (f"  util={100.0 * util:.1f}% ({e['bound']}-bound, "
                    f"{e['achieved_flops_per_s']:.3g} FLOP/s, "
                    f"{e['achieved_bytes_per_s']:.3g} B/s)")
        print(f"  {e['program']} [{e['phase']}]  "
              f"{e['seconds']:.4f}s / {e['calls']} call(s)" + tail)
    comp = rep["compile"]
    share = comp["share_of_measured"]
    print(f"first calls: {comp['wall_s']:.3f}s wall, "
          f"{comp['retraces']} signature(s)"
          + (f", {100.0 * share:.1f}% of measured time"
             if share is not None else ""))
    for name, prog in rep["programs"].items():
        st = prog.get("static")
        if st is None:
            continue
        print(f"  {name}: modeled {st['flops']:.3g} FLOP / "
              f"{st['bytes']:.3g} B per call")
    if rep["hbm"]:
        print(f"device memory watermarks: {rep['hbm']}")
    gate = out.get("gate")
    if gate:
        print("bench gate (latest round vs history):")
        for leg, v in sorted(gate.items()):
            print(f"  {leg}: {v['line']}")


def ledger_free(device: str = "cuda") -> dict:
    """A small resident L-BFGS solve with the ledger disarmed and armed:
    {"same_bits", "syncs_off", "syncs_armed", "entries"} (the armed
    solve's attribution entries)."""
    import numpy as np
    import torch

    from photon_tpu_torch import profiling
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.utils.profiling import count_syncs

    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = (rng.uniform(size=256) < 0.5).astype(np.float32)
    batch = make_batch(X, y, device=dev)
    cfg = OptimizerConfig(max_iters=6, tolerance=0.0, reg=l2(),
                          reg_weight=0.3, history=4)

    def solve():
        _, res = train_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                           device=dev)
        return res.w

    # warm, counted and dropped: first-call costs (and the sync debug
    # mode's one-time sync on the card) land in neither leg
    with count_syncs(dev):
        solve()
    with profiling.ledger_disabled(), count_syncs(dev) as off:
        w_off = solve()
    with profiling.ledger("ledger_free", devices=dev) as led, \
            count_syncs(dev) as armed:
        w_on = solve()
    return {"same_bits": bool(torch.equal(w_off, w_on)),
            "syncs_off": off["n"], "syncs_armed": armed["n"],
            "entries": len(led.report()["attribution"])}


def run_selftest(device: str = "cuda") -> dict:
    checks: dict = {}

    def check(name: str, ok: bool, **detail) -> None:
        checks[name] = {"ok": bool(ok), **detail}

    out = run_report(rows=1 << 12, chunk_rows=1 << 10, d=16, max_iters=4,
                     device=device)
    rep = out["ledger"]
    entries = [e for e in rep["attribution"]
               if e["program"].startswith("streamed.")]
    check("has_streamed_entries", len(entries) >= 3, n=len(entries))
    check("entries_have_static_estimates",
          bool(entries) and all("flops_modeled" in e and "bytes_modeled"
                                in e for e in entries))
    utils = [e.get("utilization") for e in entries]
    check("utilization_in_unit_interval",
          bool(entries) and all(u is not None and 0.0 < u <= 1.0
                                for u in utils), utilization=utils,
          peaks_source=rep["peaks_source"])
    check("measured_durations_positive",
          bool(entries) and all(e["seconds"] > 0 for e in entries))
    progs = rep["programs"]
    first = sum(p.get(k, 0.0) for p in progs.values()
                for k in ("compile_s", "plan_s", "dispatch_compile_s"))
    check("compile_accounting",
          rep["compile"]["retraces"] >= len(progs) >= 3
          and abs(rep["compile"]["wall_s"] - round(first, 6)) <= 1e-5
          and all(p.get("xla", "absent") is None for p in progs.values()),
          retraces=rep["compile"]["retraces"],
          wall_s=rep["compile"]["wall_s"])
    free = ledger_free(device)
    check("ledger_off_is_free",
          free["same_bits"] and free["syncs_off"] == free["syncs_armed"]
          and free["entries"] >= 1, **free)
    from photon_tpu_torch.analysis.contracts import check_names

    checks["contracts"] = check_names(("ledger_off_is_free",), device)
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": out["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.profiling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--rows", type=int, default=1 << 14)
    ap.add_argument("--chunk-rows", type=int, default=1 << 12)
    ap.add_argument("--bench-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.selftest:
        report = run_selftest(args.device)
        if args.json:
            print(json.dumps(report))
        else:
            for k, v in report["checks"].items():
                print(("ok   " if v["ok"] else "FAIL ") + k)
            n_bad = sum(not v["ok"] for v in report["checks"].values())
            print(f"{len(report['checks'])} check(s), {n_bad} failure(s)")
        return 0 if report["ok"] else 1
    if args.report:
        out = run_report(rows=args.rows, chunk_rows=args.chunk_rows,
                         bench_dir=args.bench_dir, device=args.device)
        if args.json:
            print(json.dumps(out))
        else:
            _render_human(out)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
