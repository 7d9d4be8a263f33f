"""CLI: smoke-check the telemetry spine and the observability plane (port
of `photon_tpu/telemetry/__main__.py`).

    python -m photon_tpu_torch.telemetry --selftest [--json] [--device cpu]
    python -m photon_tpu_torch.telemetry --report PATH       # a JSONL file
    python -m photon_tpu_torch.telemetry --health PATH [--prom OUT]

The selftest runs on the card unless given ``--device cpu``, and checks:
span nesting and exception safety, cross-thread counter aggregation, the
live iteration stream of a tiny streamed L-BFGS solve, the JSONL
round-trip (the file reassembles to the in-memory report), the resident
tap (``telemetry_off_is_free``: a resident margin-cached L-BFGS solve
makes one sync at its start and one an iteration whether the tap is off
or armed, with the same history bits, and the armed events equal that
history), request tracing (``serving_trace_off_is_free``: collated rung
arguments, scores and kernel launches identical armed and disarmed;
the slowest exemplar names an injected slow hop), the quantile digest's
p99 error and exact merge, the watchdog verdicts, the cross-rank
aggregation (a torn tail and a missing rank named, never a crash), the
health report read back from a rank file, and on the card the device
memory gauges against `torch.cuda.max_memory_allocated`. ``--health``
rebuilds a `HealthReport` from a run's JSONL file and prints it as JSON
(``--prom OUT`` also writes its Prometheus textfile). Exit 1 on any
failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def _resident_problem(dev):
    import numpy as np
    import torch

    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.models.training import make_objective
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    rng = np.random.default_rng(0)
    n, d = 96, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    cfg = OptimizerConfig(max_iters=6, tolerance=1e-7, reg=l2(),
                          reg_weight=0.3, history=4)
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, d, device=dev)
    return cfg, obj, make_batch(X, y, device=dev), \
        torch.zeros(d, dtype=torch.float32, device=dev)


def resident_tap_check(dev) -> dict:
    """The resident tap's off-is-free facts on ``dev``: the syncs of a
    resident L-BFGS solve with telemetry off and with a tap-armed run,
    their histories, and the armed run's events."""
    import torch

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.optim.lbfgs import minimize_lbfgs_margin
    from photon_tpu_torch.telemetry import trace
    from photon_tpu_torch.utils.profiling import count_syncs

    cfg, obj, batch, w0 = _resident_problem(dev)

    def solve():
        return minimize_lbfgs_margin(obj, batch, w0, max_iters=cfg.max_iters,
                                     tolerance=cfg.tolerance,
                                     history=cfg.history)

    # the first solve under the sync debug mode makes a one-time sync of
    # its own on the card: one counted solve first, its count dropped
    with telemetry.tap_disabled(), trace.trace_disabled():
        with count_syncs(dev):
            solve()
        with count_syncs(dev) as off_syncs:
            off = solve()
    with telemetry.run("selftest_tap", resident_tap=True) as r:
        with count_syncs(dev) as on_syncs:
            on = solve()
    n = on.iterations + 1
    events = [e for e in r.iterations if e["solver"] == "lbfgs_margin"]
    hist = on.loss_history[:n].cpu().tolist()
    ghist = on.grad_norm_history[:n].cpu().tolist()
    return {
        "iterations": int(on.iterations),
        "syncs_off": off_syncs["n"], "syncs_armed": on_syncs["n"],
        "same_bits": bool(torch.equal(off.loss_history.nan_to_num(),
                                      on.loss_history.nan_to_num())
                          and torch.equal(off.w, on.w)),
        "events_equal": ([e["loss"] for e in events] == hist
                         and [e["grad_norm"] for e in events] == ghist
                         and [e["it"] for e in events] == list(range(n))),
    }


def serving_trace_check(dev) -> dict:
    """Tracing armed vs disarmed through one small dispatcher on ``dev``:
    the collated rung arguments, the scores and the kernel launches."""
    import numpy as np
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import serving
    from photon_tpu_torch.serving.__main__ import (build_demo_model,
                                                   demo_requests)
    from photon_tpu_torch.serving.dispatcher import (_Pending,
                                                     collate_rung_args)
    from photon_tpu_torch.telemetry.run import signature
    from photon_tpu_torch.telemetry import trace

    model, rng = build_demo_model(device=dev)
    store = serving.CoefficientStore.from_game_model(model, device=dev)
    ladder = serving.ProgramLadder(store, ladder=(8,),
                                   sparse_k={"member": 3}, quantize="int8",
                                   quant_epsilon=0.5)
    ladder.warmup()
    reqs = demo_requests(model, rng, 8)
    with trace.trace_disabled():
        off = collate_rung_args(ladder, [_Pending(q) for q in reqs], 8)
    with trace.tracing(k=2):
        on = collate_rung_args(ladder, [_Pending(q) for q in reqs], 8)
    same_args = (signature(off[:3]) == signature(on[:3])
                 and all(torch.equal(a, b) for a, b in (
                     (off[0], on[0]), (off[2]["perEntity"],
                                       on[2]["perEntity"]))))

    def serve():
        K.reset_launch_counts()
        d = serving.MicroBatchDispatcher(ladder, max_batch=8,
                                         max_delay_us=2000)
        try:
            got = [f.result(timeout=60) for f in
                   [d.submit(q) for q in reqs]]
        finally:
            d.close()
        return np.asarray(got), K.launch_counts()

    with trace.trace_disabled():
        s_off, l_off = serve()
    with trace.tracing(k=4) as res:
        s_on, l_on = serve()
    slow = res.slowest()
    return {"same_args": bool(same_args),
            "same_scores": bool(np.array_equal(s_off, s_on)),
            "launches_off": l_off, "launches_on": l_on,
            "exemplars": res.n_offered,
            "hops": sorted((slow or {}).get("breakdown_ms", {}))}


def selftest(device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.telemetry import trace
    from photon_tpu_torch.telemetry.aggregate import aggregate_cluster
    from photon_tpu_torch.telemetry.health import (DEFAULT_RULES,
                                                   QuantileDigest,
                                                   report_from_jsonl)
    from photon_tpu_torch.telemetry.sinks import load_report

    dev = resolve_device(device)
    checks: dict = {}

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks[name] = "" if ok else (detail or "failed")

    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "selftest.jsonl")
        r = telemetry.start_run("selftest", jsonl_path=jsonl)
        try:
            with telemetry.span("outer"):
                with telemetry.span("inner"):
                    pass
            try:
                with telemetry.span("boom"):
                    raise ValueError("expected")
            except ValueError:
                pass
            spans = {s.path: s for s in r.spans}
            check("span_nesting", "outer/inner" in spans and "outer" in spans,
                  f"paths: {sorted(spans)}")
            check("span_exception_safety",
                  spans.get("boom") is not None
                  and spans["boom"].error == "ValueError")

            def bump():
                for _ in range(1000):
                    telemetry.count("selftest.bumps")

            threads = [threading.Thread(target=bump) for _ in range(4)]
            [t.start() for t in threads]
            [t.join() for t in threads]
            check("counter_threads",
                  r.counters.get("selftest.bumps") == 4000.0,
                  f"got {r.counters.get('selftest.bumps')}")

            # a real (tiny) streamed solve drives the iteration stream
            from photon_tpu_torch.data.dataset import chunk_batch, make_batch
            from photon_tpu_torch.models.training import train_glm
            from photon_tpu_torch.ops.losses import TaskType
            from photon_tpu_torch.optim.config import OptimizerConfig
            from photon_tpu_torch.optim.regularization import l2

            rng = np.random.default_rng(0)
            X = rng.normal(size=(96, 5)).astype(np.float32)
            y = (rng.uniform(size=96) < 0.5).astype(np.float32)
            cb = chunk_batch(make_batch(X, y, device="cpu"), 32)
            cfg = OptimizerConfig(max_iters=4, tolerance=1e-7, reg=l2(),
                                  reg_weight=0.1, history=3)
            _, res = train_glm(cb, TaskType.LOGISTIC_REGRESSION, cfg,
                               device=dev)
            events = [e for e in r.iterations
                      if e["solver"] == "lbfgs_streamed"]
            hist = res.history()
            hist = np.asarray(hist.cpu() if torch.is_tensor(hist) else hist)
            # the host loop keeps f64 scalars; its history stores f32
            check("iteration_stream",
                  len(events) == hist.shape[0]
                  and np.array_equal(np.asarray(
                      [e["loss"] for e in events], np.float32), hist),
                  f"{len(events)} events vs {hist.shape[0]} history rows")
            check("stream_counters",
                  r.counters.get("stream.chunk_uploads", 0) > 0
                  and r.counters.get("solver.iterations", 0) > 0,
                  f"counters: {sorted(r.counters)}")
        finally:
            report = telemetry.finish_run()

        disk = load_report(jsonl)
        check("jsonl_roundtrip",
              disk["complete"]
              and disk["counters"] == report["counters"]
              and len(disk["spans"]) == len(report["spans"])
              and len(disk["iterations"]) == report["n_iteration_events"],
              "disk report does not match the in-memory one")

    # ---- the resident tap: off is free, armed rides the same syncs
    # (the CPU counts read-backs, which must be exactly one at the start
    # and one an iteration; on the card the debug mode counts every wait)
    tap = resident_tap_check(dev)
    check("telemetry_off_is_free",
          tap["syncs_off"] == tap["syncs_armed"] and tap["same_bits"]
          and (dev.type == "cuda"
               or tap["syncs_off"] == tap["iterations"] + 1),
          f"{tap}")
    check("resident_tap_events", tap["events_equal"], f"{tap}")

    # ---- request tracing: nothing on the device changes when armed
    st = serving_trace_check(dev)
    check("serving_trace_off_is_free",
          st["same_args"] and st["same_scores"]
          and st["launches_off"] == st["launches_on"]
          and st["exemplars"] == 8
          and {"queue_wait", "device_flush", "retire_wait"}
          <= set(st["hops"]), f"{st}")

    with trace.tracing(k=2) as res:
        tc = trace.begin("queue_wait")
        trace.hop(tc, "device_flush")
        time.sleep(0.03)  # the injected slow hop
        trace.hop(tc, "retire_wait")
        trace.finish(tc)
        for _ in range(3):
            trace.finish(trace.begin("queue_wait"))
        slow = res.slowest()
    check("trace_exemplar_attribution",
          slow is not None and slow["slowest_hop"] == "device_flush"
          and res.n_offered == 4,
          f"slowest={slow and slow['slowest_hop']} "
          f"offered={res.n_offered}")
    check("trace_disarmed_is_off",
          trace.begin("queue_wait") is None and trace.reservoir() is None)

    rng = np.random.default_rng(19)
    samples = rng.lognormal(mean=14.0, sigma=1.2, size=20_000)  # ns scale
    d1, d2 = QuantileDigest(), QuantileDigest()
    d1.add_many(samples[:10_000])
    d2.add_many(samples[10_000:])
    d1.merge(d2)
    exact_p99 = float(np.quantile(samples, 0.99))
    err = abs(d1.quantile(0.99) - exact_p99) / exact_p99
    check("digest_p99_error", err <= 0.01, f"rel err {err:.4f}")

    shed = DEFAULT_RULES[0]
    quiet = shed.evaluate({"serving.shed": 0, "serving.admitted": 100})
    loud = shed.evaluate({"serving.shed": 30, "serving.admitted": 100})
    check("watchdog_verdicts",
          quiet["verdict"] == "OK" and loud["verdict"] == "CRITICAL",
          f"quiet={quiet['verdict']} loud={loud['verdict']}")

    with tempfile.TemporaryDirectory() as tdir:
        for rank in range(2):
            telemetry.start_run(f"agg_rank{rank}", jsonl_path=os.path.join(
                tdir, f"p{rank}.jsonl"))
            with telemetry.span("ingest.decode"):
                telemetry.count("ingest.chunks", 3.0)
            telemetry.finish_run()
        with open(os.path.join(tdir, "p1.jsonl"), "a") as f:
            f.write('{"type": "torn')  # mid-record tear after run_end
        rep = aggregate_cluster(tdir, expect_ranks=3)
        check("aggregate_roundtrip",
              rep["n_ranks"] == 2 and rep["missing_ranks"] == [2]
              and not rep["complete"]
              and rep["counters_total"].get("ingest.chunks") == 6.0
              and rep["skew"]["straggler_rank"] in (0, 1),
              f"ranks={rep['n_ranks']} missing={rep['missing_ranks']} "
              f"totals={rep['counters_total']}")
        hrep = report_from_jsonl(os.path.join(tdir, "p0.jsonl"))
        check("health_from_jsonl",
              hrep.verdict == "OK" and hrep.name == "agg_rank0"
              and all(r["verdict"] == "OK" for r in hrep.rules)
              and "photon_tpu_health_verdict 0" in hrep.prometheus(),
              f"verdict={hrep.verdict} name={hrep.name}")

    if dev.type == "cuda":
        with telemetry.run("selftest_memory") as r:
            torch.cuda.reset_peak_memory_stats(dev)
            block = torch.empty(1 << 24, dtype=torch.uint8, device=dev)
            telemetry.sample_device_memory("probe")
            want = torch.cuda.max_memory_allocated(dev)
            del block
        got = r.gauges.get("hbm.peak_bytes_in_use.max.probe")
        check("device_memory_gauges",
              got == want and want >= 1 << 24
              and "hbm.bytes_in_use.max.final" in r.gauges,
              f"gauge {got} vs max_memory_allocated {want}")

    failures = {k: v for k, v in checks.items() if v}
    return {"ok": not failures, "device": str(dev),
            "checks": {k: (v or "ok") for k, v in checks.items()},
            "resident_tap": tap,
            "serving_trace": {k: st[k] for k in ("launches_off",
                                                  "launches_on")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.telemetry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", metavar="PATH")
    ap.add_argument("--health", metavar="PATH")
    ap.add_argument("--prom", metavar="OUT")
    args = ap.parse_args(argv)
    if args.report:
        from photon_tpu_torch.telemetry.sinks import load_report

        rep = load_report(args.report)
        rep["spans"] = rep["spans"][:50]
        rep["iterations"] = rep["iterations"][:50]
        print(json.dumps(rep, indent=2))
        return 0
    if args.health:
        from photon_tpu_torch.telemetry.health import report_from_jsonl

        rep = report_from_jsonl(args.health)
        print(json.dumps(rep.to_json(), indent=2))
        if args.prom:
            with open(args.prom, "w") as f:
                f.write(rep.prometheus())
        return 0
    if not args.selftest:
        ap.print_help()
        return 2
    report = selftest(args.device)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        for name, v in report["checks"].items():
            print(("ok   " if v == "ok" else "FAIL ") + name
                  + ("" if v == "ok" else f": {v}"))
        print(f"{len(report['checks'])} check(s), "
              f"{sum(v != 'ok' for v in report['checks'].values())} "
              f"failure(s) on {report['device']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
