"""Umbrella selfcheck CLI (port of `photon_tpu/__main__.py`): one line
over every subsystem's own smoke.

    python -m photon_tpu_torch --selfcheck            # one summary line
    python -m photon_tpu_torch --selfcheck --json     # machine report
    python -m photon_tpu_torch --selfcheck --only telemetry profiling
    python -m photon_tpu_torch --selfcheck --device cpu --jobs 3

Runs the ported per-package selftests as subprocesses (one crashed
subsystem cannot take the others down), each on the card unless given
``--device cpu`` (passed through), ``--jobs`` of them at a time
(default 1: one after another):

- ``parallel``   — the multi-process spine (gloo, so any number of
  processes share one card): 1/2/4-process launches bit for bit, the
  snapshot restored at other counts, the barrier-correct commit (first:
  the longest suite);
- ``telemetry``  — sinks, spans, the iteration stream, the off states,
  tail exemplars, the quantile digest, watchdog verdicts, cross-rank
  aggregation;
- ``serving``    — store + dispatcher offline parity, the cold-miss
  fallback, the int8 rung, the retrace bound, the replica fleet;
- ``checkpoint`` — kill → restore → bit parity, the resident taps off;
- ``profiling``  — the attribution ledger's report (static estimates and
  roofline shares in (0, 1] on a streamed-dense run, the first-call
  account) and the ledger free when off and on;
- ``game``       — GAME on a 2-slot mesh: streamed-mesh against resident
  parity, the blocked-ELL mesh chunk ladder, the beyond-resident regime;
- ``continual``  — delta plan, partial refresh (untouched entities bit
  for bit, no new signature), the parity-probed hot swap into a live
  int8 ladder with a kill mid-swap;
- ``ingest``     — one-pass scan, worker-pool decode parity (with a
  worker kill), the chunk cache (torn commit, CRC, key change), the
  ladder cache, the prefetch controller;
- ``kernels``    — the blocked-ELL kernels against their plain versions
  (fused and tiled bit for bit on the card), the streamed ladder solve,
  the dispatch seam's route, the upload ring's plans;
- ``tuning``     — the lane tuner's rounds, signatures, GP ladder, q-EI
  edges and budget;
- ``analysis``   — every registered hot-path contract (``python -m
  photon_tpu_torch.analysis --json``) on the same device;
- ``lint``       — the source auditor (``python -m photon_tpu_torch.lint
  --json``; it reads source files, so it takes no device);
- ``threads``    — the whole-program thread model and its four
  concurrency rules (``python -m photon_tpu_torch.lint --threads
  --json``).

Every suite of the reference's umbrella is ported, so the JSON's
``"pending"`` is empty.

Exit status: 0 iff every suite that ran passed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SUITES: tuple = (
    # the longest first: with --jobs it overlaps the rest
    ("parallel", ("photon_tpu_torch.parallel", "--selftest", "--json",
                  "--backend", "gloo")),
    ("analysis", ("photon_tpu_torch.analysis", "--json")),
    ("telemetry", ("photon_tpu_torch.telemetry", "--selftest", "--json")),
    ("serving", ("photon_tpu_torch.serving", "--selftest", "--json")),
    ("checkpoint", ("photon_tpu_torch.checkpoint", "--selftest", "--json")),
    ("profiling", ("photon_tpu_torch.profiling", "--selftest", "--json")),
    ("game", ("photon_tpu_torch.game", "--selftest", "--json")),
    ("continual", ("photon_tpu_torch.continual", "--selftest", "--json")),
    ("ingest", ("photon_tpu_torch.ingest", "--selftest", "--json")),
    ("kernels", ("photon_tpu_torch.kernels", "--selftest", "--json")),
    ("tuning", ("photon_tpu_torch.tuning", "--selftest", "--json")),
    ("lint", ("photon_tpu_torch.lint", "--json")),
    ("threads", ("photon_tpu_torch.lint", "--threads", "--json")),
)
# suites that read source files and take no --device
_NO_DEVICE = frozenset({"lint", "threads"})
# the reference's suites not ported yet (none)
PENDING: tuple = ()


def _run_suite(argv: tuple, device, timeout_s: float) -> dict:
    t0 = time.perf_counter()
    tail = () if device is None else ("--device", device)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", *argv, *tail],
            env=dict(os.environ), capture_output=True, text=True,
            timeout=timeout_s)
        rc = proc.returncode
        lines = (proc.stdout or proc.stderr).strip().splitlines()
        detail = lines[-1] if lines else ""
    except subprocess.TimeoutExpired:
        rc, detail = 124, f"timed out after {timeout_s:.0f}s"
    return {"rc": rc, "ok": rc == 0,
            "seconds": round(time.perf_counter() - t0, 1),
            "detail": detail}


def run_selfcheck(only=None, device: str = "cuda", jobs: int = 1,
                  timeout_s: float = 600.0) -> dict:
    """{suite: {"rc", "ok", "seconds", "detail"}} — a subprocess per
    suite, ``jobs`` at a time, in `SUITES` order in the result. A name in
    ``only`` that is not a ported suite raises."""
    names = [name for name, _ in SUITES]
    if only:
        unknown = sorted(set(only) - set(names))
        if unknown:
            raise ValueError(
                f"not a suite: {unknown} (suites: {names})")
    todo = [(name, argv) for name, argv in SUITES
            if not only or name in only]
    with ThreadPoolExecutor(max_workers=max(int(jobs), 1)) as pool:
        futures = {name: pool.submit(
            _run_suite, argv, None if name in _NO_DEVICE else device,
            timeout_s) for name, argv in todo}
        return {name: fut.result() for name, fut in futures.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--only", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    if not args.selfcheck:
        ap.print_help()
        return 2
    results = run_selfcheck(only=args.only, device=args.device,
                            jobs=args.jobs)
    ok = bool(results) and all(r["ok"] for r in results.values())
    if args.json:
        print(json.dumps({"ok": ok, "device": args.device,
                          "suites": results, "pending": list(PENDING)}))
    else:
        parts = [f"{name}={'ok' if r['ok'] else 'FAIL(rc=%d)' % r['rc']}"
                 for name, r in results.items()]
        n_ok = sum(r["ok"] for r in results.values())
        print(f"selfcheck: {' '.join(parts)} — {n_ok}/{len(results)} ok"
              + (f"; pending, not run: {' '.join(PENDING)}" if PENDING
                 else ""))
        for name, r in results.items():
            if not r["ok"]:
                print(f"  {name}: {r['detail']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
