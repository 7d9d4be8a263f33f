"""CLI: in-process snapshot → kill → restore → bit-parity check.

    python -m photon_tpu_torch.checkpoint --selftest           # exit 1 on drift
    python -m photon_tpu_torch.checkpoint --selftest --json    # machine report
    python -m photon_tpu_torch.checkpoint --selftest --device cpu

The selftest runs the elastic-run story on a small streamed solve, in
this process, on the card unless ``--device`` names another (a few
seconds):

1. an uninterrupted streamed L-BFGS solve (the reference answer);
2. the same solve killed by an injected fault at an evaluation, then
   restored from the last committed snapshot and finished — the final
   coefficients must be BIT-identical;
3. a kill injected DURING a snapshot write (payloads durable, manifest
   not yet swung) — restore must fall back to the previous committed
   manifest and still finish bit-identically;
4. the host-IO retry path: injected transient errors must be absorbed by
   `faults.retry_io`'s backoff;
5. the resident tap: disarmed under an armed session, a resident solve
   equals the session-less one bit for bit and records nothing; armed,
   it captures the final iterate; and with both resident taps forced off
   (`checkpoint.taps.resident_off_is_free`) under an armed session and a
   tap-armed telemetry run, the L-BFGS and TRON solves make the same
   host↔device syncs and bits as bare ones.

Exit 1 on any drift or failure.
"""
from __future__ import annotations

import sys


def _problem(device):
    import numpy as np

    from photon_tpu_torch.data.dataset import chunk_batch, make_batch
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    rng = np.random.default_rng(7)
    n, d = 96, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))
         ).astype(np.float32)
    cfg = OptimizerConfig(max_iters=10, tolerance=0.0, reg=l2(),
                          reg_weight=1e-2, history=4)
    batch = make_batch(X, y, device=device)
    return chunk_batch(make_batch(X, y, device="cpu"), 32), batch, cfg


def selftest(device=None) -> dict:
    import shutil
    import tempfile

    import numpy as np

    from photon_tpu_torch import checkpoint
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType

    dev = resolve_device(device)
    cb, batch, cfg = _problem(dev)
    task = TaskType.LOGISTIC_REGRESSION
    report: dict = {"device": str(dev), "checks": {}}
    ok = True

    def check(name: str, passed: bool, detail: str = "") -> None:
        nonlocal ok
        report["checks"][name] = {"ok": bool(passed),
                                  **({"detail": detail} if detail else {})}
        ok = ok and bool(passed)

    def solve():
        _, res = train_glm(cb, task, cfg, device=dev)
        return res.w.cpu().numpy().astype(np.float64)

    w_ref = solve()

    # ---- kill at an evaluation, restore, finish: bit parity
    tmp = tempfile.mkdtemp(prefix="photon_ckpt_selftest_")
    try:
        killed = False
        try:
            with checkpoint.session(tmp, every_evals=1, every_s=None,
                                    async_writer=False):
                with checkpoint.fault_plan(
                        checkpoint.FaultPlan.kill_at("evaluation", 7)):
                    solve()
        except checkpoint.InjectedFault:
            killed = True
        check("kill_injected", killed)
        with checkpoint.session(tmp, every_evals=1, every_s=None,
                                async_writer=False):
            w2 = solve()
        same = bool(np.array_equal(w_ref, w2))
        check("resume_bit_identical", same,
              "" if same else "coefficients drifted after restore")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- kill DURING a snapshot write: the previous manifest serves
    tmp2 = tempfile.mkdtemp(prefix="photon_ckpt_selftest_")
    try:
        try:
            with checkpoint.session(tmp2, every_evals=1, every_s=None,
                                    async_writer=False):
                with checkpoint.fault_plan(
                        checkpoint.FaultPlan.kill_at("snapshot_write", 4)):
                    solve()
        except checkpoint.InjectedFault:
            pass
        seq = checkpoint.SnapshotStore(tmp2).latest_seq()
        check("mid_write_fallback_manifest", seq >= 0,
              f"latest committed seq={seq}")
        with checkpoint.session(tmp2, every_evals=1, every_s=None,
                                async_writer=False):
            w3 = solve()
        check("mid_write_resume_bit_identical",
              bool(np.array_equal(w_ref, w3)))
    finally:
        shutil.rmtree(tmp2, ignore_errors=True)

    # ---- transient-IO retry/backoff
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        return "ok"

    with checkpoint.fault_plan(checkpoint.FaultPlan(
            errors={"selftest_io": 2})):
        out = checkpoint.retry_io(flaky, site="selftest_io",
                                  base_delay=0.001, sleep=lambda _s: None)
    check("io_retry_backoff", out == "ok" and calls["n"] == 1,
          f"fn called {calls['n']}x after 2 injected errors")

    # ---- the resident tap: off is free, on captures the final iterate
    _, r_off = train_glm(batch, task, cfg, device=dev)
    tmp3 = tempfile.mkdtemp(prefix="photon_ckpt_selftest_")
    try:
        with checkpoint.session(tmp3, every_evals=None, every_s=None,
                                async_writer=False) as sess:
            _, r_armed = train_glm(batch, task, cfg, device=dev)
            untouched = not any(k.startswith("resident/")
                                for k in sess._state)
        check("tap_off_is_free", untouched and bool(torch_equal(
            r_off.w, r_armed.w)))
        with checkpoint.session(tmp3, every_evals=None, every_s=None,
                                async_writer=False,
                                resident_tap=True) as sess:
            _, r_tap = train_glm(batch, task, cfg, device=dev)
            cap = sess._state.get("resident/lbfgs_margin")
        check("tap_captures_final_iterate",
              cap is not None and int(cap["it"]) == int(r_tap.iterations)
              and bool(torch_equal(cap["w"], r_tap.w)))
    finally:
        shutil.rmtree(tmp3, ignore_errors=True)

    # ---- both resident taps forced off under armed ambient state: the
    # L-BFGS and TRON solves make the syncs and bits of bare ones
    import torch

    from photon_tpu_torch.models.training import make_objective

    obj = make_objective(task, cfg, int(batch.X.shape[1]), device=dev)
    w0 = torch.zeros(int(batch.X.shape[1]), dtype=torch.float32, device=dev)
    off = checkpoint.resident_off_is_free(batch, obj, w0)
    report["resident_off"] = off
    check("resident_off_is_free",
          all(v["syncs_off"] == v["syncs_plain"] and v["same_bits"]
              and v["recorded_nothing"] for v in off.values()),
          f"{off}")

    report["ok"] = ok
    return report


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.detach().cpu(), b.detach().cpu()))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--selftest" not in argv:
        print(__doc__)
        return 2
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    import json

    report = selftest(device)
    if "--json" in argv:
        print(json.dumps(report))
    else:
        for name, entry in report["checks"].items():
            status = "ok" if entry["ok"] else "FAIL"
            detail = f"  ({entry['detail']})" if entry.get("detail") else ""
            print(f"  {name}: {status}{detail}")
        print("checkpoint selftest:", "ok" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
