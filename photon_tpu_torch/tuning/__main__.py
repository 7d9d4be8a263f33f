"""Tuning selftest CLI (port of `photon_tpu/tuning/__main__.py`): the
lane-batched cost-aware tuner as one smoke.

    python -m photon_tpu_torch.tuning --selftest [--json] [--device cpu]

Runs on the card unless given ``--device cpu``: the GP-propose →
fixed-chunk lane screen → successive-halving re-solve loop on a canned
logistic problem.

- ``lane_tune``    — a 32-config tune at chunk 8 recovers a winner whose
  validation AUC beats 0.8, with one observation per proposed config and
  a monotone incumbent history.
- ``no_retrace``   — the whole multi-round tune dispatches exactly TWO
  lane signatures (screen + survivor re-solve); a second tune with
  another seed adds none.
- ``gp_ladder``    — growing-history GP fits land on the pow2
  observation ladder: fits at every count in [3, 24] record signatures
  only at the rung shapes.
- ``qei_edges``    — q-EI greedy handles q > pool (the whole pool, no
  repeats), and UNIFORM costs pick the same batch as the costless greedy.
- ``cost_budget``  — the round's modeled cost is enforced BEFORE
  dispatch: the default budget admits the round, a starved
  ``max_round_flops`` raises RoundBudgetError, and the single-device
  lane program models zero collective bytes.
- ``telemetry``    — a run sees one ``tuning.rounds`` count per round,
  ``tuning.configs`` == configs proposed, and a positive
  ``tuning.round_model_flops`` gauge.

The reference's ``contracts`` check (its two jaxpr contracts) waits for
the port of `analysis/` (ROADMAP queue A item 11.9).

Exit status: 0 iff every check passed.
"""
from __future__ import annotations

import argparse
import json
import sys


def run_selftest(device: str = "cuda") -> dict:
    import numpy as np

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.tuning import gp as gp_mod
    from photon_tpu_torch.tuning.acquisition import qei_greedy
    from photon_tpu_torch.tuning.lane_tuner import (LaneBudget,
                                                    LaneTuningResult,
                                                    RoundBudgetError,
                                                    tune_glm_reg_lanes)

    dev = resolve_device(device)
    checks: dict = {}
    rng = np.random.default_rng(16)
    n, d = 512, 16
    w_true = rng.normal(size=d)
    Xtr = rng.normal(size=(n, d)).astype(np.float32)
    ytr = (Xtr @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    Xv = rng.normal(size=(n, d)).astype(np.float32)
    yv = (Xv @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    train = make_batch(Xtr, ytr, device=dev)
    val = make_batch(Xv, yv, device=dev)
    task = TaskType.LOGISTIC_REGRESSION
    cfg = OptimizerConfig(max_iters=32, reg=l2(), history=5)

    # --- lane tune + telemetry ---------------------------------------------
    base = LaneTuningResult.signature_count()
    with telemetry.run("tuning_selftest") as run:
        model, best_w, res = tune_glm_reg_lanes(
            train, task, cfg, val, n_configs=32, lane_chunk=8, seed=0)
    hist = res.history()
    # best_y is the winner's FULL-depth negated AUC (screen ys are another
    # fidelity: no order between the two is promised)
    checks["lane_tune"] = {
        "ok": bool(len(res.ys) == 32 and len(res.rounds) == 4
                   and res.best_y < -0.8
                   and (np.diff(hist) <= 1e-12).all()
                   and 1e-4 <= best_w <= 1e4),
        "best_y": float(res.best_y), "best_w": float(best_w),
        "n_obs": len(res.ys)}
    checks["telemetry"] = {
        "ok": bool(run.counters.get("tuning.rounds", 0) == 4
                   and run.counters.get("tuning.configs", 0) == 32
                   and run.counters.get("tuning.survivor_resolves", 0) == 8
                   and run.gauges.get("tuning.round_model_flops", 0) > 0),
        "counters": {k: v for k, v in run.counters.items()
                     if k.startswith("tuning.")}}

    # --- no retrace: two programs in all; a second tune adds none ----------
    try:
        n_sigs = LaneTuningResult.assert_no_retrace(base + 2)
        tune_glm_reg_lanes(train, task, cfg, val, n_configs=16,
                           lane_chunk=8, seed=3)
        LaneTuningResult.assert_no_retrace(n_sigs)
        checks["no_retrace"] = {"ok": True, "signatures": n_sigs - base}
    except AssertionError as e:
        checks["no_retrace"] = {"ok": False, "error": str(e)}

    # --- the GP's pow2 observation ladder ----------------------------------
    sig0 = len(gp_mod._FIT_SIG_LOG.signatures(gp_mod.FIT_SIG_NAME))
    for k in range(3, 25):
        Xo = rng.uniform(size=(k, 1)).astype(np.float32)
        gp_mod.fit_gp(Xo, np.sin(4 * Xo[:, 0]), device=dev)
    new = len(gp_mod._FIT_SIG_LOG.signatures(gp_mod.FIT_SIG_NAME)) - sig0
    # counts 3..24 cover rungs {8, 16, 32} only
    checks["gp_ladder"] = {"ok": bool(new <= 3), "new_signatures": new}

    # --- q-EI edges ---------------------------------------------------------
    gp = gp_mod.fit_gp(rng.uniform(size=(9, 1)).astype(np.float32),
                       rng.normal(size=9), device=dev)
    pool = rng.uniform(size=(5, 1)).astype(np.float32)
    over = qei_greedy(gp, pool, 0.0, q=12, seed=7)
    uni = qei_greedy(gp, pool, 0.0, q=3, seed=7, costs=np.full(5, 123.0))
    plain = qei_greedy(gp, pool, 0.0, q=3, seed=7)
    checks["qei_edges"] = {
        "ok": bool(sorted(over) == [0, 1, 2, 3, 4] and uni == plain),
        "overdraw": over, "uniform_vs_plain": [uni, plain]}

    # --- the cost budget, enforced before dispatch -------------------------
    starved = False
    try:
        tune_glm_reg_lanes(train, task, cfg, val, n_configs=8,
                           lane_chunk=8, seed=1,
                           budget=LaneBudget(max_round_flops=10.0))
    except RoundBudgetError:
        starved = True
    rs = res.rounds[0]
    checks["cost_budget"] = {
        "ok": bool(starved and rs.modeled_collective_bytes == 0
                   and rs.modeled_flops > 0),
        "starved_raises": starved, "round_flops": rs.modeled_flops}

    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.tuning",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    report = run_selftest(args.device)
    if args.json:
        print(json.dumps(report))
    else:
        parts = [f"{k}={'ok' if v['ok'] else 'FAIL'}"
                 for k, v in report["checks"].items()]
        print("tuning selftest: " + " ".join(parts))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
