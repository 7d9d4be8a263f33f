"""Continual-flywheel selftest CLI (port of
`photon_tpu/continual/__main__.py`): the whole train → serve loop as one
smoke.

    python -m photon_tpu_torch.continual --selftest [--json] [--device cpu]

Runs delta detection → the prior warm-started partial refresh → the
parity-probed atomic hot swap on a canned mixed-effect mix, on the card
unless given ``--device cpu``:

- ``delta_plan``         — a drop touching ~10% of the entities plans
  exactly those entities (plus the new entity's deferral) from the saved
  manifest.
- ``refresh_parity``     — untouched entities stay bit for bit; touched
  entities move on the new evidence and re-converge, with refreshed
  variances for the next turn of the flywheel.
- ``refresh_no_retrace`` — a second refresh with a DIFFERENT touched set
  adds no compacted-solve signature.
- ``swap``               — the refreshed store passes the parity probe,
  publishes a new version and its pointer, and hot-swaps the live store
  behind an int8 `ProgramLadder` (the int8 rung kernel on the card),
  which then scores the refreshed model within the ladder's epsilon; a
  kill injected at the ``swap_publish`` site leaves the old version
  serving bit for bit, and a blown-up store is refused.

- ``contracts`` — the two continual contracts (`analysis/`:
  ``continual_re_refresh_solve``, ``continual_refresh_no_retrace``) hold
  on the same device.

Exit status: 0 iff every check passed.
"""
from __future__ import annotations

import argparse
import json
import sys

# the registered contracts this selftest checks (`analysis/`)
CONTINUAL_CONTRACTS = ("continual_re_refresh_solve",
                       "continual_refresh_no_retrace")


def run_selftest(device: str = "cuda") -> dict:
    import dataclasses
    import tempfile

    import numpy as np

    from photon_tpu_torch import continual, telemetry
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.checkpoint.faults import (FaultPlan, InjectedFault,
                                                    fault_plan)
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator,
                                                 RandomEffectConfig)
    from photon_tpu_torch.kernels import serving as K_SERVING
    from photon_tpu_torch.models.variance import VarianceComputationType
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.serving import (CoefficientStore,
                                          MicroBatchDispatcher,
                                          ProgramLadder)
    from photon_tpu_torch.serving.dispatcher import ScoreRequest

    dev = resolve_device(device)
    checks: dict = {}
    rng = np.random.default_rng(11)
    n, E, df, dr = 768, 32, 6, 4
    ent = rng.integers(0, E, size=n)
    Xf = rng.normal(size=(n, df)).astype(np.float32)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    w_true = rng.normal(size=df).astype(np.float32) * 0.5
    u_true = rng.normal(size=(E, dr)).astype(np.float32) * 0.5

    def labels(Xf_, Xr_, ent_):
        m = Xf_ @ w_true + np.einsum("nd,nd->n", Xr_, u_true[ent_])
        return (rng.uniform(size=m.shape[0])
                < 1 / (1 + np.exp(-m))).astype(np.float32)

    cfg_f = OptimizerConfig(max_iters=8, tolerance=1e-6, reg=l2(),
                            reg_weight=0.5, history=4)
    cfg_r = OptimizerConfig(max_iters=20, tolerance=1e-7, reg=l2(),
                            reg_weight=0.5, history=4)
    data = GameData.build(labels(Xf, Xr, ent), {"fx": Xf, "rs": Xr},
                          {"e": ent})
    est = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={"fixed": FixedEffectConfig("fx", cfg_f),
                            "re": RandomEffectConfig("e", "rs", cfg_r)},
        n_sweeps=2, variance=VarianceComputationType.SIMPLE, device=dev)
    prev = est.fit(data)[0].model
    manifest = continual.build_manifest(data)

    run = telemetry.start_run("continual_selftest")
    try:
        # --- delta plan ---------------------------------------------------
        touched = rng.choice(E, size=max(E // 8, 2), replace=False)
        n2 = 160
        ent2 = np.concatenate([rng.permutation(np.repeat(
            touched, n2 // touched.size))[:n2 - 8],
            np.full(8, E + 7)])  # 8 rows of a brand-new entity
        Xf2 = rng.normal(size=(n2, df)).astype(np.float32)
        Xr2 = rng.normal(size=(n2, dr)).astype(np.float32)
        u_shift = u_true.copy()
        u_shift[touched] += 1.0  # the touched entities really moved
        m2 = Xf2 @ w_true + np.einsum(
            "nd,nd->n", Xr2, np.vstack([u_shift, np.zeros(
                (8, dr), np.float32)])[ent2])
        y2 = (rng.uniform(size=n2) < 1 / (1 + np.exp(-m2))).astype(
            np.float32)
        drop = GameData.build(y2, {"fx": Xf2, "rs": Xr2}, {"e": ent2})
        plan = continual.diff_manifest(manifest, drop, prev)
        cp = plan.coordinates["re"]
        want = {str(k) for k in touched.tolist()}
        got = set(np.asarray(cp.touched_keys).astype(np.str_).tolist())
        checks["delta_plan"] = {
            "ok": got == want and int(cp.new_keys.shape[0]) == 1,
            "touched": sorted(got), "n_new": int(cp.new_keys.shape[0])}

        # --- refresh parity -----------------------------------------------
        res = continual.refresh_game_model(prev, drop, plan, {"re": cfg_r})
        new_re = res.model.coordinates["re"]
        prev_c = prev.coordinates["re"].coefficients.cpu().numpy()
        new_c = new_re.coefficients.cpu().numpy()
        untouched = np.setdiff1d(np.arange(E), touched)
        st = res.stats["re"]
        checks["refresh_parity"] = {
            "ok": bool((prev_c[untouched] == new_c[untouched]).all()
                       and (prev_c[touched] != new_c[touched]).any()
                       and st.n_converged > 0 and st.n_failed == 0
                       and new_re.variances is not None),
            "touched_iters": int(st.total_iterations),
            "buckets": [st.buckets_touched, st.buckets_skipped]}

        # --- no new signature across a second, different touched set ------
        baseline = len(continual.RefreshResult.signatures())
        touched_b = rng.choice(E, size=max(E // 16, 1), replace=False)
        n3 = 96
        ent3 = rng.permutation(np.repeat(touched_b,
                                         n3 // touched_b.size + 1))[:n3]
        drop_b = GameData.build(
            labels(rng.normal(size=(n3, df)).astype(np.float32),
                   rng.normal(size=(n3, dr)).astype(np.float32), ent3),
            {"fx": rng.normal(size=(n3, df)).astype(np.float32),
             "rs": rng.normal(size=(n3, dr)).astype(np.float32)},
            {"e": ent3})
        plan_b = continual.diff_manifest(manifest, drop_b, prev)
        continual.refresh_game_model(prev, drop_b, plan_b, {"re": cfg_r})
        try:
            n_sigs = continual.RefreshResult.assert_no_retrace(baseline)
            checks["refresh_no_retrace"] = {"ok": True,
                                            "signatures": n_sigs}
        except AssertionError as e:
            checks["refresh_no_retrace"] = {"ok": False, "error": str(e)}

        # --- parity-probed atomic swap into a live int8 ladder ------------
        keys = prev.coordinates["re"].entity_keys
        reqs = [ScoreRequest(features={"fx": Xf2[i], "rs": Xr2[i]},
                             entities={"e": keys[int(ent2[i]) % E]})
                for i in range(64)]
        with tempfile.TemporaryDirectory(prefix="photon_continual_") as root:
            live = CoefficientStore.from_game_model(prev, device=dev)
            new_store = CoefficientStore.from_game_model(res.model,
                                                         device=dev)
            ladder = ProgramLadder(live, ladder=(8, 16), output_mean=False,
                                   quantize="int8", quant_epsilon=0.5)
            ladder.warmup()
            out = continual.hot_swap(live, new_store, root=root,
                                     probe=continual.ParityProbe(bound=100.0))
            # store blocks are (E+1, d) host arrays: the last row is the
            # cold-miss row
            swapped = np.asarray(live.random["re"].coefficients)[:-1]
            K.reset_launch_counts()
            disp = MicroBatchDispatcher(ladder, max_batch=16,
                                        max_delay_us=2000)
            try:
                scored = np.asarray([f.result(timeout=60) for f in
                                     [disp.submit(q) for q in reqs]],
                                    np.float64)
            finally:
                disp.close()
            launches = K.launch_counts().get(K_SERVING.KERNEL, 0)
            f32 = ProgramLadder(new_store, ladder=(8, 16), output_mean=False)
            disp32 = MicroBatchDispatcher(f32, max_batch=16,
                                          max_delay_us=2000)
            try:
                want32 = np.asarray([f.result(timeout=60) for f in
                                     [disp32.submit(q) for q in reqs]],
                                    np.float64)
            finally:
                disp32.close()
            int8_gap = float(np.abs(scored - want32).max())
            v0 = out["version"]
            # a kill at the publish point leaves v0 serving bit for bit
            killed = False
            try:
                with fault_plan(FaultPlan.kill_at("swap_publish", 1)):
                    continual.hot_swap(None, CoefficientStore.from_game_model(
                        prev, device=dev), root=root, probe=None)
            except InjectedFault:
                killed = True
            after, v_after = continual.open_current(root, device=dev)
            still_new = bool(np.array_equal(
                np.asarray(after.random["re"].coefficients),
                np.asarray(new_store.random["re"].coefficients)))
            refusals0 = run.counters.get("continual.swap_refusals", 0)
            broken = CoefficientStore.from_game_model(res.model, device=dev)
            broken.random["re"] = dataclasses.replace(
                broken.random["re"],
                coefficients=broken.random["re"].coefficients + 1e6)
            refused = False
            try:
                continual.hot_swap(live, broken, root=root,
                                   probe=continual.ParityProbe(bound=1.0))
            except continual.SwapRefused:
                refused = True
            checks["swap"] = {
                "ok": bool((swapped == new_c).all() and killed and still_new
                           and v_after == v0 and refused
                           and run.counters.get("continual.swap_refusals",
                                                0) == refusals0 + 1
                           and run.counters.get("serving.hot_swaps", 0) >= 1
                           and int8_gap <= ladder.quant_epsilon
                           and (dev.type != "cuda" or launches > 0)),
                "version": v0, "killed_mid_swap": killed,
                "published_model_served_after_kill": still_new,
                "refused": refused, "int8_max_gap": int8_gap,
                "int8_launches": launches}
    finally:
        telemetry.finish_run()
    from photon_tpu_torch.analysis.contracts import check_names

    checks["contracts"] = check_names(CONTINUAL_CONTRACTS, str(dev))
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.continual",
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
        print("continual selftest: " + " ".join(parts))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
