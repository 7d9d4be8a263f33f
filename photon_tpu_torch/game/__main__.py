"""GAME end-to-end selftest CLI (port of `photon_tpu/game/__main__.py`):
the composed regime as one smoke.

    python -m photon_tpu_torch.game --selftest [--json] [--device cpu]

Runs the composed regime at toy scale on a 2-slot mesh, on the card
unless given ``--device cpu`` (both slots on the one card):

- ``streamed_mesh_parity``   — a 2-coordinate GAME fit (fixed + per-entity
  random effect, 2 sweeps) whose fixed-effect shard lives as a host
  `ChunkedMatrix` and solves on the mesh-streamed path, against the
  resident one-device fit: coefficients within the streamed tolerance,
  and the host-margin-cache exchange emits its ``game_e2e.*`` counters.
- ``blocked_ell_mesh_smoke`` — a sparse fixed shard as a blocked-ELL
  MESH chunk ladder (``chunk_blocked_ell(n_shards=2)``) training under
  the same mesh against the resident fit of its `SparseRows`; on the
  card the blocked-ELL kernels run on the mesh chunks.
- ``beyond_resident_smoke``  — the streamed fit completed with the fixed
  shard's device-resident estimate above a (synthetic) device budget:
  the regime the resident path could not hold.

- ``contracts`` — the four pod-scale GAME contracts (`analysis/`:
  ``game_streamed_fixed_evaluation``, ``game_re_mesh_bucket_solve``,
  ``streamed_mesh_blocked_ell_chunk_partials``,
  ``game_score_stream_chunk``) hold on the same device.

Exit status: 0 iff every check passed.
"""
from __future__ import annotations

import argparse
import json
import sys

# the registered contracts this selftest checks (`analysis/`)
GAME_E2E_CONTRACTS = (
    "game_streamed_fixed_evaluation",
    "game_re_mesh_bucket_solve",
    "streamed_mesh_blocked_ell_chunk_partials",
    "game_score_stream_chunk",
)


def run_selftest(device: str = "cuda") -> dict:
    import numpy as np

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import (chunk_blocked_ell,
                                               chunk_matrix, make_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator,
                                                 RandomEffectConfig)
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    checks: dict = {}
    rng = np.random.default_rng(7)
    n, E, df, dr = 512, 24, 8, 5
    chunk_rows = 128
    ent = rng.integers(0, E, size=n)
    Xf = rng.normal(size=(n, df)).astype(np.float32)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    w_true = rng.normal(size=df).astype(np.float32) * 0.5
    u_true = rng.normal(size=(E, dr)).astype(np.float32)
    margin = Xf @ w_true + np.einsum("nd,nd->n", Xr, u_true[ent])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)

    cfg_f = OptimizerConfig(max_iters=8, tolerance=1e-6, reg=l2(),
                            reg_weight=0.5, history=4)
    cfg_r = OptimizerConfig(max_iters=6, tolerance=1e-6, reg=l2(),
                            reg_weight=1.0, history=4)
    mesh = make_mesh(n_devices=2, device=dev)

    def fit(shard_fx, mesh_=None):
        data = GameData.build(y, {"fx": shard_fx, "rs": Xr}, {"e": ent})
        est = GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION,
            coordinate_configs={"fixed": FixedEffectConfig("fx", cfg_f),
                                "re": RandomEffectConfig("e", "rs", cfg_r)},
            n_sweeps=2, mesh=mesh_, device=None if mesh_ else dev)
        return est.fit(data)[0]

    def coeffs(r):
        return (r.model.coordinates["fixed"].model.coefficients.means
                .cpu().numpy(),
                r.model.coordinates["re"].coefficients.cpu().numpy())

    # --- streamed-mesh parity (dense fixed shard) -------------------------
    ref = fit(Xf)
    with telemetry.run("game_selftest") as run:
        got = fit(chunk_matrix(Xf, chunk_rows), mesh_=mesh)
    wf_r, wr_r = coeffs(ref)
    wf_s, wr_s = coeffs(got)
    parity_ok = (np.allclose(wf_s, wf_r, rtol=5e-3, atol=1e-3)
                 and np.allclose(wr_s, wr_r, rtol=5e-3, atol=1e-3))
    emitted = {k for k in run.counters if k.startswith("game_e2e.")}
    need = {"game_e2e.streamed_fixed_updates", "game_e2e.host_offset_sums",
            "game_e2e.score_stream_chunks", "game_e2e.objective_chunks",
            "game_e2e.chunked_fit_points"}
    checks["streamed_mesh_parity"] = {
        "ok": bool(parity_ok and need <= emitted),
        "max_abs_diff": float(np.max(np.abs(wf_s - wf_r))),
        "counters": sorted(emitted)}

    # --- a blocked-ELL mesh ladder as the fixed shard ---------------------
    k, dS = 4, 40
    sp = SparseRows(rng.integers(0, dS, size=(n, k)).astype(np.int32),
                    rng.normal(size=(n, k)).astype(np.float32), dS)
    cb = chunk_blocked_ell(make_batch(sp, y, device="cpu"), chunk_rows,
                           d_dense=16, n_shards=2)
    ref2 = fit(sp)
    K.reset_launch_counts()
    got2 = fit(cb.X, mesh_=mesh)
    launches = K.launch_counts()
    wf2_r, _ = coeffs(ref2)
    wf2_s, _ = coeffs(got2)
    kernels_ran = (dev.type != "cuda"
                   or (launches.get(KB.TAIL, 0) > 0
                       and launches.get(KB.RMATVEC, 0) > 0))
    checks["blocked_ell_mesh_smoke"] = {
        "ok": bool(np.allclose(wf2_s, wf2_r, rtol=5e-3, atol=1e-3)
                   and kernels_ran),
        "max_abs_diff": float(np.max(np.abs(wf2_s - wf2_r))),
        "launches": launches}

    # --- beyond-resident demonstration ------------------------------------
    # the streamed fit above completed while the fixed shard's resident
    # estimate exceeds a synthetic per-device budget
    est_bytes = int(Xf.nbytes + 12 * n)
    budget = est_bytes // 2
    checks["beyond_resident_smoke"] = {
        "ok": bool(parity_ok and est_bytes > budget),
        "estimate_bytes": est_bytes, "budget_bytes": budget}
    from photon_tpu_torch.analysis.contracts import check_names

    checks["contracts"] = check_names(GAME_E2E_CONTRACTS, str(dev))
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.game",
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
        print("game selftest: " + " ".join(parts))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
