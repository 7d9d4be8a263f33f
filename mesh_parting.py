"""Where a tolerance-0 L-BFGS on an 8-slot mesh parts from the same solve
on one device, on the CPU, in one package per process.

    python mesh_parting.py [--package port|reference] [--rows 65536]
        [--iters 40] [--seed 0] [--mesh-tail f32]

T2's recipe (`bench.py:110-116`, `chip_smoke.py::sparse_planted`):
10,000,000 features, 32 zipf(1.4) nonzeros and an intercept a row, a
1,024-column hot block, logistic loss, L2 1e-3, history 5, tolerance 0;
only the row count is cut. Every value leaf is bf16 on both sides
(`cast_features`), as in T2 (a). ``--mesh-tail f32`` keeps the mesh
form's ELL tail and occurrence buckets in f32 (only its hot block bf16):
a different problem from the one-device solve's, for comparison.

Prints one JSON line: the iteration where the two loss histories first
part by more than 1e-5 (null if never), their relative gap at the first
5 iterations and at the last, the final losses, and the coefficients'
largest absolute difference. ``--package reference`` runs the JAX
package's one device against its 8-device CPU mesh; ``port`` the
PyTorch package's one device against its 8-slot CPU mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

FEATURES, NNZ, ZIPF, DENSE = 10_000_000, 32, 1.4, 1024
REG, HISTORY, SLOTS = 1e-3, 5, 8


def problem(seed: int, rows: int):
    """(ind, va, y): chip_smoke.py's `sparse_planted` recipe."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(ZIPF, size=(rows, NNZ)).astype(np.int64) - 1) \
        % (FEATURES - 1)
    val = rng.normal(size=(rows, NNZ)).astype(np.float32)
    ind = np.concatenate([col, np.full((rows, 1), FEATURES - 1)],
                         axis=1).astype(np.int32)
    va = np.concatenate([val, np.ones((rows, 1), np.float32)], axis=1)
    w_true = np.zeros(FEATURES, np.float32)
    hot = 200_000
    w_true[:hot] = rng.normal(size=hot) / np.sqrt(np.arange(1, hot + 1))
    w_true[FEATURES - 1] = -0.2
    margin = np.einsum("nk,nk->n", va, w_true[ind])
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)
    return ind, va, y


def port(ind, va, y, iters: int, mesh_tail_f32: bool):
    """(history, w) on one device and on the 8-slot mesh, the port."""
    import torch

    from photon_tpu_torch.data.dataset import (cast_features, make_batch,
                                               mesh_batch,
                                               shard_blocked_ell_batch)
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.parallel.mesh import make_mesh

    cfg = OptimizerConfig(max_iters=iters, tolerance=0.0, reg=l2(),
                          reg_weight=REG, history=HISTORY)
    task = TaskType.LOGISTIC_REGRESSION
    X = to_blocked_ell(SparseRows(ind, va, FEATURES), DENSE, device="cpu")
    one = cast_features(make_batch(X, y, device="cpu"))
    m1, r1 = train_glm(one, task, cfg, device="cpu")
    del one, X
    mesh = make_mesh(n_devices=SLOTS, device="cpu")
    host = make_batch(SparseRows(ind, va, FEATURES), y, device="cpu")
    if mesh_tail_f32:
        sb = shard_blocked_ell_batch(host, SLOTS, DENSE,
                                     device_dense_dtype=torch.bfloat16)
    else:
        sb = cast_features(shard_blocked_ell_batch(host, SLOTS, DENSE))
    mm, rm = train_glm(mesh_batch(sb, mesh), task, cfg, mesh=mesh)
    return ((r1.history(), m1.coefficients.means.numpy()),
            (rm.history(), mm.coefficients.means.numpy()))


def reference(ind, va, y, iters: int, mesh_tail_f32: bool):
    """(history, w) on one device and on the 8-device CPU mesh, the JAX
    package."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    import jax.core
    import jax.extend.core

    # jax 0.9 moved `jax.core.ClosedJaxpr`/`Jaxpr` (which the package
    # imports) to `jax.extend.core`
    for name in dir(jax.extend.core):
        if not name.startswith("_") and not hasattr(jax.core, name):
            setattr(jax.core, name, getattr(jax.extend.core, name))
    import dataclasses

    import jax
    import jax.numpy as jnp

    from photon_tpu.data.dataset import (cast_features, make_batch,
                                         shard_blocked_ell_batch)
    from photon_tpu.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu.models.training import train_glm
    from photon_tpu.ops.losses import TaskType
    from photon_tpu.optim.config import OptimizerConfig
    from photon_tpu.optim.regularization import l2
    from photon_tpu.parallel.mesh import make_mesh

    cfg = OptimizerConfig(max_iters=iters, tolerance=0.0, reg=l2(),
                          reg_weight=REG, history=HISTORY)
    task = TaskType.LOGISTIC_REGRESSION
    cpu = jax.devices("cpu")

    def hist(res):
        return np.asarray(res.loss_history)[:int(res.iterations) + 1]

    with jax.default_device(cpu[0]):
        X = to_blocked_ell(SparseRows(ind, va, FEATURES), DENSE)
        m1, r1 = train_glm(cast_features(make_batch(X, y)), task, cfg)
        del X
    mesh = make_mesh(devices=cpu[:SLOTS])
    sb = shard_blocked_ell_batch(make_batch(SparseRows(ind, va, FEATURES),
                                            y), SLOTS, d_dense=DENSE)
    if mesh_tail_f32:
        sb = sb._replace(X=dataclasses.replace(
            sb.X, dense=sb.X.dense.astype(jnp.bfloat16)))
    else:
        sb = cast_features(sb)
    mm, rm = train_glm(sb, task, cfg, mesh=mesh)
    return ((hist(r1), np.asarray(m1.coefficients.means)),
            (hist(rm), np.asarray(mm.coefficients.means)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "reference"),
                    default="port")
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-tail", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    ind, va, y = problem(args.seed, args.rows)
    run = port if args.package == "port" else reference
    (h1, w1), (hm, wm) = run(ind, va, y, args.iters,
                             args.mesh_tail == "f32")
    n = min(len(h1), len(hm))
    rel = np.abs(hm[:n] - h1[:n]) / np.abs(h1[:n])
    over = np.flatnonzero(rel > 1e-5)
    print(json.dumps({
        "package": args.package, "rows": args.rows, "seed": args.seed,
        "mesh_tail": args.mesh_tail,
        "iterations": [len(h1) - 1, len(hm) - 1],
        "first_apart_1e-5": int(over[0]) if over.size else None,
        "rel_gap_first_5": float(rel[:6].max()),
        "rel_gap_by_iteration": [float(f"{r:.3g}") for r in rel],
        "rel_gap_last": float(rel[-1]),
        "loss_last": [float(h1[-1]), float(hm[-1])],
        "max_abs_dw": float(np.abs(wm - w1).max()),
        "seconds": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
