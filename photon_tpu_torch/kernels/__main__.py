"""Kernels selftest CLI (port of `photon_tpu/kernels/__main__.py`): the
blocked-ELL kernels and their seam as one smoke.

    python -m photon_tpu_torch.kernels --selftest [--json] [--device cpu]

Runs on the card unless given ``--device cpu``, on a small blocked-ELL
layout whose width and occurrence buckets span sub-tile and many-tile
sizes, in f32 and bf16 storage:

- ``parity``   — on the card, every X pass (`data.matrix.matvec`,
  `rmatvec`, `sq_rmatvec`, at 1 and 8 lanes) through the kernels against
  its plain version (``scope("off")``) within rtol = atol = 1e-5, and the
  tail matvec's and the rmatvec's fused and tiled forms equal bit for
  bit; on the CPU, the plain versions against a dense f64 product of the
  same layout.
- ``streamed`` — a streamed solve of the layout's rows as a chunk ladder:
  on the card with the kernels on against the same solve with them off
  (the kernels launched, the loss histories within 1e-5); on the CPU
  against the resident solve of the same rows (histories within 1e-5).
- ``dispatch`` — `kernels.route` walks fused → tiled under
  ``PHOTON_TPU_TORCH_KERNELS_BUDGET`` (none, the vector's bytes, one byte
  less, 0); ``on`` with a CPU tensor raises; on the card a CUDA tensor
  launches a kernel under every budget, never the plain version.
- ``ring``     — `DeviceChunkRing` yields the chunks in order over two
  passes and its chunks take one kernel plan per ring slot
  (`kernels.blocked_ell.plan_builds`).

- ``contracts`` — the registered kernel contracts (`analysis/`:
  ``blocked_ell_kernel_x_passes``, ``blocked_ell_kernel_no_retrace``,
  ``blocked_ell_tiled_x_passes``, ``serving_kernel_fused_rung``,
  ``serving_kernel_mode_invariance``, ``mesh_stream_donated_no_retrace``,
  ``serving_quantized_rung_invariance``) hold on the same device.

Exit status: 0 iff every check passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

TOL = dict(rtol=1e-5, atol=1e-5)

# the registered contracts this selftest checks (`analysis/`)
KERNEL_CONTRACTS = ("blocked_ell_kernel_x_passes",
                    "blocked_ell_kernel_no_retrace",
                    "blocked_ell_tiled_x_passes",
                    "serving_kernel_fused_rung",
                    "serving_kernel_mode_invariance",
                    "mesh_stream_donated_no_retrace",
                    "serving_quantized_rung_invariance")


def _sparse(n: int = 2048, d: int = 3000, k: int = 12, seed: int = 0):
    """Zipf-skewed padded COO rows (an intercept column last) and labels;
    a column repeated within a row keeps one value and zeros in its other
    slots, so any storage dtype rounds each entry once."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ind = np.concatenate([(rng.zipf(1.4, (n, k)) - 1) % (d - 1),
                          np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, k)),
                          np.ones((n, 1))], 1).astype(np.float32)
    order = np.argsort(ind, axis=1, kind="stable")
    s = np.take_along_axis(ind, order, 1)
    dup = np.zeros(s.shape, bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    repeated = np.zeros(s.shape, bool)
    np.put_along_axis(repeated, order, dup, 1)
    val[repeated] = 0.0
    ind[:64, :-1], val[:64, :-1] = 0, 0.0  # rows with no tail
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return ind, val, d, y


def _dense_f64(ind, val, d):
    import numpy as np

    A = np.zeros((ind.shape[0], d), np.float64)
    np.add.at(A, (np.repeat(np.arange(ind.shape[0]), ind.shape[1]),
                  ind.reshape(-1)), val.reshape(-1).astype(np.float64))
    return A


def _max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def check_parity(dev) -> dict:
    import numpy as np
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.kernels import blocked_ell as KB

    ind, val, d, _ = _sparse()
    rng = np.random.default_rng(1)
    worst, bitwise, n = 0.0, True, ind.shape[0]
    for dtype in (torch.float32, torch.bfloat16):
        X = M.to_blocked_ell(M.SparseRows(ind, val, d), 64,
                             device=dev).astype(dtype)
        for lanes in (None, 8):
            shape = () if lanes is None else (lanes,)
            w = torch.from_numpy(rng.normal(size=(d,) + shape).astype(
                np.float32)).to(dev)
            r = torch.from_numpy(rng.normal(size=(n,) + shape).astype(
                np.float32)).to(dev)
            wp = X.from_model_space(w)
            passes = (lambda: M.matvec(X, wp), lambda: M.rmatvec(X, r),
                      lambda: M.sq_rmatvec(X, r) if lanes is None
                      else M.rmatvec(X, r))
            if dev.type == "cuda":
                for fn in passes:
                    with K.scope("on"):
                        got = fn()
                    with K.scope("off"):
                        want = fn()
                    np.testing.assert_allclose(got.cpu().numpy(),
                                               want.cpu().numpy(), **TOL)
                    worst = max(worst, _max_err(got, want))
                with K.scope("on"):
                    bitwise &= bool(torch.equal(KB.tail_matvec(X, wp),
                                                KB.tail_matvec_tiled(X, wp)))
                    for sq in (False, True):
                        bitwise &= bool(torch.equal(
                            KB.bucket_rmatvec(X, r, square=sq),
                            KB.bucket_rmatvec_tiled(X, r, square=sq)))
                continue
            # the CPU: the plain versions against f64 on the storage's
            # values (bf16 rounds the values and the gathered operand)
            vq = torch.from_numpy(val).to(dtype).double().numpy()
            A = _dense_f64(ind, vq, d)
            wq, rq = wp.to(dtype).double(), r.to(dtype).double()
            want_mv = A @ X.to_model_space(wq).numpy()
            got_rm = X.to_model_space(M.rmatvec(X, r))
            want_rm = A.T @ rq.numpy()
            for got, want in ((passes[0](), want_mv), (got_rm, want_rm)):
                scale = 1.0 + float(np.abs(want).max())
                np.testing.assert_allclose(got.double().numpy(), want,
                                           rtol=1e-5, atol=1e-5 * scale)
                worst = max(worst, float(np.abs(
                    got.double().numpy() - want).max()) / scale)
            if lanes is None and dtype == torch.float32:
                # (bf16 storage squares the hot block in bf16)
                got_sq = X.to_model_space(M.sq_rmatvec(X, r)).double()
                want_sq = (A * A).T @ r.double().numpy()
                scale = 1.0 + float(np.abs(want_sq).max())
                np.testing.assert_allclose(got_sq.numpy(), want_sq,
                                           rtol=1e-5, atol=1e-5 * scale)
    return {"ok": bool(bitwise), "max_err": worst,
            "fused_tiled_bitwise": bitwise if dev.type == "cuda" else None}


def check_streamed(dev) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import chunk_blocked_ell, make_batch
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    ind, val, d, y = _sparse(seed=2)
    sp = SparseRows(ind, val, d)
    cb = chunk_blocked_ell(make_batch(sp, y, device="cpu"), 512, 64,
                           feature_dtype=torch.bfloat16)
    cfg = OptimizerConfig(max_iters=5, tolerance=0.0, reg=l2(),
                          reg_weight=1e-2, history=4)
    task = TaskType.LOGISTIC_REGRESSION
    K.reset_launch_counts()
    _, res = train_glm(cb, task, cfg, device=dev)
    launches = K.launch_counts()
    if dev.type == "cuda":
        _, ref = train_glm(cb, task, dataclasses.replace(cfg, kernels="off"),
                           device=dev)
        launched = (launches.get(KB.TAIL, 0) > 0
                    and launches.get(KB.RMATVEC, 0) > 0)
    else:
        X = to_blocked_ell(sp, 64, device=dev).astype(torch.bfloat16)
        _, ref = train_glm(make_batch(X, y, device=dev), task, cfg,
                           device=dev)
        launched = not launches
    h, hr = res.history(), ref.history()
    gap = float(np.max(np.abs(h - hr) / np.abs(hr)))
    return {"ok": bool(len(h) == len(hr) and gap <= 1e-5 and launched),
            "max_rel_gap": gap, "launches": launches,
            "against": "kernels off" if dev.type == "cuda" else "resident"}


def check_dispatch(dev) -> dict:
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M

    ind, val, d, _ = _sparse(n=512, d=800, seed=3)
    X = M.to_blocked_ell(M.SparseRows(ind, val, d), 32, device=dev)
    w = torch.zeros(d, device=dev)
    resident = int(X.n_prefix - X.d_sel) * w.element_size()
    routes, launched = {}, {}
    old = os.environ.pop(K.ENV_BUDGET, None)
    try:
        for label, budget in (("none", None), ("fits", resident),
                              ("one_byte_less", resident - 1), ("zero", 0)):
            if budget is not None:
                os.environ[K.ENV_BUDGET] = str(budget)
            routes[label] = K.route(X, w)
            if dev.type == "cuda":
                K.reset_launch_counts()
                with K.scope("auto"):
                    M.matvec(X, w)
                launched[label] = sum(K.launch_counts().values())
            os.environ.pop(K.ENV_BUDGET, None)
    finally:
        os.environ.pop(K.ENV_BUDGET, None)
        if old is not None:
            os.environ[K.ENV_BUDGET] = old
    walk = routes == {"none": "fused", "fits": "fused",
                      "one_byte_less": "tiled", "zero": "tiled"}
    raised = False
    with K.scope("on"):
        try:
            K.use_kernel(torch.zeros(1))
        except RuntimeError:
            raised = True
    with K.scope("auto"):
        cpu_plain = not K.use_kernel(torch.zeros(1))
        cuda_kernel = (K.use_kernel(w) and all(v > 0 for v in
                                               launched.values())
                       if dev.type == "cuda" else None)
    ok = walk and raised and cpu_plain and cuda_kernel is not False
    return {"ok": bool(ok), "routes": routes, "on_cpu_raises": raised,
            "cuda_launches": launched or None}


def check_ring(dev) -> dict:
    import torch

    from photon_tpu_torch.data.dataset import chunk_blocked_ell, make_batch
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.kernels import blocked_ell as KB

    ind, val, d, y = _sparse(n=1024, d=900, seed=4)
    cb = chunk_blocked_ell(make_batch(SparseRows(ind, val, d), y,
                                      device="cpu"), 256, 32,
                           feature_dtype=torch.bfloat16)
    ring = cb.device_ring(device=dev, prefetch=2)
    before = KB.plan_builds()
    order = []
    for _ in range(2):
        for i, b in ring.stream_pass():
            order.append(i)
            KB.layout_plan(b.X)  # what a kernel call on the chunk builds
    builds = KB.plan_builds() - before
    want = list(range(cb.n_chunks)) * 2
    return {"ok": order == want and builds == ring.depth,
            "order": order, "plan_builds": builds, "ring_slots": ring.depth}


def run_selftest(device: str = "cuda") -> dict:
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    checks: dict = {}
    for name, fn in (("parity", check_parity), ("streamed", check_streamed),
                     ("dispatch", check_dispatch), ("ring", check_ring)):
        try:
            checks[name] = fn(dev)
        except AssertionError as e:
            checks[name] = {"ok": False, "error": str(e)[:400]}
    from photon_tpu_torch.analysis.contracts import check_names

    checks["contracts"] = check_names(KERNEL_CONTRACTS, str(dev))
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.kernels",
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
        print("kernels selftest: " + " ".join(parts))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
