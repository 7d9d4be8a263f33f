"""Picklable launch targets for the multi-process mesh spine's proofs (port
of `photon_tpu/parallel/selfcheck.py`).

Every ``target_*`` takes a :class:`parallel.launch.LaunchContext` and runs
INSIDE a spawned cluster member, after `initialize_distributed` has formed
its process group (so `make_mesh` is the global mesh of
``ctx.total_devices`` slots and this rank owns its contiguous share). They
are module-level by construction: spawn children import this module
afresh. The same work also runs in one process over an in-process mesh
(`psum_signature`, `stream_solve`, `solve_chunked`), the P = 1 side of
every comparison.

- :func:`target_psum_signature` — `shard_rows` + one slot-ordered
  reduction: a digest that must be the same at every process count.
- :func:`target_stream_solve` — the spine probe above, then scan →
  ``stream_to_device(local_only=True)`` (each process decodes only the
  container blocks that overlap its slots) → resident mesh GLM solve,
  then GAME on the mesh (`game_fit`); the probe's digest, the f64
  coefficients, the ingest split's counters and the GAME digest (one
  launch for the three proofs).
- :func:`target_snapshot_kill` / :func:`target_resume_solve` — a
  mesh-streamed solve killed mid-run commits per-slot (``@s<slot>``) row
  caches under each process's ``p<k>_`` payloads; the resume restores
  the same global mesh from any process count's snapshot.
- :func:`target_commit_kill` — one rank dies between its durable payload
  and the commit barrier; the survivors' commit must fail LOUDLY within
  ``PHOTON_TPU_BARRIER_TIMEOUT_S`` and the previous manifest stays the
  restore point.
- :func:`target_saved_solve` — a resident mesh solve of a sharded
  blocked-ELL batch a parent saved (`save_sharded_batch`): each process
  maps only its own slots' shards from disk (`load_sharded_batch`).
- :func:`target_game_data` — GAME on the mesh (`fit_game`) of a
  parent's `GameData` (`game_problem`'s seeded one in the tests): a
  fixed effect (dense, or the mesh's blocked-ELL form)
  and random effects whose entity lanes split over the slots; the digest
  of every coordinate's table, optionally under a checkpoint session
  killed at a ``bucket_retire`` (a rerun over the same directory, at any
  process count, resumes it).
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = [
    "target_psum_signature", "target_stream_solve", "target_snapshot_kill",
    "target_resume_solve", "target_commit_kill", "psum_signature",
    "stream_solve", "chunked_problem", "solve_chunked", "write_e2e_dataset",
    "save_sharded_batch", "load_sharded_batch", "target_saved_solve",
    "game_problem", "game_configs", "fit_game", "game_fit",
    "target_game_data",
]

_TOL0_CFG = dict(max_iters=10, tolerance=0.0, reg_weight=1e-2, history=4)


def _mesh(ctx):
    from photon_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices=ctx.total_devices)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def psum_signature(mesh) -> str:
    """The spine probe: a seeded host vector row-sharded over the mesh,
    each slot's Σx², closed by one reduction; its digest."""
    import torch

    from photon_tpu_torch.parallel.mesh import shard_rows

    n = 64 * mesh.n_slots
    host = (np.arange(n, dtype=np.float64) % 97 / 7.0).astype(np.float32)
    arr = shard_rows(host, mesh)
    (total,) = mesh.psum([(torch.sum(p * p),) for p in arr.parts])
    return _digest(np.float32(total.item()))


def chunked_problem(chunk_rows: int = 24):
    """A deterministic chunked logistic problem (192 rows × 6 features,
    seeded): every process rebuilds the same host chunks, so the
    mesh-streamed solve is the same program at any process count."""
    from photon_tpu_torch.data.dataset import chunk_batch, make_batch

    rng = np.random.default_rng(17)
    n, d = 192, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))
         ).astype(np.float32)
    return chunk_batch(make_batch(X, y, device="cpu"), chunk_rows)


def solve_chunked(mesh) -> np.ndarray:
    """The tolerance-0 mesh-streamed L-BFGS every elastic target shares
    (the whole iteration budget runs, so a kill always cuts a running
    solve); the coefficients in f64."""
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    cfg = OptimizerConfig(reg=l2(), **_TOL0_CFG)
    _, res = train_glm(chunked_problem(), TaskType.LOGISTIC_REGRESSION, cfg,
                       mesh=mesh)
    return res.w.cpu().numpy().astype(np.float64)


def write_e2e_dataset(root, n_files: int = 3, rows_per_file: int = 400):
    """Write the deterministic multi-file Avro dataset the stream-solve
    target reads (a parent-side helper: targets only read it)."""
    import pathlib

    from photon_tpu_torch.data.avro_io import write_avro
    from photon_tpu_torch.data.ingest import training_example_schema

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(23)
    schema = training_example_schema(feature_bags=("f",),
                                     entity_fields=("member",))
    for fi in range(int(n_files)):
        records = []
        for i in range(int(rows_per_file)):
            records.append({
                "response": float(rng.integers(0, 2)),
                "offset": float(rng.normal()) if i % 3 == 0 else None,
                "weight": 2.0 if i % 5 == 0 else None,
                "uid": f"r{fi}_{i}",
                "member": f"m{int(rng.integers(0, 37))}",
                "f": [{"name": "age", "term": "",
                       "value": float(rng.normal())},
                      {"name": "ctr", "term": "",
                       "value": float(rng.normal())}],
            })
        write_avro(root / f"part-{fi:03d}.avro", records, schema,
                   block_records=130)
    return root


def _e2e_config():
    from photon_tpu_torch.data.feature_bags import FeatureShardConfig
    from photon_tpu_torch.data.ingest import GameDataConfig

    return GameDataConfig(
        shards={"dense": FeatureShardConfig(bags=("f",),
                                            has_intercept=True)},
        entity_fields=("member",))


def stream_solve(root, mesh) -> dict:
    """One scan, the ``local_only`` ingest of this process's rows, and
    the resident mesh L-BFGS on them (30 iterations): the coefficients
    (f64), the row count and the ingest split's counters."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.data.streaming import scan_ingest, stream_to_device
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    config = _e2e_config()
    scan = scan_ingest(str(root), config)
    telemetry.reset()
    data, n_real = stream_to_device(
        str(root), config, scan.index_maps, mesh=mesh, chunk_rows=300,
        block_index=scan.block_index, local_only=True)
    counters = dict(telemetry.snapshot()["counters"])
    batch = make_batch(data.shards["dense"], data.y, weights=data.weights,
                       offsets=data.offsets)
    model, res = train_glm(
        batch, TaskType.LOGISTIC_REGRESSION,
        OptimizerConfig(max_iters=30, reg=l2(), reg_weight=1.0), mesh=mesh)
    w = model.coefficients.means.cpu().numpy().astype(np.float64)
    return {"w": w, "digest": _digest(w), "n_real": int(n_real),
            "chunks_decoded": int(counters.get("ingest.chunks", 0)),
            "chunks_skipped": int(counters.get("ingest.chunks_skipped", 0)),
            "iterations": int(res.iterations)}


# ------------------------------------------------------------------ targets
def target_psum_signature(ctx) -> dict:
    from photon_tpu_torch import telemetry

    mesh = _mesh(ctx)
    telemetry.reset()
    digest = psum_signature(mesh)
    c = telemetry.snapshot()["counters"]
    return {"rank": ctx.process_id, "digest": digest,
            "n_devices": mesh.n_slots, "backend": mesh.backend,
            "collectives": int(c.get("mesh.collectives", 0)),
            "wire_bytes": int(c.get("mesh.wire_bytes", 0))}


def target_stream_solve(ctx) -> dict:
    """args=(dataset_root[, telemetry_dir]): `target_psum_signature` (its
    digest as ``psum_digest``, its collectives and wire bytes), then
    `stream_solve` on this rank, then `game_fit` (its digest as
    ``game_digest``), then a timed cluster barrier. With a
    ``telemetry_dir``, everything after the spine runs under a telemetry
    run writing ``p<rank>.jsonl`` there (`telemetry.aggregate` merges
    the ranks' files)."""
    import os

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.parallel.mesh import cluster_barrier

    root, *rest = ctx.args
    spine = target_psum_signature(ctx)
    if rest:
        telemetry.start_run(
            name=f"multihost_rank{ctx.process_id}",
            jsonl_path=os.path.join(str(rest[0]),
                                    f"p{ctx.process_id}.jsonl"))
    try:
        out = stream_solve(root, _mesh(ctx))
        out["game_digest"] = game_fit(_mesh(ctx))["digest"]
        # the straggler waits least here: the aggregation's skew signal
        out["barrier_wait_s"] = cluster_barrier("stream_solve_done")
    finally:
        if rest:
            telemetry.finish_run()
    out.update(psum_digest=spine.pop("digest"), **spine)
    return out


def target_snapshot_kill(ctx) -> dict:
    """args=(ckpt_dir, site, occurrence): the shared mesh-streamed solve
    under a checkpoint session, killed at (site, occurrence) on EVERY rank
    (the host loops are lock-step, so the cut is the same)."""
    from photon_tpu_torch import checkpoint

    ckdir, site, occurrence = ctx.args
    mesh = _mesh(ctx)
    killed = False
    try:
        with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                                async_writer=False):
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at(site, int(occurrence))):
                solve_chunked(mesh)
    except checkpoint.InjectedFault:
        killed = True
    return {"rank": ctx.process_id, "killed": killed,
            "latest_seq": checkpoint.SnapshotStore(str(ckdir)).latest_seq()}


def target_resume_solve(ctx) -> dict:
    """args=(ckpt_dir,): restore the last committed snapshot (every
    ``p<k>_`` prefix it holds, possibly from another process count) onto
    this cluster's mesh and finish."""
    from photon_tpu_torch import checkpoint, telemetry

    (ckdir,) = ctx.args
    mesh = _mesh(ctx)
    telemetry.reset()
    with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                            async_writer=False):
        w = solve_chunked(mesh)
    restores = telemetry.snapshot()["counters"].get(
        "checkpoint.solver_restores", 0)
    return {"rank": ctx.process_id, "w": w, "digest": _digest(w),
            "restored": int(restores)}


def target_commit_kill(ctx) -> dict:
    """args=(ckpt_dir, kill_rank, occurrence): rank ``kill_rank`` dies at
    its Nth ``snapshot_write`` kill point — after its payloads and meta
    are durable, before the commit barrier. The other ranks must see the
    commit fail loudly, not hang or commit a manifest over a dead rank's
    unconfirmed snapshot."""
    import time

    from photon_tpu_torch import checkpoint

    ckdir, kill_rank, occurrence = ctx.args
    mesh = _mesh(ctx)
    out: dict = {"rank": ctx.process_id}
    t0 = time.perf_counter()
    try:
        with checkpoint.session(str(ckdir), every_evals=1, every_s=None,
                                async_writer=False):
            if ctx.process_id == int(kill_rank):
                with checkpoint.fault_plan(checkpoint.FaultPlan.kill_at(
                        "snapshot_write", int(occurrence))):
                    solve_chunked(mesh)
            else:
                solve_chunked(mesh)
        out["outcome"] = "completed"
    except checkpoint.InjectedFault:
        out["outcome"] = "killed"
    except RuntimeError as e:  # the barrier's failure IS the result
        out["outcome"] = "commit_failed"
        out["error"] = f"{type(e).__name__}: {e}"[:500]
    out["seconds"] = time.perf_counter() - t0
    out["latest_seq"] = checkpoint.SnapshotStore(str(ckdir)).latest_seq()
    return out


# ------------------------------------------- a saved sharded batch
def _np_leaf(t):
    """(numpy array, dtype name) of a CPU tensor (bf16 as its uint16
    bits: numpy has no bfloat16)."""
    import torch

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def save_sharded_batch(batch, root) -> None:
    """Save a host `GLMBatch` whose X is a `ShardedBlockedEllRows`
    (`data.dataset.shard_blocked_ell_batch`) leaf by leaf as ``.npy``
    files under ``root``, for `load_sharded_batch` to map."""
    import dataclasses
    import json
    import pathlib

    import torch

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    meta: dict = {"fields": {}}
    X = batch.X
    for f in dataclasses.fields(X):
        if not f.init:  # a cache kept with the layout, not a leaf
            continue
        v = getattr(X, f.name)
        leaves = v if isinstance(v, tuple) else (v,)
        if all(isinstance(t, torch.Tensor) for t in leaves) and leaves:
            dts = []
            for j, t in enumerate(leaves):
                a, dt = _np_leaf(t)
                np.save(root / f"{f.name}.{j}.npy", a)
                dts.append(dt)
            meta["fields"][f.name] = {"tuple": isinstance(v, tuple),
                                      "dtypes": dts}
        elif isinstance(v, tuple):
            meta["fields"][f.name] = {"tuple": True, "dtypes": []}
        else:
            meta["fields"][f.name] = {"value": v}
    for c in ("y", "weights", "offsets"):
        np.save(root / f"{c}.npy", np.asarray(getattr(batch, c), np.float32))
    (root / "meta.json").write_text(json.dumps(meta))


def load_sharded_batch(root, mesh):
    """The batch `save_sharded_batch` wrote, as a mesh batch holding only
    THIS process's slots (their shards copied out of memory-mapped
    files; other processes' shards are never read)."""
    import json
    import pathlib

    import torch

    from photon_tpu_torch.data.dataset import GLMBatch
    from photon_tpu_torch.data.matrix import ShardedBlockedEllRows
    from photon_tpu_torch.parallel.mesh import SlotRows

    root = pathlib.Path(root)
    meta = json.loads((root / "meta.json").read_text())["fields"]
    lo, hi = mesh.local_slots[0], mesh.local_slots[-1] + 1
    n_shards = int(np.load(root / "row_pos.0.npy", mmap_mode="r").shape[0])
    if n_shards != mesh.n_slots:
        raise ValueError(f"saved batch has {n_shards} shards, the mesh "
                         f"{mesh.n_slots} slots")

    def leaf(name, j, rows=None):
        a = np.load(root / f"{name}.{j}.npy", mmap_mode="r")
        dt = meta[name]["dtypes"][j]
        if name in ("perm_cols", "inv_perm"):
            part = a
        elif rows is not None:
            part = a[rows]
        else:
            part = a[lo:hi]
        t = torch.from_numpy(np.array(part))
        return t.view(torch.bfloat16) if dt == "bfloat16" else t

    n_local_rows = int(np.load(root / "row_pos.0.npy",
                               mmap_mode="r").shape[1])
    rows = slice(lo * n_local_rows, hi * n_local_rows)
    kw = {}
    for name, spec in meta.items():
        if "value" in spec:
            kw[name] = spec["value"]
            continue
        r = rows if name == "dense" else None
        got = tuple(leaf(name, j, r) for j in range(len(spec["dtypes"])))
        kw[name] = got if spec["tuple"] else got[0]
    mine = ShardedBlockedEllRows(**kw)
    parts = tuple(mine.chunk(k).to(dev)
                  for k, dev in enumerate(mesh.slot_devices))

    def col(c):
        a = torch.from_numpy(np.array(
            np.load(root / f"{c}.npy", mmap_mode="r")[rows]))
        return SlotRows(mesh, tuple(
            a[k * n_local_rows:(k + 1) * n_local_rows].to(dev)
            for k, dev in enumerate(mesh.slot_devices)), n_local_rows)

    return GLMBatch(SlotRows(mesh, parts, n_local_rows), col("y"),
                    col("weights"), col("offsets"))


def target_saved_solve(ctx) -> dict:
    """args=(root, config kwargs): the resident mesh L-BFGS (logistic,
    L2) of the batch saved under ``root``, this rank mapping only its own
    slots' shards; the f64 coefficients, their digest and the history."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    root, cfg = ctx.args
    mesh = _mesh(ctx)
    batch = load_sharded_batch(root, mesh)
    telemetry.reset()
    model, res = train_glm(batch, TaskType.LOGISTIC_REGRESSION,
                           OptimizerConfig(reg=l2(), **cfg), mesh=mesh)
    c = telemetry.snapshot()["counters"]
    w = model.coefficients.means.cpu().numpy().astype(np.float64)
    return {"rank": ctx.process_id, "digest": _digest(w),
            "w_head": w[:8], "history": res.history(),
            "iterations": int(res.iterations),
            "reductions": int(c.get("mesh.reductions", 0)),
            "collectives": int(c.get("mesh.collectives", 0)),
            "wire_bytes": int(c.get("mesh.wire_bytes", 0))}


# ------------------------------------------------------------ GAME on a mesh
def game_problem(n: int = 512, users: int = 29, layout: str = "dense",
                 n_shards: int = 8, seed: int = 5):
    """Deterministic GAME data (seeded, rebuilt the same in every
    process): ``n`` logistic rows, a fixed shard (d 6 with the intercept
    last; ``layout="ell"`` lays its sparse form, d 40, for an
    ``n_shards``-slot mesh with `shard_blocked_ell_batch`), a dense
    per-user shard (d 4, intercept last) and zipf-skewed user ids."""
    from photon_tpu_torch.data.dataset import (make_batch,
                                               shard_blocked_ell_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData

    rng = np.random.default_rng(seed)
    Xu = np.concatenate([rng.normal(size=(n, 3)), np.ones((n, 1))],
                        1).astype(np.float32)
    uid = (rng.zipf(1.4, size=n) - 1) % users
    wu = (0.5 * rng.normal(size=(users, 4))).astype(np.float32)
    if layout == "ell":
        d = 40
        ind = np.concatenate([(rng.zipf(1.3, size=(n, 5)) - 1) % (d - 1),
                              np.full((n, 1), d - 1)], 1).astype(np.int32)
        val = np.concatenate([rng.normal(size=(n, 5)), np.ones((n, 1))],
                             1).astype(np.float32)
        wf = (0.3 * rng.normal(size=d)).astype(np.float32)
        zf = np.einsum("nk,nk->n", val, wf[ind])
        Xf = SparseRows(ind, val, d)
    else:
        Xf = np.concatenate([rng.normal(size=(n, 5)), np.ones((n, 1))],
                            1).astype(np.float32)
        zf = Xf @ (0.5 * rng.normal(size=6)).astype(np.float32)
    z = zf + np.einsum("nd,nd->n", Xu, wu[uid])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    if layout == "ell":
        Xf = shard_blocked_ell_batch(make_batch(Xf, y, device="cpu"),
                                     n_shards, d_dense=8).X
    return GameData.build(y, {"fixed": Xf, "u": Xu}, {"user": uid})


def game_configs() -> dict:
    """`game_problem`'s coordinates: a fixed effect and a per-user random
    effect (L2, logistic)."""
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 RandomEffectConfig)
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    return {"fixed": FixedEffectConfig("fixed", OptimizerConfig(
                max_iters=20, reg=l2(), reg_weight=1.0, tolerance=1e-6)),
            "per_user": RandomEffectConfig("user", "u", OptimizerConfig(
                max_iters=12, reg=l2(), reg_weight=2.0, tolerance=1e-4))}


def fit_game(mesh, data, configs: dict, n_sweeps: int = 2, variance=None,
             ckpt_dir=None, kill_at: int = 0) -> dict:
    """``data`` (a `GameData`) fitted by `GameEstimator(mesh=)` (logistic,
    ``configs`` name -> coordinate config): every coordinate's table in
    f64 (``tables``), their digest in name order, the objective history,
    the restores, collectives and kernel launches of the run. With
    ``ckpt_dir`` the fit runs under a checkpoint session snapshotting
    every evaluation, killed at the ``kill_at``-th ``bucket_retire`` (0:
    not killed; then only ``killed`` is set)."""
    import contextlib

    from photon_tpu_torch import checkpoint, kernels, telemetry
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.models.variance import VarianceComputationType
    from photon_tpu_torch.ops.losses import TaskType

    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, dict(configs),
                        n_sweeps=n_sweeps, mesh=mesh,
                        variance=variance or VarianceComputationType.NONE)
    telemetry.reset()
    kernels.reset_launch_counts()
    if ckpt_dir is None:
        (fit,) = est.fit(data)
    else:
        plan = (checkpoint.fault_plan(checkpoint.FaultPlan.kill_at(
            "bucket_retire", int(kill_at))) if kill_at
            else contextlib.nullcontext())
        try:
            with checkpoint.session(str(ckpt_dir), every_evals=1,
                                    every_s=None, async_writer=False):
                with plan:
                    (fit,) = est.fit(data)
        except checkpoint.InjectedFault:
            return {"killed": True, "digest": None}
    tables = {}
    for name in sorted(fit.model.coordinates):
        m = fit.model.coordinates[name]
        t = m.model.weights if hasattr(m, "model") else m.coefficients
        tables[name] = t.cpu().numpy().astype(np.float64)
    c = telemetry.snapshot()["counters"]
    return {"killed": False, "tables": tables,
            "digest": _digest(np.concatenate(
                [t.reshape(-1) for t in tables.values()])),
            "history": list(fit.descent.objective_history),
            "restores": int(c.get("checkpoint.descent_restores", 0)
                            + c.get("checkpoint.re_restores", 0)),
            "collectives": int(c.get("mesh.collectives", 0)),
            "launches": kernels.launch_counts()}


def game_fit(mesh, layout: str = "dense", ckpt_dir=None,
             kill_at: int = 0) -> dict:
    """`game_problem` (laid for the mesh) through `fit_game`, two sweeps
    (the random effect at ``pipeline_depth`` 1)."""
    return fit_game(mesh, game_problem(layout=layout,
                                       n_shards=mesh.n_slots),
                    game_configs(), 2, None, ckpt_dir, kill_at)


def target_game_data(ctx) -> dict:
    """args=(data, configs, n_sweeps, variance, ckpt_dir or None,
    kill_at): `fit_game` of a parent's `GameData` on this cluster's
    mesh."""
    data, configs, n_sweeps, variance, ckdir, kill_at = ctx.args
    out = fit_game(_mesh(ctx), data, configs, n_sweeps, variance, ckdir,
                   int(kill_at))
    out["rank"] = ctx.process_id
    return out
