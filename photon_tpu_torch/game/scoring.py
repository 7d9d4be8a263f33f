"""Offline batch scoring of GAME models (port of `photon_tpu/game/
scoring.py`). It scores what `game.estimator.GameEstimator.fit` returns,
on the model's device.

The total score is the base offsets plus every coordinate's margin,
summed in coordinate order — the sum the serving ladder's f32 rungs must
agree with.

A fixed effect whose shard is a host `ChunkedMatrix` (the streamed
regime) scores through `score_chunked_host`: each chunk streams through
the device, its margins are copied asynchronously into a pinned HOST
(n,) cache, and the full-dataset score vector never lives on the device,
so the GAME descent sums its offsets on the host. With a mesh each chunk
streams row-sharded over the slots (a mesh ladder's `ShardedBlockedEllRows`
chunk shard by shard through the blocked-ELL kernels; dense and
`SparseRows` chunks cut into padded row slices), and the per-slot margins
come back in slot order through one gather per call.

A row-sharded fixed shard (`SlotRows`, the mesh form of a GAME fixed
effect) scores slot by slot and gathers in slot order (`mesh_margins`);
a sharded layout (`ShardedBlockedEllRows`, `ShardedHybridRows`,
`ShardedPermutedHybridRows`) in scoring data scores shard by shard on the
model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import ChunkedMatrix, make_chunked_batch
from photon_tpu_torch.data.matrix import (PERMUTED_LAYOUTS,
                                          SHARDED_LAYOUTS,
                                          SINGLE_DEVICE_LAYOUTS, SparseRows,
                                          as_tensor, matvec, matvec_lanes)
from photon_tpu_torch.parallel.mesh import (SlotRows, check_mesh,
                                            gather_processes, gather_rows,
                                            pad_to_multiple)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.dataset import GameData
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)


def _model_device(model: GameModel) -> torch.device:
    cm = next(iter(model.coordinates.values()))
    if isinstance(cm, FixedEffectModel):
        return cm.model.weights.device
    return cm.coefficients.device


def _on(X, device):
    if isinstance(X, (ChunkedMatrix,) + SHARDED_LAYOUTS):
        return X  # streamed chunk by chunk / shard by shard
    if isinstance(X, (SparseRows,) + SINGLE_DEVICE_LAYOUTS):
        return X.to(device)
    return as_tensor(X, device)


def mesh_margins(X: SlotRows, w: torch.Tensor, n_rows: int
                 ) -> torch.Tensor:
    """The (n,) margins (or (n, G) for lane-minor (d, G) ``w``) of a
    row-sharded matrix for model-space ``w``: every local slot's matvec on
    its device (a blocked-ELL slot through the kernels, ``w`` in a
    permuted layout's permuted space), gathered in slot order over the
    processes and trimmed to the ``n_rows`` real rows, on the home
    device."""
    w = w.to(X.mesh.home, torch.float32)
    if isinstance(X.parts[0], PERMUTED_LAYOUTS):
        w = X.from_model_space(w)
    local = matvec_lanes(X, w.contiguous()) if w.dim() == 2 \
        else matvec(X, w)
    return gather_rows(X.mesh, local, n_rows)


def _score_sharded(X, w: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Margins of a host sharded layout on ``w``'s device, shard by shard
    in row order (the mesh form scored on one device; ``w`` translated
    into a permuted layout's space once)."""
    dev = w.device
    w = w.to(torch.float32)
    if hasattr(X, "perm_cols"):
        w = w[X.perm_cols.to(dev).long()]
    parts = [matvec(X.local(j).to(dev), w) for j in range(X.n_shards)]
    return torch.cat(parts)[:n_rows]


def coordinate_scores(model: GameModel, data: GameData) -> dict:
    """Per-coordinate margin contributions on ``data`` (on the model's
    device)."""
    device = _model_device(model)
    out = {}
    for name, cm in model.coordinates.items():
        X = _on(data.shards[cm.feature_shard], device)
        if isinstance(cm, FixedEffectModel):
            out[name] = (_score_sharded(X, cm.model.weights, data.n)
                         if isinstance(X, SHARDED_LAYOUTS)
                         else cm.score(X))
        elif isinstance(cm, RandomEffectModel):
            out[name] = cm.score(X, cm.dense_ids(
                data.entity_ids[cm.entity_name]))
        else:
            raise TypeError(f"unknown coordinate model type: {type(cm)}")
    return out


def score_game(model: GameModel, data: GameData) -> torch.Tensor:
    """Total raw score: base offsets + Σ coordinate margins
    (reference: GameScoringDriver's scoreGameModel)."""
    scores = coordinate_scores(model, data)
    out = as_tensor(data.offsets, _model_device(model)).to(torch.float32)
    for s in scores.values():
        out = out + s
    return out


def predict_mean(model: GameModel, data: GameData) -> torch.Tensor:
    """The mean response of every row, the task's inverse link of
    `score_game` (reference: computeMean)."""
    return model.mean(score_game(model, data))


def score_chunked_host(X: ChunkedMatrix, w, mesh=None,
                       device=None) -> np.ndarray:
    """Margins of a host ChunkedMatrix as a HOST (n_real,) f32 cache
    (reference: `score_chunked_host`). Each chunk streams through the
    upload ring onto ``w``'s device (``device`` for a host ``w``; default
    ``cuda``), takes one matvec there (a chunk ladder's blocked-ELL
    kernels; ``w`` translated into its permuted space once), and its
    margins are copied asynchronously into a pinned host buffer read once
    the stream has closed. With ``mesh`` every chunk streams row-sharded
    over the slots (`_score_chunked_mesh`); a ladder laid for a mesh
    (`chunk_blocked_ell(n_shards > 1)`) needs one."""
    check_mesh(mesh)
    if mesh is not None:
        return _score_chunked_mesh(X, w, mesh)
    if X.chunk_shards > 1:
        raise ValueError(
            f"this blocked-ELL chunk ladder was laid for a "
            f"{X.chunk_shards}-device mesh; pass mesh= to score it "
            "(or rebuild with chunk_blocked_ell(n_shards=1))")
    if isinstance(w, torch.Tensor):
        dev = w.device
    else:
        dev = resolve_device(device)
        w = torch.from_numpy(np.asarray(w, np.float32)).to(dev)
    w = w.to(torch.float32)
    if X.permuted:
        w = w[X.perm_cols.to(dev).long()]
    cuda = dev.type == "cuda"
    c = X.chunk_rows
    out = torch.empty((X.n_padded,), dtype=torch.float32, pin_memory=cuda)
    data = make_chunked_batch(X, np.zeros(X.n_real, np.float32))
    for i, b in data.iter_device(device=dev):
        out[i * c:(i + 1) * c].copy_(matvec(b.X, w), non_blocking=True)
        telemetry.count("game_e2e.score_stream_chunks")
    if cuda:
        torch.cuda.current_stream(dev).synchronize()
    telemetry.count("game_e2e.score_stream_rows", int(X.n_real))
    return out.numpy()[:X.n_real]


def _score_chunked_mesh(X: ChunkedMatrix, w, mesh) -> np.ndarray:
    """`score_chunked_host` over a mesh: every chunk streams through the
    mesh's upload ring (`data.dataset.MeshChunkRing`: each local slot's
    rows of the chunk — padded to the mesh, or the slot's shard of a mesh
    ladder — on the slot's device), each slot's margins land in a pinned
    host buffer, and one gather over the processes puts every slot's rows
    back in global order: chunk-major, slot-major within a chunk, each
    chunk's padding dropped."""
    home = mesh.home
    w = (w.detach() if isinstance(w, torch.Tensor)
         else torch.from_numpy(np.asarray(w, np.float32)))
    w = w.to(home, torch.float32)
    if X.permuted:
        w = w[X.perm_cols.to(home).long()]
    cuda = home.type == "cuda"
    c = X.chunk_rows
    s = pad_to_multiple(c, mesh.n_slots) // mesh.n_slots
    local = torch.empty((X.n_chunks, mesh.n_local, s), dtype=torch.float32,
                        pin_memory=cuda)
    on: dict = {}
    data = make_chunked_batch(X, np.zeros(X.n_real, np.float32))
    for i, parts in data.iter_device(mesh=mesh):
        for k, (b, dev) in enumerate(zip(parts, mesh.slot_devices)):
            if dev not in on:
                on[dev] = w.to(dev)
            local[i, k].copy_(matvec(b.X, on[dev]), non_blocking=True)
        telemetry.count("game_e2e.score_stream_chunks")
    if cuda:
        for dev in set(mesh.slot_devices):
            torch.cuda.current_stream(dev).synchronize()
    rows = gather_processes(mesh, local.to(home))  # (P, chunks, local, s)
    rows = rows.permute(1, 0, 2, 3).reshape(X.n_chunks, mesh.n_slots * s)
    telemetry.count("game_e2e.score_stream_rows", int(X.n_real))
    return rows[:, :c].reshape(-1)[:X.n_real].cpu().numpy()


# ----------------------------------------------------------------- contracts
# The streamed scorer's chunk program: each slot's margins of a mesh
# blocked-ELL chunk stay on its device — no collective, no combining
# scatter, f32 out of bf16 storage; the host margin cache does the
# summing.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import SCATTER_PRIMITIVES  # noqa: E402


@register_contract(
    name="game_score_stream_chunk",
    description="one streamed GAME scoring chunk (score_chunked_host's "
                "per-slot matvec over a mesh blocked-ELL chunk): margins "
                "stay slot-local — zero collectives, no combining "
                "scatter, f32 accumulation",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("game", "mesh-streamed", "sparse"))
def _contract_game_score_stream_chunk(device):
    from photon_tpu_torch.data.dataset import chunk_blocked_ell, make_batch
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=8, device=device)
    d, k = 96, 4
    rng = np.random.default_rng(0)
    n = 32 * mesh.n_slots
    sp = SparseRows(rng.integers(0, d, size=(n, k)).astype(np.int32),
                    rng.normal(size=(n, k)).astype(np.float32), d)
    ladder = chunk_blocked_ell(make_batch(sp, np.zeros(n, np.float32),
                                          device="cpu"), n // 2, 16,
                               feature_dtype=torch.bfloat16,
                               n_shards=mesh.n_slots)
    parts = [p for _, p in ladder.iter_device(mesh=mesh)][0]
    w = torch.from_numpy(0.1 * rng.normal(size=d).astype(np.float32))
    w = w.to(mesh.home)[ladder.X.perm_cols.to(mesh.home).long()]

    def fn(chunk, wv):
        return [matvec(b.X, wv.to(dev))
                for b, dev in zip(chunk, mesh.slot_devices)]

    return fn, (parts, w)
