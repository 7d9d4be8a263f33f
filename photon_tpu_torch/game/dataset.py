"""GAME datasets: the data container, fixed-effect batches and
entity-bucketed random-effect blocks (port of `GameData`,
`FixedEffectDataset`, `REBlock` and `RandomEffectDataset` of
`photon_tpu/game/dataset.py`).

Reference parity: com.linkedin.photon.ml.data.{FixedEffectDataset,
RandomEffectDataset, GameDatum}. The reference partitions random-effect
data by entity across Spark executors and trains one solver per entity;
here:

- entities are bucketed by row count into power-of-two block heights m
  (the smallest power of two ≥ the entity's active rows), adjacent buckets
  merged down to ``max_blocks``;
- within a bucket the entities stack into one block, rows padded with
  weight 0 so every reduction ignores the padding; the block is laid
  LANE-MINOR on the device — (m, d, E) rows, (m, E) labels, weights and
  row ids, the entity axis contiguous — because the per-entity solves run
  as the port's lane solvers with lanes = entities (`data.matrix.
  EntityBlocks`). `REBlock`'s fields expose the reference's entity-major
  (E, m, …) layout as views of that storage;
- the reference's active/passive split (`numActiveDataPointsUpperBound`)
  is ``active_cap``: each entity's first ``active_cap`` rows (after a
  seeded shuffle) are trained on; all rows are scored through the flat
  per-row shard kept beside the blocks;
- a fixed effect's shard may be a host `data.dataset.ChunkedMatrix` (the
  streamed regime, for data larger than device memory): it stays on the
  host with its scalar columns, and `FixedEffectDataset.batch` assembles
  a `ChunkedBatch` that `train_glm` streams. A random effect needs a
  resident shard.

The bucketing runs on the host in numpy, the reference's own code, so
entity order, m, row ids, padding and the projected X equal the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.data.dataset import (ChunkedMatrix, GLMBatch,
                                           make_chunked_batch)
from photon_tpu_torch.data.matrix import (SHARDED_LAYOUTS,
                                          SINGLE_DEVICE_LAYOUTS, EntityBlocks,
                                          SparseRows, _host, as_tensor,
                                          next_pow2)
from photon_tpu_torch.device import resolve_device


@dataclasses.dataclass
class GameData:
    """Host-side GAME data: response + per-shard design matrices (numpy
    arrays, tensors, `SparseRows` or, for a fixed effect, a layout
    (`BlockedEllRows`, `HybridRows`, `PermutedHybridRows`, or a sharded
    one for a mesh) or a host-chunked `ChunkedMatrix`) + per-coordinate
    raw entity
    ids."""

    y: np.ndarray  # (n,)
    weights: np.ndarray  # (n,)
    offsets: np.ndarray  # (n,) base offsets
    shards: dict  # feature-shard name -> matrix (n rows)
    entity_ids: dict  # entity-type name -> (n,) raw ids

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    @staticmethod
    def build(y, shards, entity_ids=None, weights=None,
              offsets=None) -> "GameData":
        y = np.asarray(y, np.float32)
        n = y.shape[0]
        weights = (np.ones(n, np.float32) if weights is None
                   else np.asarray(weights, np.float32))
        offsets = (np.zeros(n, np.float32) if offsets is None
                   else np.asarray(offsets, np.float32))
        return GameData(y, weights, offsets, dict(shards),
                        dict(entity_ids or {}))

    def to_device(self, device=None) -> "GameData":
        """This data for scoring and evaluation on ``device`` (default
        ``cuda``): every resident shard, the labels, weights and offsets
        moved there once, so each later score and metric is device work
        alone (reference: `GameData.to_device`). A host-chunked shard
        stays on the host (it streams chunk by chunk), and so does a
        mesh's sharded layout (it scores shard by shard); entity ids
        stay host numpy (they are densified on the host). Training data
        stays on the host: its entity bucketing reads numpy columns."""
        dev = resolve_device(device)

        def put(X):
            if isinstance(X, (ChunkedMatrix,) + SHARDED_LAYOUTS):
                return X
            return _on_device(X, dev)

        def col(v):
            return as_tensor(np.asarray(v, np.float32)
                             if not isinstance(v, torch.Tensor) else v,
                             dev).to(torch.float32)

        return GameData(col(self.y), col(self.weights), col(self.offsets),
                        {k: put(X) for k, X in self.shards.items()},
                        self.entity_ids)


def _shard_dim(X) -> int:
    if isinstance(X, (SparseRows, ChunkedMatrix) + SINGLE_DEVICE_LAYOUTS
                  + SHARDED_LAYOUTS):
        return X.n_features
    return int(X.shape[1])


def _refuse_chunked_entity_shard(X) -> None:
    if isinstance(X, ChunkedMatrix):
        raise TypeError(
            "random-effect coordinates need a resident shard (entity "
            "bucketing gathers rows); the training driver only chunks "
            "shards used exclusively by fixed effects — keep this shard "
            "out of the streamed-objective set")


def _gather_rows(X, idx: np.ndarray):
    """Host-side row gather: numpy dense rows, or (indices, values)."""
    if isinstance(X, SINGLE_DEVICE_LAYOUTS):
        raise TypeError(
            f"{type(X).__name__} shards are not supported for GAME entity "
            "bucketing (single-device fixed-effect representation); use "
            "SparseRows or dense shards for random-effect coordinates")
    if isinstance(X, SparseRows):
        return _host(X.indices)[idx], _host(X.values)[idx]
    if isinstance(X, torch.Tensor):
        return X.detach().to(torch.float32).cpu().numpy()[idx]
    return np.asarray(X)[idx]


def _host_shard(X):
    """A shard as the host form `data.dataset.mesh_batch` shards: numpy
    rows, CPU `SparseRows`, or a layout as it is (a sharded one is laid
    out by `mesh_batch`, a one-device one refused there)."""
    if isinstance(X, SparseRows):
        return SparseRows(torch.as_tensor(_host(X.indices)),
                          torch.as_tensor(_host(X.values)), X.n_features)
    if isinstance(X, torch.Tensor):
        return X.detach().cpu()
    if isinstance(X, SINGLE_DEVICE_LAYOUTS + SHARDED_LAYOUTS):
        return X
    return np.asarray(X, np.float32)


def _on_device(X, dev):
    """A shard on the device: layouts move as they are (a sharded one
    then trains in its global view); a floating tensor
    keeps its storage dtype (a bf16 shard stays bf16); anything else
    arrives as f32."""
    if isinstance(X, (SparseRows,) + SINGLE_DEVICE_LAYOUTS
                  + SHARDED_LAYOUTS):
        return X.to(dev)
    if isinstance(X, torch.Tensor) and X.is_floating_point():
        return X.to(dev)
    return as_tensor(np.asarray(X, np.float32), dev)


@dataclasses.dataclass(frozen=True)
class FixedEffectDataset:
    """One feature shard over all rows (reference: FixedEffectDataset):
    on ``device``, or, for a host-chunked shard, on the host (``y`` and
    ``weights`` numpy) with ``device`` the one its chunks stream onto.

    With ``mesh`` a resident shard is row-sharded over the mesh's slots
    once, at build (`data.dataset.mesh_batch`: X a `SlotRows` — dense
    rows, `SparseRows`, or a sharded layout's shards — and ``y``
    and ``weights`` this process's padded rows on the home device); every
    solve reuses the shards and `batch` cuts this process's rows out of
    the descent's whole offsets."""

    shard_name: str
    X: object
    y: object  # (n,) tensor on `device`, or numpy for a chunked shard
    weights: object
    device: Optional[torch.device] = None
    mesh: Optional[object] = None
    n_rows: Optional[int] = None  # the real rows of a row-sharded shard
    # the GameData's own shard behind a row-sharded X (whole statistics,
    # such as a normalization context, read it)
    host: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def n(self) -> int:
        return (int(self.n_rows) if self.n_rows is not None
                else int(self.y.shape[0]))

    @property
    def dim(self) -> int:
        return _shard_dim(self.X)

    @property
    def chunked(self) -> bool:
        return isinstance(self.X, ChunkedMatrix)

    @staticmethod
    def build(data: GameData, shard_name: str, device=None,
              mesh=None) -> "FixedEffectDataset":
        dev = mesh.home if mesh is not None else resolve_device(device)
        X = data.shards[shard_name]
        if isinstance(X, ChunkedMatrix):
            # the streamed regime: the shard and its scalar columns stay
            # on the host; batch() assembles a ChunkedBatch (streamed
            # over the mesh's slots by the solve itself)
            return FixedEffectDataset(
                shard_name, X, np.asarray(data.y, np.float32),
                np.asarray(data.weights, np.float32), dev, mesh)
        if mesh is not None:
            from photon_tpu_torch.data.dataset import mesh_batch

            col = (lambda v: torch.from_numpy(np.asarray(v, np.float32)))
            b = mesh_batch(GLMBatch(_host_shard(X), col(data.y),
                                    col(data.weights),
                                    torch.zeros(data.n)), mesh)
            return FixedEffectDataset(shard_name, b.X, b.y, b.weights, dev,
                                      mesh, data.n, X)
        return FixedEffectDataset(
            shard_name, _on_device(X, dev),
            as_tensor(np.asarray(data.y, np.float32), dev),
            as_tensor(np.asarray(data.weights, np.float32), dev), dev)

    def batch(self, offsets):
        """The solve's batch with these (n,) offsets: a `ChunkedBatch` for
        a chunked shard (offsets fetched to the host, 4 bytes a row), else
        a GLMBatch on the device."""
        if self.chunked:
            if isinstance(offsets, torch.Tensor):
                offsets = offsets.detach().cpu().numpy()
            return make_chunked_batch(self.X, self.y, self.weights,
                                      np.asarray(offsets, np.float32))
        offs = (offsets.to(self.y.device, torch.float32)
                if isinstance(offsets, torch.Tensor)
                else as_tensor(np.asarray(offsets, np.float32),
                               self.y.device))
        if self.mesh is not None:
            from photon_tpu_torch.parallel.mesh import local_rows

            offs = local_rows(self.mesh, offs, self.X.n_rows)
        return GLMBatch(self.X, self.y, self.weights, offs)


@dataclasses.dataclass(frozen=True)
class REBlock:
    """One bucket of entities with identical padded shape. ``y``,
    ``weights``, ``row_index`` and ``X`` are the reference's entity-major
    (E, m, …) views of the lane-minor storage that ``lanes`` holds."""

    m: int  # rows per entity (power of two)
    entity_index: np.ndarray  # (E,) dense entity ids (host)
    row_index: torch.Tensor  # (E, m) original row ids (padding: the first)
    y: torch.Tensor  # (E, m)
    weights: torch.Tensor  # (E, m); 0 marks padding
    X: object  # dense (E, m, d), or (indices (E, m, k), values (E, m, k))
    lanes: EntityBlocks  # the block as a lane-minor design matrix
    # projected bucket: its feature dim (X dense (E, m, dim)) and, for
    # INDEX_MAP, the per-entity index map behind it
    dim: Optional[int] = None
    proj: Optional[object] = None  # projector.BlockProjection

    @property
    def n_entities(self) -> int:
        return int(self.entity_index.shape[0])

    def take(self, idx, pad: int, device=None) -> "REBlock":
        """Entities ``idx`` (positions in this bucket) as a bucket of
        ``pad`` entities on ``device`` (default: this one's), zero
        entities after them: weight-0 rows, row ids 0, entity index -1 —
        one mesh slot's share of the bucket (`game.grid`)."""
        from photon_tpu_torch.parallel.mesh import compact_rows

        idx = np.asarray(idx, np.int64).reshape(-1)
        dev = self.y.device if device is None else device
        lanes = self.lanes.take(idx, pad).to(dev)
        ri, y, w = (compact_rows(t, idx, pad_rows=pad).t().contiguous()
                    .to(dev) for t in (self.row_index, self.y,
                                       self.weights))
        ents = np.full(pad, -1, np.int32)
        ents[:idx.size] = self.entity_index[idx]
        X = (_entity_major(lanes.dense) if lanes.dense is not None
             else (_entity_major(lanes.indices),
                   _entity_major(lanes.values)))
        return REBlock(m=self.m, entity_index=ents,
                       row_index=_entity_major(ri), y=_entity_major(y),
                       weights=_entity_major(w), X=X, lanes=lanes,
                       dim=self.dim, proj=self.proj)


def _lane_minor(a: np.ndarray, dev) -> torch.Tensor:
    """(E, m, …) host array → its (m, …, E) contiguous device copy."""
    order = tuple(range(1, a.ndim)) + (0,)
    return as_tensor(np.ascontiguousarray(np.transpose(a, order)), dev)


def _entity_major(t: torch.Tensor) -> torch.Tensor:
    """The (E, m, …) view of an (m, …, E) lane-minor tensor."""
    return t.permute((t.dim() - 1,) + tuple(range(t.dim() - 1)))


def _project_dense(Xd: np.ndarray, icpt) -> tuple:
    """INDEX_MAP-project a dense (E, m, d) bucket: per-entity active
    columns only, intercept pinned last."""
    from photon_tpu_torch.game.projector import (build_index_map_projection,
                                                 project_dense_block)

    active = np.any(Xd != 0.0, axis=1)  # (E, d)
    if icpt is not None:
        active[:, icpt] = False
    sets = [np.nonzero(a)[0] for a in active]
    bp = build_index_map_projection(sets, icpt)
    return project_dense_block(Xd, bp), bp


def _project_sparse(ind3: np.ndarray, val3: np.ndarray, icpt) -> tuple:
    """INDEX_MAP-project a padded-COO (E, m, k) bucket to per-entity dense
    (E, m, p) blocks."""
    from photon_tpu_torch.game.projector import (build_index_map_projection,
                                                 project_sparse_block)

    sets = []
    for e in range(ind3.shape[0]):
        feats = np.unique(ind3[e][val3[e] != 0.0])
        if icpt is not None:
            feats = feats[feats != icpt]
        sets.append(feats)
    bp = build_index_map_projection(sets, icpt)
    return project_sparse_block(ind3, val3, bp), bp


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """Entity-bucketed random-effect data (reference:
    RandomEffectDataset). ``blocks`` hold the active training rows; ``X``
    (the flat per-row shard, full feature space, on the device) and
    ``entity_dense`` give the per-row view that scoring uses (passive rows
    too)."""

    entity_name: str
    shard_name: str
    entity_keys: np.ndarray  # (E,) raw keys, dense id = position
    key_to_index: dict  # raw key -> dense id
    blocks: list  # list[REBlock]
    X: object  # flat (n, d) shard on the device
    entity_dense: np.ndarray  # (n,) dense entity id per row
    n_active: int
    n_passive: int
    projection: Optional[object] = None  # projector.ProjectionConfig
    projector: Optional[object] = None  # projector.RandomProjector

    @property
    def n_entities(self) -> int:
        return int(self.entity_keys.shape[0])

    @property
    def dim(self) -> int:
        return _shard_dim(self.X)

    @property
    def device(self) -> torch.device:
        X = self.X
        return (X.values if isinstance(X, SparseRows) else X).device

    @staticmethod
    def build(data: GameData, entity_name: str, shard_name: str,
              active_cap: Optional[int] = None, min_block_rows: int = 4,
              seed: int = 0, projection=None, max_blocks: int = 3,
              device=None) -> "RandomEffectDataset":
        dev = resolve_device(device)
        X = data.shards[shard_name]
        _refuse_chunked_entity_shard(X)
        raw = np.asarray(data.entity_ids[entity_name])
        keys, entity_dense = np.unique(raw, return_inverse=True)
        entity_dense = entity_dense.astype(np.int32)
        n = data.n
        E = keys.shape[0]
        w_np = np.asarray(data.weights, np.float32)

        # Entities with no weight-carrying row are dropped from training;
        # their rows keep dense id E, the unseen-entity convention (every
        # scorer gathers the appended zero row for them).
        carrying = np.bincount(
            entity_dense, weights=(w_np != 0.0).astype(np.float64),
            minlength=E) > 0
        if carrying.any() and not carrying.all():
            E_live = int(carrying.sum())
            remap = np.full(E, E_live, np.int32)
            remap[carrying] = np.arange(E_live, dtype=np.int32)
            keys = keys[carrying]
            entity_dense = remap[entity_dense]
            E = E_live

        # Group rows by entity (stable: original row order per entity;
        # dropped-entity rows, id E, sort last).
        order = np.argsort(entity_dense, kind="stable")
        counts = np.bincount(entity_dense, minlength=E + 1)[:E]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

        if active_cap is not None:
            # down-sample each oversized entity's active rows uniformly,
            # weight-carrying rows first
            rng = np.random.default_rng(seed)
            if (counts > active_cap).any():
                parts = []
                for e in range(E):
                    seg = starts[e] + rng.permutation(counts[e])
                    zero = w_np[order[seg]] == 0.0
                    if zero.any():
                        seg = seg[np.argsort(zero, kind="stable")]
                    parts.append(seg)
                perm = np.concatenate(parts)
            else:
                perm = np.arange(n)
            order = order[perm]
            active_counts = np.minimum(counts, active_cap)
        else:
            active_counts = counts

        heights = np.array([next_pow2(max(int(c), 1), min_block_rows)
                         for c in active_counts], np.int64)
        buckets: dict[int, list[int]] = {}
        for e, m in enumerate(heights.tolist()):
            buckets.setdefault(m, []).append(e)
        # merge adjacent power-of-two buckets (the smaller padded up) down
        # to ``max_blocks`` shapes, the pair adding the fewest padded slots
        if max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        while len(buckets) > max_blocks:
            sizes = sorted(buckets)
            costs = [len(buckets[sizes[i]]) * (sizes[i + 1] - sizes[i])
                     for i in range(len(sizes) - 1)]
            i = int(np.argmin(costs))
            buckets[sizes[i + 1]] = (buckets.pop(sizes[i])
                                     + buckets[sizes[i + 1]])

        projector_obj = None
        icpt = None
        if projection is not None:
            from photon_tpu_torch.data.matrix import last_column_is_intercept
            from photon_tpu_torch.game.projector import (ProjectorType,
                                                         RandomProjector)

            icpt = _shard_dim(X) - 1 if last_column_is_intercept(X) else None
            if projection.projector is ProjectorType.RANDOM:
                projector_obj = RandomProjector.build(
                    _shard_dim(X), projection.projected_dim,
                    keep_intercept=icpt is not None, seed=projection.seed)

        y, w = np.asarray(data.y, np.float32), w_np
        sparse = isinstance(X, SparseRows)
        blocks = []
        for m in sorted(buckets):
            ents = np.asarray(buckets[m], np.int64)
            # entities in active-row order, so lanes of like cost sit
            # together (entity_index carries the permutation)
            ents = ents[np.argsort(active_counts[ents], kind="stable")]
            st, ct = starts[ents], active_counts[ents]
            pos = np.arange(m)
            mask = pos[None, :] < ct[:, None]  # (E_b, m)
            # padding slots clamp to the entity's first row, weight 0
            idx2d = st[:, None] + np.where(mask, pos[None, :], 0)
            row_idx = order[idx2d]  # (E_b, m) original row positions
            wb = np.where(mask, w[row_idx], 0.0).astype(np.float32)
            yb = y[row_idx].astype(np.float32)
            Xg = _gather_rows(X, row_idx.reshape(-1))
            E_b = len(ents)
            block_dim = block_proj = None
            ind3 = None
            if sparse:
                ind, val = Xg
                k = ind.shape[-1]
                ind3 = ind.reshape(E_b, m, k)
                val3 = (val.reshape(E_b, m, k).astype(np.float32)
                        * mask[..., None]).astype(np.float32)
                if projector_obj is not None:
                    Xd = projector_obj.project_sparse_rows(ind3, val3)
                    block_dim = projector_obj.dim_out
                elif projection is not None:
                    Xd, block_proj = _project_sparse(ind3, val3, icpt)
                    block_dim = block_proj.dim
                else:
                    Xd = None
            else:
                d = Xg.shape[-1]
                Xd = (Xg.reshape(E_b, m, d) * mask[..., None]).astype(
                    np.float32)
                if projector_obj is not None:
                    Xd = projector_obj.project_rows(Xd)
                    block_dim = projector_obj.dim_out
                elif projection is not None:
                    Xd, block_proj = _project_dense(Xd, icpt)
                    block_dim = block_proj.dim
            if Xd is None:  # sparse, unprojected: padded COO lanes
                ti = _lane_minor(ind3.astype(np.int64), dev)
                tv = _lane_minor(val3, dev)
                lanes = EntityBlocks(None, ti, tv, _shard_dim(X))
                Xb = (_entity_major(ti), _entity_major(tv))
            else:
                td = _lane_minor(np.asarray(Xd, np.float32), dev)
                lanes = EntityBlocks(td, None, None, int(td.shape[1]))
                Xb = _entity_major(td)
            blocks.append(REBlock(
                m=m, entity_index=ents.astype(np.int32),
                row_index=_entity_major(_lane_minor(
                    row_idx.astype(np.int64), dev)),
                y=_entity_major(_lane_minor(yb, dev)),
                weights=_entity_major(_lane_minor(wb, dev)),
                X=Xb, lanes=lanes, dim=block_dim, proj=block_proj))

        n_active = int(active_counts.sum())
        return RandomEffectDataset(
            entity_name=entity_name, shard_name=shard_name,
            entity_keys=keys,
            key_to_index={k: i for i, k in enumerate(keys.tolist())},
            blocks=blocks, X=_on_device(X, dev), entity_dense=entity_dense,
            n_active=n_active, n_passive=n - n_active,
            projection=projection, projector=projector_obj)

    def block_batch(self, block: REBlock, offsets_full) -> GLMBatch:
        """The lane-minor batch of one bucket: X its `EntityBlocks`, and
        (m, E) labels, weights and offsets — the offsets gathered from the
        full per-row vector (the other coordinates' scores)."""
        offs = offsets_full
        if not isinstance(offs, torch.Tensor):
            offs = as_tensor(np.asarray(offs, np.float32), block.y.device)
        rows = block.row_index.t()  # (m, E), contiguous
        return GLMBatch(block.lanes, block.y.t(), block.weights.t(),
                        offs.to(torch.float32)[rows])
