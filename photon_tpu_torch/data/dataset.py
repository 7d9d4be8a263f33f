"""Labeled data containers (port of `GLMBatch`, `make_batch`, `pad_batch`,
`with_offsets`, `cast_features`, `total_weight` and the host-chunked
datasets — `ChunkedMatrix`, `ChunkedBatch`, `DeviceChunkRing`,
`chunk_matrix`, `make_chunked_batch`, `chunk_batch`, `chunk_blocked_ell` —
of `photon_tpu/data/dataset.py`).

Reference parity: com.linkedin.photon.ml.data.LabeledPoint (label,
features, offset, weight). A GLMBatch is the whole dataset as tensors on
one device; rows of weight 0 are padding that every reduction ignores.

A `ChunkedBatch` is a dataset too big for device memory: it lives on the
host in uniform row chunks (pinned, when a GPU is present, so an upload
is an asynchronous DMA) and streams through the device one chunk at a
time (`DeviceChunkRing`), so the device holds a couple of chunks plus
solver state; its depth may follow a stall-driven controller
(`data.ingest_plane.AdaptivePrefetch`).

On a mesh (`parallel.mesh.Mesh`) a batch is row-sharded over the slots:
`mesh_batch` lays a resident batch out (X as a `SlotRows`, the scalar
columns as this process's rows), `shard_blocked_ell_batch` builds the
blocked-ELL layout for S shards under one column permutation, and a
`ChunkedBatch` streams every chunk row-sharded over the local slots
(`MeshChunkRing`; a blocked-ELL ladder laid for the mesh by
`chunk_blocked_ell(n_shards=S)`).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch import profiling, telemetry
from photon_tpu_torch.checkpoint.faults import kill_point
from photon_tpu_torch.data.matrix import (BlockedEllRows,
                                          ShardedBlockedEllRows, SparseRows,
                                          as_tensor, shard_blocked_ell)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.parallel.mesh import (SlotRows, _slot_slice,
                                            pad_to_multiple, shard_rows)


class GLMBatch(NamedTuple):
    X: object  # dense (n, d) tensor, SparseRows or BlockedEllRows
    y: torch.Tensor  # (n,)
    weights: torch.Tensor  # (n,) — 0.0 marks padding
    offsets: torch.Tensor  # (n,)

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    def to(self, device) -> "GLMBatch":
        """The same batch with every tensor on ``device`` (a no-op for
        tensors already there)."""
        return GLMBatch(self.X.to(device), self.y.to(device),
                        self.weights.to(device), self.offsets.to(device))


def _f32(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float32)
    return as_tensor(a, device).to(torch.float32)


def make_batch(X, y, weights=None, offsets=None, device=None) -> GLMBatch:
    """A batch on ``device`` (default ``cuda``). A dense X from numpy
    arrives as f32; a floating tensor keeps its storage dtype; layouts
    move as they are. A row-sharded X (`SlotRows`, e.g. from
    `stream_to_device(mesh=...)`) stays on its mesh, and takes its
    columns row-sharded over the same mesh — the weights given (only the
    producer knows which rows are padding), the offsets zero by
    default."""
    if isinstance(X, SlotRows):
        return _slot_batch_of(X, y, weights, offsets)
    dev = resolve_device(device)
    y = _f32(y, dev)
    n = int(y.shape[0])
    if isinstance(X, (SparseRows, BlockedEllRows)):
        X = X.to(dev)
    elif isinstance(X, torch.Tensor) and X.is_floating_point():
        X = X.to(dev)
    else:
        X = as_tensor(np.asarray(X, np.float32), dev)
    weights = (torch.ones(n, dtype=torch.float32, device=dev)
               if weights is None else _f32(weights, dev))
    offsets = (torch.zeros(n, dtype=torch.float32, device=dev)
               if offsets is None else _f32(offsets, dev))
    return GLMBatch(X, y, weights, offsets)


def _slot_batch_of(X: SlotRows, y, weights, offsets) -> GLMBatch:
    if weights is None:
        raise ValueError("a row-sharded batch needs its weights (0 on the "
                         "padding rows its producer added)")
    if offsets is None:
        offsets = SlotRows(X.mesh, tuple(
            torch.zeros(X.rows_per_slot, dtype=torch.float32, device=d)
            for d in X.mesh.slot_devices), X.rows_per_slot)
    for v in (y, weights, offsets):
        if not isinstance(v, SlotRows) or v.mesh is not X.mesh:
            raise ValueError("a row-sharded X takes its scalar columns "
                             "row-sharded over the same mesh")
    return GLMBatch(X, y, weights, offsets)


def pad_batch(batch: GLMBatch, target_n: int) -> GLMBatch:
    """The batch grown to ``target_n`` rows with zero-weight padding rows
    (zero features, label, weight and offset), which every reduction
    ignores — e.g. to a multiple of a mesh's slot count. A
    `BlockedEllRows` grows its hot block, and the new rows' ``row_pos``
    point at the zero slot (no tail)."""
    n = batch.n
    if target_n == n:
        return batch
    if target_n < n:
        raise ValueError(f"cannot pad {n} rows down to {target_n}")
    extra = target_n - n
    X = batch.X
    if isinstance(X, (ShardedBlockedEllRows, SlotRows)):
        raise ValueError(
            "cannot pad a sharded batch (its per-shard layouts are laid "
            "out already); pad before shard_blocked_ell_batch / mesh_batch")

    def grow(t, fill=0):
        pad = torch.full((extra,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=t.device)
        return torch.cat([t, pad])

    if isinstance(X, BlockedEllRows):
        B = sum(int(v.shape[0]) for v in X.ell_vals)
        X = dataclasses.replace(X, dense=grow(X.dense),
                                row_pos=grow(X.row_pos, B))
    elif isinstance(X, SparseRows):
        X = SparseRows(grow(X.indices), grow(X.values), X.n_features)
    else:
        X = grow(X)
    return GLMBatch(X, grow(batch.y), grow(batch.weights),
                    grow(batch.offsets))


def shard_blocked_ell_batch(batch: GLMBatch, n_shards: int,
                            d_dense: int = 1024,
                            device_dense_dtype=None) -> GLMBatch:
    """Pad a `SparseRows` batch to the mesh and re-lay its X, on the host,
    as a `ShardedBlockedEllRows` for ``n_shards`` slots (reference:
    `shard_blocked_ell_batch`): each slot gets its own ELL row buckets and
    occurrence buckets under ONE global column permutation, so a mesh
    solve (`train_glm(mesh=)`, through `mesh_batch`) runs the blocked-ELL
    kernels on every slot's shard and closes each evaluation with one
    reduction. ``device_dense_dtype`` (e.g. ``torch.bfloat16``) recasts
    the hot block's storage."""
    X = batch.X
    if not isinstance(X, SparseRows):
        raise TypeError("shard_blocked_ell_batch expects SparseRows")
    n_pad = pad_to_multiple(batch.n, n_shards)
    host = GLMBatch(SparseRows(_cpu(X.indices), _cpu(X.values),
                               X.n_features),
                    _cpu(batch.y), _cpu(batch.weights), _cpu(batch.offsets))
    host = pad_batch(host, n_pad)
    sb = shard_blocked_ell(host.X, n_shards, d_dense)
    if device_dense_dtype is not None:
        sb = dataclasses.replace(sb, dense=sb.dense.to(device_dense_dtype))
    return host._replace(X=sb)


def mesh_batch(batch: GLMBatch, mesh) -> GLMBatch:
    """The solve form of ``batch`` on ``mesh``: X row-sharded over the
    slots (a `SlotRows`: dense rows, `SparseRows`, or a
    `ShardedBlockedEllRows`' shards as one `BlockedEllRows` per slot),
    rows padded with weight 0 to a multiple of the slot count, and the
    scalar columns as this process's rows, slot-major, on the home
    device — the layout the objective's per-slot row sums and the mesh's
    one reduction per evaluation read. A batch already row-sharded
    (`SlotRows` X, its columns row-sharded or in this solve form) keeps
    its shards. A single-device `BlockedEllRows` cannot be row-sharded
    (its buckets are laid for all rows); build the mesh form with
    `shard_blocked_ell_batch`."""
    X = batch.X
    if isinstance(X, SlotRows):
        if X.mesh is not mesh:
            raise ValueError("the batch is row-sharded over another mesh")
        cols = []
        for c in (batch.y, batch.weights, batch.offsets):
            if isinstance(c, SlotRows):
                c = c.local()
            elif not (isinstance(c, torch.Tensor) and c.device == mesh.home
                      and c.shape[0] == X.n_local_rows):
                raise ValueError("a row-sharded X takes row-sharded scalar "
                                 "columns")
            cols.append(c)
        return GLMBatch(X, *cols)
    if isinstance(X, BlockedEllRows):
        raise ValueError(
            "BlockedEllRows is a single-device representation (its buckets "
            "cannot be row-sharded); use the mesh form "
            "(data.dataset.shard_blocked_ell_batch(batch, "
            f"{mesh.n_slots})) under a mesh")
    if isinstance(X, ShardedBlockedEllRows):
        if X.n_shards != mesh.n_slots:
            raise ValueError(
                f"ShardedBlockedEllRows has {X.n_shards} shards but the "
                f"mesh has {mesh.n_slots} slots; rebuild with "
                f"data.dataset.shard_blocked_ell_batch(batch, "
                f"{mesh.n_slots})")
        n_pad = int(X.dense.shape[0])
        Xs = SlotRows(mesh, tuple(
            X.chunk(j).to(dev)
            for j, dev in zip(mesh.local_slots, mesh.slot_devices)),
            X.n_local)
    else:
        n_pad = pad_to_multiple(batch.n, mesh.n_slots)
        Xs = shard_rows(X, mesh, pad_rows=n_pad)
    return GLMBatch(Xs, *(shard_rows(c, mesh, pad_rows=n_pad).local()
                          for c in (batch.y, batch.weights, batch.offsets)))


def with_offsets(batch: GLMBatch, offsets) -> GLMBatch:
    """The batch with new (n,) offsets (f32, on the batch's device)."""
    return batch._replace(offsets=_f32(offsets, batch.y.device))


def total_weight(batch: GLMBatch) -> float:
    return float(np.sum(batch.weights.cpu().numpy()))


def cast_features(batch: GLMBatch, dtype=torch.bfloat16) -> GLMBatch:
    """Recast feature STORAGE (dense X, SparseRows values, or every value
    leaf of a BlockedEllRows) — typically to bf16. The X passes then
    multiply in that dtype and accumulate in f32; labels, weights,
    offsets and all solver state stay f32."""
    X = batch.X
    if isinstance(X, (BlockedEllRows, ShardedBlockedEllRows)):
        X = X.astype(dtype)
    elif isinstance(X, SparseRows):
        X = SparseRows(X.indices, X.values.to(dtype), X.n_features)
    else:
        X = X.to(dtype)
    return batch._replace(X=X)


# --------------------------------------------------------------------------
# Host-resident chunked datasets (the out-of-device-memory streamed regime).
#
# Reference parity: in a DistributedGLMLossFunction solve the dataset never
# lives in one executor's memory; Spark partitions stream through each
# treeAggregate. Here the dataset lives on the host in uniform row chunks
# and streams through the device chunk by chunk.


def _pin(t: torch.Tensor) -> torch.Tensor:
    """``t`` in page-locked host memory when a GPU is present (a copy from
    pageable memory is synchronous and cannot overlap compute); as it is
    otherwise, or when it is pinned already."""
    if not torch.cuda.is_available() or t.is_pinned():
        return t
    return t.pin_memory()


def _cpu(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


def _map_leaves(X, fn):
    """``X`` (a dense tensor, `SparseRows`, `BlockedEllRows` or a mesh
    ladder's `ShardedBlockedEllRows`) with ``fn`` applied to each
    per-chunk tensor (the column permutation, shared by every chunk of a
    ladder, kept as it is)."""
    if isinstance(X, ShardedBlockedEllRows):
        return dataclasses.replace(
            X, dense=fn(X.dense), ell_pcols=tuple(map(fn, X.ell_pcols)),
            ell_vals=tuple(map(fn, X.ell_vals)), row_pos=fn(X.row_pos),
            bucket_rows=tuple(map(fn, X.bucket_rows)),
            bucket_vals=tuple(map(fn, X.bucket_vals)))
    if isinstance(X, BlockedEllRows):
        return dataclasses.replace(
            X, dense=fn(X.dense), ell_pcols=tuple(map(fn, X.ell_pcols)),
            ell_vals=tuple(map(fn, X.ell_vals)), row_pos=fn(X.row_pos),
            bucket_rows=tuple(map(fn, X.bucket_rows)),
            bucket_vals=tuple(map(fn, X.bucket_vals)),
            tail_rows=None if X.tail_rows is None else fn(X.tail_rows))
    if isinstance(X, SparseRows):
        return SparseRows(fn(X.indices), fn(X.values), X.n_features)
    return fn(X)


def _leaves(X) -> list:
    """The per-chunk tensors of ``X``, in `_map_leaves` order."""
    out = []
    _map_leaves(X, lambda t: out.append(t) or t)
    return out


@dataclasses.dataclass(frozen=True)
class ChunkedMatrix:
    """A design matrix as HOST-resident uniform row chunks (reference:
    `photon_tpu.data.dataset.ChunkedMatrix`).

    ``chunks`` are CPU (c, d) tensors, `SparseRows` of CPU tensors with a
    shared slot count, or CPU `BlockedEllRows` cut from ONE
    `shard_blocked_ell` ladder (`chunk_blocked_ell`): every chunk the same
    shape, so the device buffers and the kernels' plans of one chunk serve
    every chunk. The LAST chunk is padded with all-zero rows up to the
    chunk height (``n_real`` marks where real rows end; the owning
    `ChunkedBatch` gives pad rows weight 0). Blocked-ELL chunks carry the
    ladder's GLOBAL column permutation in ``perm_cols`` / ``inv_perm`` /
    ``last_col_pos``: chunk partials then sum in one permuted (d,) space,
    and `models.training` translates at its public boundary. The builders
    pin the chunks (when a GPU is present), once, so every upload is an
    asynchronous copy; a chunk given unpinned still uploads, each time
    synchronously."""

    chunks: tuple
    n_real: int
    n_features: int
    perm_cols: Optional[torch.Tensor] = None   # (d,) int32, ladders only
    inv_perm: Optional[torch.Tensor] = None    # (d,) int32, ladders only
    last_col_pos: Optional[int] = None

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def permuted(self) -> bool:
        return self.perm_cols is not None

    @property
    def chunk_rows(self) -> int:
        c = self.chunks[0]
        return int((c.indices if isinstance(c, SparseRows) else c).shape[0])

    @property
    def n_padded(self) -> int:
        return self.n_chunks * self.chunk_rows

    @property
    def chunk_shards(self) -> int:
        """Mesh slots each chunk was laid for: >1 iff the chunks are
        `ShardedBlockedEllRows` groups of a mesh ladder
        (`chunk_blocked_ell(..., n_shards=S)`), else 1."""
        c = self.chunks[0]
        return c.n_shards if isinstance(c, ShardedBlockedEllRows) else 1

    @property
    def shape(self) -> tuple:
        return (self.n_real, self.n_features)

    def chunk_nbytes(self) -> int:
        """Bytes of one chunk's per-chunk tensors (what one upload of its
        features moves)."""
        return sum(t.numel() * t.element_size()
                   for t in _leaves(self.chunks[0]))

    def nbytes(self) -> int:
        return self.n_chunks * self.chunk_nbytes()


class ChunkedBatch(NamedTuple):
    """A GLMBatch-shaped dataset living on the HOST as uniform chunks
    (reference: `photon_tpu.data.dataset.ChunkedBatch`). The scalar
    columns are full (n_padded,) numpy f32 vectors; `chunk` slices out one
    host GLMBatch, `device_ring` and `iter_device` stream device chunks.
    `models.training.train_glm` dispatches a ChunkedBatch to the streamed
    solvers."""

    X: ChunkedMatrix
    y: np.ndarray  # (n_padded,)
    weights: np.ndarray  # (n_padded,) — 0.0 marks padding
    offsets: np.ndarray  # (n_padded,)

    @property
    def n(self) -> int:
        return self.X.n_real

    @property
    def n_chunks(self) -> int:
        return self.X.n_chunks

    @property
    def chunk_rows(self) -> int:
        return self.X.chunk_rows

    def chunk(self, i: int) -> GLMBatch:
        """Chunk ``i`` as a host GLMBatch (CPU tensors; the scalar columns
        are views of this batch's)."""
        c = self.X.chunk_rows
        sl = slice(i * c, (i + 1) * c)
        return GLMBatch(self.X.chunks[i], torch.from_numpy(self.y[sl]),
                        torch.from_numpy(self.weights[sl]),
                        torch.from_numpy(self.offsets[sl]))

    def mesh_chunk_rows(self, mesh) -> int:
        """Per-chunk row count after padding to the mesh (every chunk pads
        to the same height)."""
        return pad_to_multiple(self.X.chunk_rows, mesh.n_slots)

    def _check_mesh(self, mesh) -> None:
        cs = self.X.chunk_shards
        if cs > 1 and cs != mesh.n_slots:
            raise ValueError(
                f"blocked-ELL chunk ladder was laid for {cs} slot(s) but "
                f"the mesh has {mesh.n_slots}; rebuild with data.dataset."
                f"chunk_blocked_ell(batch, chunk_rows, "
                f"n_shards={mesh.n_slots})")
        if cs == 1 and self.X.permuted:
            raise ValueError(
                "this blocked-ELL chunk ladder was laid for ONE device per "
                "chunk and cannot row-shard over a mesh; rebuild it for the "
                "mesh with data.dataset.chunk_blocked_ell(batch, chunk_rows, "
                f"n_shards={mesh.n_slots}), or stream SparseRows chunks")

    def slot_batch(self, mesh, slot: int) -> "ChunkedBatch":
        """Global slot ``slot``'s rows of every chunk as a ChunkedBatch of
        its own — rows ``[slot·s, (slot+1)·s)`` of each chunk padded to
        `mesh_chunk_rows` (pad rows weight 0), or shard ``slot`` of each
        mesh-ladder chunk: the per-slot stream `MeshChunkRing` uploads
        onto the slot's device. Views where the rows divide evenly."""
        self._check_mesh(mesh)
        c = self.X.chunk_rows
        s = self.mesh_chunk_rows(mesh) // mesh.n_slots
        if self.X.chunk_shards > 1:
            chunks = tuple(_map_leaves(ch.chunk(slot), _pin)
                           for ch in self.X.chunks)
        else:
            chunks = tuple(_map_leaves(
                ch, lambda t: _pin(_slot_slice(t, slot, s, c).contiguous()))
                for ch in self.X.chunks)

        def col(v):
            v = torch.from_numpy(np.ascontiguousarray(v))
            return np.concatenate([
                _slot_slice(v[i * c:(i + 1) * c], slot, s, c).numpy()
                for i in range(self.n_chunks)])

        X = dataclasses.replace(self.X, chunks=chunks,
                                n_real=self.n_chunks * s)
        return ChunkedBatch(X, col(self.y), col(self.weights),
                            col(self.offsets))

    def mesh_chunk(self, i: int, mesh, _cache=None) -> GLMBatch:
        """Chunk ``i`` row-sharded over the mesh (`SlotRows` X and scalar
        columns, this process's slots only; pad rows weight 0) — one
        upload, no ring (the streamed solvers use `device_ring`)."""
        self._check_mesh(mesh)
        pad = self.mesh_chunk_rows(mesh)
        X = self.X.chunks[i]
        if isinstance(X, ShardedBlockedEllRows):
            Xs = mesh_chunk_matrix(X, mesh, _cache)
        else:
            Xs = shard_rows(X, mesh, pad_rows=pad)
        c = self.X.chunk_rows
        sl = slice(i * c, (i + 1) * c)
        return GLMBatch(Xs, *(shard_rows(v[sl], mesh, pad_rows=pad)
                              for v in (self.y, self.weights, self.offsets)))

    def iter_device(self, device=None, mesh=None, prefetch=2):
        """Yield (i, device GLMBatch) for one pass, ``prefetch`` chunks in
        flight (the one-pass form of `device_ring`: nothing is uploaded
        past the last chunk). Each yielded chunk is valid until the
        caller asks for the next ``prefetch`` - 1 chunks. With ``mesh``,
        each yield is the chunk as one device batch per local slot."""
        if mesh is not None:
            yield from MeshChunkRing(self, mesh, prefetch).stream_pass(
                prime=False)
            return
        ring = DeviceChunkRing(self, device=device, prefetch=prefetch)
        yield from ring.stream_pass(prime=False)

    def device_ring(self, device=None, mesh=None, prefetch=2):
        """A persistent cross-pass upload ring over this dataset's chunks
        (see `DeviceChunkRing`; `MeshChunkRing` with ``mesh``), the
        streamed solvers' regime."""
        if mesh is not None:
            return MeshChunkRing(self, mesh, prefetch)
        return DeviceChunkRing(self, device=device, prefetch=prefetch)


class DeviceChunkRing:
    """A persistent upload ring over one `ChunkedBatch` (reference:
    `photon_tpu.data.dataset.DeviceChunkRing`): ``prefetch`` (default 2)
    chunks in flight, within a pass and into the next one, so the first
    chunks of pass p+1 upload while the caller closes pass p.

    The ring owns ``prefetch`` SLOTS, each a device batch of one chunk's
    shapes allocated once; a chunk uploads into the next slot in turn.
    The consumer therefore sees the same few device objects again and
    again, so the kernels' per-layout plans (`kernels.blocked_ell.
    layout_plan`) are built once per slot, never per chunk visit, and the
    device holds ``prefetch`` chunks whatever the dataset's size. A
    yielded chunk is valid until the consumer has asked for ``prefetch``
    - 1 more.

    On a GPU the uploads run on a side stream from pinned host memory:
    the side stream waits for the compute stream's last use of a slot
    before it writes the slot again (an event recorded when the consumer
    asks for the next chunk), the compute stream waits for a chunk's
    upload event before its first op on it, and the slot tensors, made on
    the compute stream, are registered with the side stream
    (``record_stream``). The host waits for each upload before it yields
    (the stall the pass reports). On the CPU an upload is a copy into the
    slot.

    `stream_pass` yields ``(i, chunk)`` in order and keeps the reference's
    counters in `telemetry`: ``stream.passes``, ``stream.chunk_uploads``,
    ``stream.stall_seconds``, ``stream.compute_seconds``,
    ``stream.prefetch_depth`` (a gauge) and ``stream.stalled_passes``. A
    pass abandoned part way resets the ring: the next starts at chunk 0
    with nothing stale in flight.

    ``prefetch`` is an int, or a stall-driven controller
    (`data.ingest_plane.AdaptivePrefetch`): each pass then runs at the
    controller's depth, and the pass's stall and compute seconds feed its
    `observe` at the pass's end. When it widens, the ring adds slots (the
    controller caps the depth at its byte budget over one chunk's bytes);
    when it narrows, the window drains to the new depth. An upload takes
    a slot that is neither in flight nor held, so results are bit for bit
    the same at every depth. ``_quiet`` (a `MeshChunkRing`'s per-slot
    rings) leaves the fault site, the counters and the controller's
    `observe` to the owner."""

    def __init__(self, batch: ChunkedBatch, device=None, prefetch=2,
                 _quiet: bool = False):
        self.batch = batch
        self._quiet = _quiet
        self._ctl = prefetch if hasattr(prefetch, "observe") else None
        self._static = 2 if self._ctl is not None else max(int(prefetch), 1)
        self.device = resolve_device(device)
        c0 = batch.X.chunks[0]
        if isinstance(c0, ShardedBlockedEllRows):
            raise ValueError(
                f"this blocked-ELL chunk ladder was laid for a "
                f"{c0.n_shards}-slot mesh (chunk_blocked_ell(n_shards=...)); "
                "stream it over the mesh (device_ring(mesh=...)), or rebuild "
                "with n_shards=1 for one device")
        if isinstance(c0, BlockedEllRows) and c0.tail_rows is None:
            raise ValueError(
                "blocked-ELL chunks need their inverse map tail_rows (a "
                "ladder's chunks are padded, so row_pos alone does not give "
                "it); build them with chunk_blocked_ell")
        self._cuda = self.device.type == "cuda"
        pin = _pin if self._cuda else (lambda t: t)
        # the scalar columns, pinned once per ring (12 bytes a row)
        self._cols = [pin(torch.from_numpy(np.ascontiguousarray(v)))
                      for v in (batch.y, batch.weights, batch.offsets)]
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._shared = None  # a ladder's permutation on the device, once
        self._slots: list = []
        self._free: dict = {}  # slot -> event of the consumer's last use
        self._window: deque = deque()
        self._next = 0       # chunk index the next upload takes (mod n)

    @property
    def depth(self) -> int:
        """Chunks in flight: the controller's current depth, or the int."""
        return (max(int(self._ctl.depth), 1) if self._ctl is not None
                else self._static)

    def host_columns(self, i: int) -> list:
        """Chunk ``i``'s (y, weights, offsets) on the host (pinned on a
        GPU)."""
        c = self.batch.chunk_rows
        return [col[i * c:(i + 1) * c] for col in self._cols]

    def _new_slot(self) -> GLMBatch:
        c0 = self.batch.X.chunks[0]
        dev = self.device

        def empty(t):
            out = torch.empty(t.shape, dtype=t.dtype, device=dev)
            if self._cuda:
                out.record_stream(self._side)
            return out

        X = _map_leaves(c0, empty)
        if isinstance(X, BlockedEllRows):
            if self._shared is None:
                self._shared = (c0.perm_cols.to(dev), c0.inv_perm.to(dev))
            X = dataclasses.replace(X, perm_cols=self._shared[0],
                                    inv_perm=self._shared[1])
        c = self.batch.chunk_rows
        cols = [torch.empty(c, dtype=torch.float32, device=dev)
                for _ in range(3)]
        for t in cols:
            if self._cuda:
                t.record_stream(self._side)
        return GLMBatch(X, *cols)

    def _upload(self, i: int, s: int):
        """Chunk ``i`` into slot ``s``; the upload's event (None on the
        CPU)."""
        while len(self._slots) <= s:
            self._slots.append(self._new_slot())
        slot = self._slots[s]
        if isinstance(slot.X, SparseRows):
            # a `SparseRows` Xᵀr plans from the slot's contents, which this
            # upload replaces: the next pass over the slot plans anew
            object.__setattr__(slot.X, "plan", None)
        src = _leaves(self.batch.X.chunks[i]) + self.host_columns(i)
        dst = _leaves(slot.X) + [slot.y, slot.weights, slot.offsets]
        if not self._cuda:
            for d_, s_ in zip(dst, src):
                d_.copy_(s_)
            return None
        with torch.cuda.stream(self._side):
            if self._free.get(s) is not None:
                self._side.wait_event(self._free[s])
            for d_, s_ in zip(dst, src):
                d_.copy_(s_, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        return ev

    def _fill(self, cap: int) -> None:
        """Issue uploads until ``cap`` chunks are in flight, each into the
        lowest slot not in flight (the chunk the consumer held is released
        before a fill), so a fixed depth cycles through the same slots."""
        n = self.batch.n_chunks
        while len(self._window) < cap:
            busy = {s for _, s, _ in self._window}
            s = next(j for j in range(len(self._slots) + 1) if j not in busy)
            self._window.append((self._next, s, self._upload(self._next, s)))
            self._next = (self._next + 1) % n

    def _release(self, s: int) -> None:
        """The consumer is done issuing work on slot ``s``."""
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._free[s] = ev

    def stream_pass(self, prime: bool = True):
        """One pass: yield (i, device chunk) for every chunk, keeping the
        upload window full, past the last chunk into the next pass when
        ``prime``."""
        n = self.batch.n_chunks
        if n == 0:
            return
        depth = self.depth
        stall = 0.0
        t_start = time.perf_counter()
        ok = False
        held = None
        try:
            for i in range(n):
                # one-pass mode uploads nothing past the last chunk
                self._fill(min(depth, n) if prime else min(depth, n - i))
                _, held, ev = self._window.popleft()
                # fault site: a preemption mid-upload-stream (one hit per
                # consumed chunk, in `iter_device`'s passes too)
                if not self._quiet:
                    kill_point("chunk_upload")
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                    torch.cuda.current_stream(self.device).wait_event(ev)
                stall += time.perf_counter() - t0
                yield i, self._slots[held]
                self._release(held)
                held = None
            if prime:
                self._fill(min(depth, n))
            else:
                self._next = 0
            ok = True
        finally:
            if held is not None:
                self._release(held)
            if not ok:
                # abandoned part way: drop what is in flight, so the next
                # pass starts clean at chunk 0
                self._window.clear()
                self._next = 0
            if not self._quiet:
                _pass_done(self._ctl, ok, stall,
                           (time.perf_counter() - t_start) - stall, n, depth,
                           self.batch.X.chunk_nbytes())


def _pass_done(ctl, ok: bool, stall: float, compute: float, n: int,
               depth: int, chunk_nbytes: int) -> None:
    """A ring pass's counters, its attribution to an armed `profiling`
    ledger (``ingest.upload`` the stall, ``solve.compute`` the rest), its
    controller's `observe` (a whole pass only) and the stall log line."""
    telemetry.count("stream.passes")
    telemetry.count("stream.chunk_uploads", n)
    telemetry.count("stream.stall_seconds", stall)
    telemetry.count("stream.compute_seconds", max(compute, 0.0))
    telemetry.gauge("stream.prefetch_depth", depth)
    profiling.attribute("ingest.upload", "upload", max(stall, 0.0))
    profiling.attribute("solve.compute", "compute", max(compute, 0.0))
    if ok and ctl is not None:
        ctl.observe(stall, max(compute, 0.0), n, chunk_nbytes)
    _log_stream_stall(stall, compute, n, depth)


class MeshChunkRing:
    """The upload ring of a mesh stream: one `DeviceChunkRing` per LOCAL
    slot, over that slot's rows of every chunk (`ChunkedBatch.
    slot_batch`), onto the slot's device. A ring slot thus holds one
    chunk row-sharded over the local slots, and the kernels' plans are
    built once per (ring slot, mesh slot), never per upload.
    `stream_pass` yields ``(i, [device chunk per local slot])`` with one
    ``chunk_upload`` fault site per chunk and the single ring's counters
    (its stall the waits for all slots' uploads)."""

    def __init__(self, batch: ChunkedBatch, mesh, prefetch=2):
        self.batch, self.mesh = batch, mesh
        self._ctl = prefetch if hasattr(prefetch, "observe") else None
        self.rings = [DeviceChunkRing(batch.slot_batch(mesh, j), device=dev,
                                      prefetch=prefetch, _quiet=True)
                      for j, dev in zip(mesh.local_slots, mesh.slot_devices)]

    @property
    def depth(self) -> int:
        return self.rings[0].depth

    def host_columns(self, k: int, i: int) -> list:
        """Local slot ``k``'s (y, weights, offsets) rows of chunk ``i``."""
        return self.rings[k].host_columns(i)

    def stream_pass(self, prime: bool = True):
        n = self.batch.n_chunks
        if n == 0:
            return
        depth = self.depth
        gens = [r.stream_pass(prime) for r in self.rings]
        stall, ok = 0.0, False
        t_start = time.perf_counter()
        try:
            for i in range(n):
                t0 = time.perf_counter()
                chunk = [next(g)[1] for g in gens]
                stall += time.perf_counter() - t0
                kill_point("chunk_upload")
                yield i, chunk
            for g in gens:  # each ring primes its next pass
                next(g, None)
            ok = True
        finally:
            for g in gens:
                g.close()
            _pass_done(self._ctl, ok, stall,
                       (time.perf_counter() - t_start) - stall, n, depth,
                       self.batch.X.chunk_nbytes())


def mesh_chunk_matrix(X, mesh, _cache=None) -> SlotRows:
    """One mesh-ladder chunk (a host `ShardedBlockedEllRows`) onto the
    mesh: shard ``j`` to local slot ``j`` as a `BlockedEllRows` on its
    device, the ladder's one column permutation uploaded once per device
    (``_cache``: a dict kept across the chunks of a pass)."""
    if not isinstance(X, ShardedBlockedEllRows):
        raise TypeError("mesh_chunk_matrix expects ShardedBlockedEllRows")
    if X.n_shards != mesh.n_slots:
        raise ValueError(
            f"blocked-ELL chunk ladder was laid for {X.n_shards} slot(s) "
            f"but the mesh has {mesh.n_slots}; rebuild with data.dataset."
            f"chunk_blocked_ell(batch, chunk_rows, n_shards={mesh.n_slots})")
    cache = {} if _cache is None else _cache
    parts = []
    for j, dev in zip(mesh.local_slots, mesh.slot_devices):
        if dev not in cache:
            cache[dev] = (X.perm_cols.to(dev), X.inv_perm.to(dev))
        b = _map_leaves(X.chunk(j), lambda t, d=dev: t.to(d))
        parts.append(dataclasses.replace(b, perm_cols=cache[dev][0],
                                         inv_perm=cache[dev][1]))
    return SlotRows(mesh, tuple(parts), X.n_local)


def _log_stream_stall(stall: float, compute: float, n_chunks: int,
                      prefetch: int) -> None:
    """One INFO line (and a ``stream.stalled_passes`` count) per pass whose
    upload stalls exceed its compute: the sign that a deeper prefetch or
    bigger chunks would overlap the host link better."""
    if n_chunks > 1 and stall > compute:
        telemetry.count("stream.stalled_passes")
        logging.getLogger("photon_tpu_torch.streamed").info(
            "chunk upload outpaced compute: stalled %.3fs on transfers vs "
            "%.3fs compute over %d chunks (prefetch=%d) — a deeper "
            "prefetch or bigger chunks would overlap better",
            stall, compute, n_chunks, prefetch)


def _host_sparse(X: SparseRows) -> SparseRows:
    return SparseRows(_cpu(X.indices), _cpu(X.values), X.n_features)


def chunk_matrix(X, chunk_rows: int) -> ChunkedMatrix:
    """Split a dense matrix (numpy or tensor; a floating tensor keeps its
    dtype, anything else arrives as f32) or a `SparseRows` into a host
    ChunkedMatrix, the last chunk zero-padded to the uniform height;
    chunks are pinned when a GPU is present."""
    if isinstance(X, BlockedEllRows):
        raise TypeError(
            "BlockedEllRows cannot be host-chunked (a device-locality "
            "layout); chunk the SparseRows form instead — or use "
            "chunk_blocked_ell to build a blocked-ELL chunk ladder from "
            "SparseRows")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    sparse = isinstance(X, SparseRows)
    if sparse:
        X = _host_sparse(X)
        n, d = int(X.indices.shape[0]), X.n_features
    else:
        X = _cpu(X)
        if not X.is_floating_point():
            X = X.to(torch.float32)
        n, d = (int(s) for s in X.shape)

    def cut(t, lo, hi):
        blk = t[lo:hi]
        pad = chunk_rows - (hi - lo)
        if pad:
            blk = torch.cat([blk, blk.new_zeros((pad,) + tuple(t.shape[1:]))])
        return _pin(blk.contiguous())

    chunks = []
    for lo in range(0, max(n, 1), chunk_rows):
        hi = min(lo + chunk_rows, n)
        if sparse:
            chunks.append(SparseRows(cut(X.indices, lo, hi),
                                     cut(X.values, lo, hi), d))
        else:
            chunks.append(cut(X, lo, hi))
    return ChunkedMatrix(tuple(chunks), n, d)


def make_chunked_batch(X: ChunkedMatrix, y, weights=None,
                       offsets=None) -> ChunkedBatch:
    """Assemble a ChunkedBatch from a ChunkedMatrix and (n_real,) or
    (n_padded,) scalar columns (tensors are fetched to the host; padding
    rows get weight 0)."""
    n, n_pad = X.n_real, X.n_padded

    def col(v, fill):
        if v is None:
            return np.full(n_pad, fill, np.float32)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float32)
        if v.shape[0] == n_pad:
            return v
        if v.shape[0] != n:
            raise ValueError(
                f"scalar column has {v.shape[0]} rows; matrix has {n}")
        return np.concatenate([v, np.zeros(n_pad - n, np.float32)])

    y = col(y, 0.0)
    weights = col(weights, 1.0)
    if n_pad > n:
        weights = weights.copy()
        weights[n:] = 0.0  # padding must never enter a reduction
    return ChunkedBatch(X, y, weights, col(offsets, 0.0))


def chunk_batch(batch: GLMBatch, chunk_rows: int) -> ChunkedBatch:
    """Re-lay a GLMBatch (dense X or `SparseRows`, on any device) as a
    host ChunkedBatch: the seam for streamed-against-resident parity."""
    return make_chunked_batch(chunk_matrix(batch.X, chunk_rows), batch.y,
                              batch.weights, batch.offsets)


def chunk_blocked_ell(batch: GLMBatch, chunk_rows: int, d_dense: int = 1024,
                      feature_dtype=None, n_shards: int = 1) -> ChunkedBatch:
    """Re-lay a `SparseRows` batch as a HOST blocked-ELL chunk ladder
    (reference: `photon_tpu.data.dataset.chunk_blocked_ell`): one
    `shard_blocked_ell` pass with S = n_chunks builds a GLOBAL column
    permutation and per-chunk structures padded to COMMON shapes, each
    chunk with its inverse map ``tail_rows``. `train_glm` on the result
    runs the streamed solvers and translates the permutation at its
    boundary. ``feature_dtype`` (e.g. ``torch.bfloat16``) recasts every
    chunk's values after the build (half the feature bytes a pass
    uploads; f32 accumulation unchanged). Chunks are pinned when a GPU is
    present.

    ``n_shards > 1`` lays the ladder for a mesh of that many slots: the
    builder runs with S = n_chunks × n_shards and each chunk is the
    `ShardedBlockedEllRows` group of its ``n_shards`` consecutive shards,
    so every chunk row-shards over the mesh (`MeshChunkRing`) with
    per-slot buckets under ONE global permutation. ``chunk_rows`` must be
    a multiple of ``n_shards``."""
    X = batch.X
    if not isinstance(X, SparseRows):
        raise TypeError("chunk_blocked_ell expects SparseRows")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if chunk_rows % n_shards:
        raise ValueError(
            f"chunk_rows={chunk_rows} must be a multiple of "
            f"n_shards={n_shards} (every slot streams an equal row slice "
            "of every chunk)")
    n = batch.n
    n_pad = -(-max(n, 1) // chunk_rows) * chunk_rows
    ind = _cpu(X.indices).numpy()
    val = _cpu(X.values).to(torch.float32).numpy()
    if n_pad > n:
        k = ind.shape[1]
        ind = np.concatenate([ind, np.zeros((n_pad - n, k), ind.dtype)])
        val = np.concatenate([val, np.zeros((n_pad - n, k), val.dtype)])
    n_chunks = n_pad // chunk_rows
    ladder = shard_blocked_ell(SparseRows(ind, val, X.n_features),
                               n_chunks * n_shards, d_dense)

    def finish(t):
        if feature_dtype is not None and t.is_floating_point():
            t = t.to(feature_dtype)
        return _pin(t.contiguous())

    if n_shards == 1:
        chunks = tuple(_map_leaves(ladder.chunk(i), finish)
                       for i in range(n_chunks))
    else:
        chunks = tuple(_map_leaves(ladder.shard_slice(i * n_shards,
                                                      (i + 1) * n_shards),
                                   finish)
                       for i in range(n_chunks))
    cm = ChunkedMatrix(chunks, n, X.n_features,
                       perm_cols=ladder.perm_cols, inv_perm=ladder.inv_perm,
                       last_col_pos=ladder.last_col_pos)
    return make_chunked_batch(cm, batch.y, batch.weights, batch.offsets)
