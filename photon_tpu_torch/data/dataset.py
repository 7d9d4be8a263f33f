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
(`data.ingest_plane.AdaptivePrefetch`). Its mesh form waits for ROADMAP
queue A item 10.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint.faults import kill_point
from photon_tpu_torch.data.matrix import (BlockedEllRows, SparseRows,
                                          as_tensor, shard_blocked_ell)
from photon_tpu_torch.device import resolve_device


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
    move as they are."""
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


def pad_batch(batch: GLMBatch, target_n: int) -> GLMBatch:
    """The batch grown to ``target_n`` rows with zero-weight padding rows
    (zero features, label, weight and offset), which every reduction
    ignores. A `BlockedEllRows` grows its hot block, and the new rows'
    ``row_pos`` point at the zero slot (no tail)."""
    n = batch.n
    if target_n == n:
        return batch
    if target_n < n:
        raise ValueError(f"cannot pad {n} rows down to {target_n}")
    extra = target_n - n
    X = batch.X

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
    if isinstance(X, BlockedEllRows):
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


def _mesh_not_ported(what: str):
    return NotImplementedError(
        f"{what}: mesh (multi-device) chunk streams are not ported yet "
        "(ROADMAP queue A item 10)")


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
    """``X`` (a dense tensor, `SparseRows` or `BlockedEllRows`) with ``fn``
    applied to each per-chunk tensor (the column permutation, shared by
    every chunk of a ladder, kept as it is)."""
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

    def mesh_chunk(self, i: int, mesh, _cache=None):
        raise _mesh_not_ported("ChunkedBatch.mesh_chunk")

    def iter_device(self, device=None, mesh=None, prefetch=2):
        """Yield (i, device GLMBatch) for one pass, ``prefetch`` chunks in
        flight (the one-pass form of `device_ring`: nothing is uploaded
        past the last chunk). Each yielded chunk is valid until the
        caller asks for the next ``prefetch`` - 1 chunks."""
        if mesh is not None:
            raise _mesh_not_ported("ChunkedBatch.iter_device(mesh=...)")
        ring = DeviceChunkRing(self, device=device, prefetch=prefetch)
        yield from ring.stream_pass(prime=False)

    def device_ring(self, device=None, mesh=None,
                    prefetch=2) -> "DeviceChunkRing":
        """A persistent cross-pass upload ring over this dataset's chunks
        (see `DeviceChunkRing`), the streamed solvers' regime."""
        if mesh is not None:
            raise _mesh_not_ported("ChunkedBatch.device_ring(mesh=...)")
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
    the same at every depth."""

    def __init__(self, batch: ChunkedBatch, device=None, prefetch=2):
        self.batch = batch
        self._ctl = prefetch if hasattr(prefetch, "observe") else None
        self._static = 2 if self._ctl is not None else max(int(prefetch), 1)
        self.device = resolve_device(device)
        c0 = batch.X.chunks[0]
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
            compute = (time.perf_counter() - t_start) - stall
            telemetry.count("stream.passes")
            telemetry.count("stream.chunk_uploads", n)
            telemetry.count("stream.stall_seconds", stall)
            telemetry.count("stream.compute_seconds", max(compute, 0.0))
            telemetry.gauge("stream.prefetch_depth", depth)
            if ok and self._ctl is not None:
                self._ctl.observe(stall, max(compute, 0.0), n,
                                  self.batch.X.chunk_nbytes())
            _log_stream_stall(stall, compute, n, depth)


def mesh_chunk_matrix(X, mesh, _cache=None):
    raise _mesh_not_ported("mesh_chunk_matrix")


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
    present. ``n_shards > 1`` (a ladder laid for a mesh) waits for ROADMAP
    queue A item 10."""
    X = batch.X
    if not isinstance(X, SparseRows):
        raise TypeError("chunk_blocked_ell expects SparseRows")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > 1:
        raise _mesh_not_ported(f"chunk_blocked_ell(n_shards={n_shards})")
    n = batch.n
    n_pad = -(-max(n, 1) // chunk_rows) * chunk_rows
    ind = _cpu(X.indices).numpy()
    val = _cpu(X.values).to(torch.float32).numpy()
    if n_pad > n:
        k = ind.shape[1]
        ind = np.concatenate([ind, np.zeros((n_pad - n, k), ind.dtype)])
        val = np.concatenate([val, np.zeros((n_pad - n, k), val.dtype)])
    ladder = shard_blocked_ell(SparseRows(ind, val, X.n_features),
                               n_pad // chunk_rows, d_dense)

    def finish(t):
        if feature_dtype is not None and t.is_floating_point():
            t = t.to(feature_dtype)
        return _pin(t.contiguous())

    chunks = tuple(_map_leaves(ladder.chunk(i), finish)
                   for i in range(n_pad // chunk_rows))
    cm = ChunkedMatrix(chunks, n, X.n_features,
                       perm_cols=ladder.perm_cols, inv_perm=ladder.inv_perm,
                       last_col_pos=ladder.last_col_pos)
    return make_chunked_batch(cm, batch.y, batch.weights, batch.offsets)
