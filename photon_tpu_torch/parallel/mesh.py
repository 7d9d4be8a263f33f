"""Device meshes on torch: S device slots split over P processes, the
process-count-invariant slot reduction, and row sharding (port of
`photon_tpu/parallel/mesh.py`).

The reference shards examples over a `jax.sharding.Mesh` and lets XLA
place one `psum` per evaluation (the analogue of photon-ml's
`treeAggregate`). Here a :class:`Mesh` is ``S`` device SLOTS: global slot
``j`` owns rows ``[j·s, (j+1)·s)`` of every row-sharded array, and each of
the ``P`` processes owns the contiguous slots ``[p·S/P, (p+1)·S/P)``.
Several slots may share one card (the counterpart of the reference's
8-device CPU mesh); an in-process mesh puts slot ``i`` on
``cuda:(i·count // S)``.

THE REDUCTION (:func:`psum`). Neither NCCL's nor gloo's ``all_reduce``
fixes its summation order independently of the world size, so the mesh
fixes it itself: the S slot partials are summed by a pairwise tree over
slot order — each process sums the subtree of its own contiguous slots,
the P process partials are ``all_gather``ed (ONE collective), and every
rank finishes the same tree in rank order. When each process's S/P
slots are a power of two, its subtree is a subtree of the global tree,
every addition is the same f32 addition at every P, and the same mesh
split over 1, 2 or 4 processes gives the same bits; the in-process mesh
(P = 1) runs the same code. Any other split (S = 6 over 2 processes: 3
slots each) would sum in another order than the in-process tree, so
`make_mesh` and `parallel.launch` refuse it (`check_slot_split`).
Counters: ``mesh.reductions`` (one per call), ``mesh.collectives`` and
``mesh.wire_bytes`` (what this rank sends on the wire) when P > 1.

THE REPLICA × DATA MESH (`make_hybrid_mesh`, the reference's DCN × ICI
layout): the same S slots seen as R replicas of D slots each,
replica-major (slot ``r·D + i`` is replica r's i-th slot). Its whole-mesh
`psum` is the flat slot tree, which with D a power of two is a tree of
per-replica subtrees.

BACKENDS. CPU tensors reduce over gloo; CUDA with a card per process over
NCCL; several processes sharing one card over gloo with host copies of
the partials (the caller names it: ``backend="gloo"``; the compute stays
on the card). Asking for NCCL with more processes on this host than it
has cards raises (the host's process count: torchrun's
``LOCAL_WORLD_SIZE``, else the whole cluster on one box). No path swaps a backend or moves to the CPU unasked. Barriers (the
checkpoint store's commit barriers, :func:`cluster_barrier`) run on a
gloo group of their own, bounded by ``PHOTON_TPU_BARRIER_TIMEOUT_S``: a
dead peer fails them loudly, never hangs them.

Row sharding: :class:`SlotRows` holds this process's slots of a
row-sharded array or matrix, each on its slot's device (`shard_rows`,
`shard_local_rows`, `shard_stacked`, `fetch_local_rows`); `local_rows`
and `gather_rows` move a whole per-row vector to this process's padded
rows and back (one `all_gather`, slot order).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.utils.env import get_raw

__all__ = [
    "Mesh", "SlotRows", "SlotParts", "make_mesh", "initialize_distributed",
    "distributed_client", "cluster_barrier", "barrier_timeout_s",
    "flat_mesh_devices", "local_row_slots", "shard_rows",
    "shard_local_rows", "shard_stacked", "fetch_local_rows", "psum",
    "gather_processes", "check_slot_split", "check_mesh", "local_rows",
    "gather_rows",
    "pad_to_multiple", "compact_rows", "make_hybrid_mesh",
]

# The live process group of this process (`initialize_distributed`):
# {"backend", "device", "rank", "world", "barrier_group"}.
_DIST: dict = {}


def pad_to_multiple(n: int, m: int) -> int:
    """Examples are padded (with weight 0) so shards are equal-size/static."""
    return ((n + m - 1) // m) * m


# ------------------------------------------------------------------ the mesh
class SlotParts(list):
    """Per-local-slot partials (one entry per slot this process owns, in
    slot order) that a :func:`psum` closes: what a row-sharded X pass or
    row sum returns before the evaluation's one reduction."""


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``n_slots`` device slots; this process owns ``local_slots``
    (contiguous), slot ``local_slots[k]`` on ``slot_devices[k]``.
    ``home`` (the first local slot's device) holds the replicated solver
    state. ``backend`` is None for one process, else the process group's
    ("gloo" or "nccl"). ``n_replicas`` (None for a flat mesh) views the
    slots as a replica × data mesh (`make_hybrid_mesh`). Compared and
    hashed by identity."""

    n_slots: int
    local_slots: tuple
    slot_devices: tuple
    process_index: int = 0
    process_count: int = 1
    backend: Optional[str] = None
    n_replicas: Optional[int] = None

    @property
    def axis_names(self) -> tuple:
        return (("replica", "data") if self.n_replicas is not None
                else ("data",))

    @property
    def shape(self) -> tuple:
        """(R, D) for a replica × data mesh, else (S,)."""
        if self.n_replicas is not None:
            return (self.n_replicas, self.n_slots // self.n_replicas)
        return (self.n_slots,)

    @property
    def home(self) -> torch.device:
        return self.slot_devices[0]

    @property
    def n_local(self) -> int:
        return len(self.local_slots)

    def device_of(self, slot: int) -> Optional[torch.device]:
        """Slot ``slot``'s device, or None when another process owns it."""
        lo = self.local_slots[0]
        k = slot - lo
        return self.slot_devices[k] if 0 <= k < self.n_local else None

    def psum(self, parts) -> tuple:
        return psum(self, parts)


def _process() -> tuple:
    """(rank, world size) of this process's live group, else (0, 1)."""
    if _DIST:
        return _DIST["rank"], _DIST["world"]
    return 0, 1


def check_slot_split(n_slots: int, n_processes: int) -> None:
    """Refuse a split of ``n_slots`` over ``n_processes`` under which the
    slot-ordered reduction would not give the in-process bits: every
    process must own the same count of contiguous slots, and for P > 1
    that count must be a power of two — only then is each process's run
    of slots a subtree of `_tree`'s pairwise tree (S = 8 over 2 or 4
    processes and 6 over 3 pass; 6 over 2 and 12 over 4 do not)."""
    S, P = int(n_slots), int(n_processes)
    if S % P:
        raise ValueError(
            f"{S} mesh slots do not split over {P} processes — every "
            "process must own the same number of contiguous slots")
    k = S // P
    if P > 1 and k & (k - 1):
        raise ValueError(
            f"{S} mesh slots over {P} processes give each process {k} "
            "slots, which is not a power of two: a process's slots would "
            "not form a subtree of the slot-ordered reduction's pairwise "
            "tree, so its sums would differ from the in-process mesh's. "
            "Use a slot count whose share per process is a power of two "
            f"(e.g. {P * (1 << max(k - 1, 0).bit_length())} slots)")


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device=None) -> Mesh:
    """A mesh of ``n_devices`` slots (or one per entry of ``devices``, a
    list of the S global slot devices). Under a live process group the
    slots split evenly over the processes, each owning a contiguous run
    on its own device. Without ``devices``, slots go on ``device``: the
    process's device under a process group, else ``cuda`` (slot ``i`` on
    ``cuda:(i·count // S)``) unless the caller asks for the CPU. The
    default slot count is one per visible card (in-process) or one per
    process."""
    from photon_tpu_torch.device import resolve_device

    rank, world = _process()
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        S = len(devices)
        if n_devices is not None and n_devices != S:
            raise ValueError(f"n_devices={n_devices} but {S} devices given")
    else:
        if device is None and _DIST:
            base = _DIST["device"]
        else:
            base = resolve_device(device)
        if n_devices is None:
            n_devices = (torch.cuda.device_count()
                         if base.type == "cuda" and world == 1 else world)
        S = int(n_devices)
    if S < 1:
        raise ValueError(f"a mesh needs at least one slot, got {S}")
    check_slot_split(S, world)
    per = S // world
    local = tuple(range(rank * per, (rank + 1) * per))
    if devices is not None:
        slot_devs = tuple(devices[j] for j in local)
    elif base.type == "cuda" and base.index is None and world == 1:
        count = max(torch.cuda.device_count(), 1)
        slot_devs = tuple(torch.device("cuda", j * count // S) for j in local)
    else:
        if base.type == "cuda" and base.index is None:
            base = torch.device("cuda", torch.cuda.current_device())
        slot_devs = (base,) * per
    return Mesh(S, local, slot_devs, rank, world,
                _DIST.get("backend") if world > 1 else None)


def check_mesh(mesh) -> None:
    """``mesh`` must be None or a :class:`Mesh` (a TypeError otherwise)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")


def flat_mesh_devices(mesh: Mesh) -> list:
    """The S slot devices in slot order (None for slots another process
    owns): slot j of this list owns row-shard j."""
    return [mesh.device_of(j) for j in range(mesh.n_slots)]


def local_row_slots(mesh: Mesh) -> list:
    """Global slot indices owned by THIS process, in slot order."""
    return list(mesh.local_slots)


# ------------------------------------------------------------- the reduction
def _tree(items: list) -> tuple:
    """Pairwise sum of leaf tuples in list order: ((0+1)+(2+3))+... —
    the fixed order every process count shares (None leaves stay None)."""
    while len(items) > 1:
        nxt = [tuple(None if a is None else a + b
                     for a, b in zip(items[i], items[i + 1]))
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def gather_processes(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` stacked in rank order, (P, ...) on the home
    device: one ``all_gather`` (through host memory unless the backend is
    NCCL) when P > 1, counted in ``mesh.collectives`` and
    ``mesh.wire_bytes``; ``t[None]`` for one process."""
    if mesh.process_count == 1:
        return t[None]
    import torch.distributed as dist

    wire = t.contiguous() if mesh.backend == "nccl" else t.cpu()
    outs = [torch.empty_like(wire) for _ in range(mesh.process_count)]
    dist.all_gather(outs, wire)
    telemetry.count("mesh.collectives")
    telemetry.count("mesh.wire_bytes", wire.numel() * wire.element_size()
                    * (mesh.process_count - 1))
    return torch.stack(outs).to(mesh.home)


def psum(mesh: Mesh, parts) -> tuple:
    """Close one evaluation over the mesh: ``parts`` holds one tuple of
    partials (tensors of one float dtype, or None leaves) per LOCAL slot,
    in slot order; returns the tuple of totals on ``mesh.home``, the same
    bits on every rank and at every process count (see the module
    docstring). One ``all_gather`` when P > 1, none otherwise."""
    if len(parts) != mesh.n_local:
        raise ValueError(f"psum got {len(parts)} slot partials for "
                         f"{mesh.n_local} local slots")
    home = mesh.home
    items = [tuple(None if t is None else t.to(home) for t in p)
             for p in parts]
    local = _tree(items)
    telemetry.count("mesh.reductions")
    if mesh.process_count == 1:
        return local
    leaves = [t for t in local if t is not None]
    if len({t.dtype for t in leaves}) != 1:
        raise ValueError("psum reduces partials of one dtype (a mixed "
                         "flattening would add in another precision)")
    flat = torch.cat([t.reshape(-1) for t in leaves])
    rows = gather_processes(mesh, flat)
    (total,) = _tree([(rows[p],) for p in range(mesh.process_count)])
    return _unflatten(total, local)


def _unflatten(flat: torch.Tensor, like) -> tuple:
    """``flat`` cut back into the shapes of ``like``'s tensor leaves (None
    leaves stay None)."""
    out, at = [], 0
    for t in like:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)


# -------------------------------------------------------------- row sharding
@dataclasses.dataclass(frozen=True, eq=False)
class SlotRows:
    """A row-sharded array or design matrix: ``parts[k]`` holds the
    ``rows_per_slot`` rows of local slot ``mesh.local_slots[k]`` on
    ``mesh.slot_devices[k]`` — a tensor, a `SparseRows` or a
    `BlockedEllRows` (every slot's layout under one global column
    permutation). The global array has ``n_slots · rows_per_slot`` rows,
    slot-major; other processes' slots are not held here."""

    mesh: Mesh
    parts: tuple
    rows_per_slot: int

    @property
    def n_rows(self) -> int:
        return self.mesh.n_slots * self.rows_per_slot

    @property
    def n_local_rows(self) -> int:
        return self.mesh.n_local * self.rows_per_slot

    @property
    def n_features(self) -> int:
        p = self.parts[0]
        return int(p.n_features if hasattr(p, "n_features")
                   else p.shape[1])

    @property
    def shape(self) -> tuple:
        p = self.parts[0]
        tail = (p.shape[1:] if isinstance(p, torch.Tensor)
                else (self.n_features,))
        return (self.n_rows,) + tuple(tail)

    # a blocked-ELL matrix's one global column permutation (slot 0's copy
    # lives on the home device)
    @property
    def perm_cols(self) -> torch.Tensor:
        return self.parts[0].perm_cols

    @property
    def inv_perm(self) -> torch.Tensor:
        return self.parts[0].inv_perm

    @property
    def last_col_pos(self) -> int:
        return self.parts[0].last_col_pos

    def from_model_space(self, v: torch.Tensor) -> torch.Tensor:
        return self.parts[0].from_model_space(v)

    def to_model_space(self, w: torch.Tensor) -> torch.Tensor:
        return self.parts[0].to_model_space(w)

    def local(self) -> torch.Tensor:
        """This process's rows of a row-sharded TENSOR as one tensor on
        the home device, local slots in order."""
        home = self.mesh.home
        return torch.cat([p.to(home) for p in self.parts])


def _slot_slice(host, j: int, s: int, n: int):
    """Rows [j·s, (j+1)·s) of ``host`` (a CPU tensor), zero-padded past
    row ``n``."""
    lo, hi = j * s, min((j + 1) * s, n)
    if hi - lo == s:
        return host[lo:hi]
    buf = host.new_zeros((s,) + tuple(host.shape[1:]))
    if hi > lo:
        buf[:hi - lo] = host[lo:hi]
    return buf


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_rows(host, mesh: Mesh, pad_rows: Optional[int] = None) -> SlotRows:
    """Row-shard a host array (numpy or tensor; a `SparseRows` shards
    both its leaves) over the mesh: each LOCAL slot's slice is copied
    straight onto its device (other processes' rows are never touched).
    Rows pad with zeros to ``pad_rows`` (default: the next multiple of
    the slot count) — zero rows carry weight 0 in every batch, so no
    reduction sees them."""
    from photon_tpu_torch.data.matrix import SparseRows

    sparse = isinstance(host, SparseRows)
    leaves = ([_host_tensor(host.indices), _host_tensor(host.values)]
              if sparse else [_host_tensor(host)])
    n = int(leaves[0].shape[0])
    n_pad = pad_to_multiple(max(n, 1), mesh.n_slots) if pad_rows is None \
        else int(pad_rows)
    if n_pad % mesh.n_slots or n_pad < n:
        raise ValueError(f"pad_rows={n_pad} must cover {n} rows and divide "
                         f"{mesh.n_slots} slots")
    s = n_pad // mesh.n_slots
    parts = []
    for j, dev in zip(mesh.local_slots, mesh.slot_devices):
        got = [_slot_slice(t, j, s, n).to(dev) for t in leaves]
        parts.append(SparseRows(got[0], got[1], host.n_features) if sparse
                     else got[0])
    return SlotRows(mesh, tuple(parts), s)


def shard_local_rows(local, mesh: Mesh) -> SlotRows:
    """Re-shard a (n_local_slots, s, ...) host stack (the layout
    `fetch_local_rows` returns) back onto the mesh, without touching
    other processes' rows."""
    local = _host_tensor(local)
    parts = tuple(local[k].to(dev) for k, dev in enumerate(mesh.slot_devices))
    return SlotRows(mesh, parts, int(local.shape[1]))


def shard_stacked(host, mesh: Mesh) -> SlotRows:
    """Shard a host ``(S, ...)`` stack one leading index per slot: slot j
    gets ``host[j:j+1]`` on its device (local slots only) — the upload
    form of per-shard structures whose leading axis IS the shard axis."""
    host = _host_tensor(host)
    if host.shape[0] != mesh.n_slots:
        raise ValueError(
            f"stacked leading axis {host.shape[0]} != {mesh.n_slots} mesh "
            "slots; rebuild the structure for this mesh")
    parts = tuple(host[j:j + 1].to(dev)
                  for j, dev in zip(mesh.local_slots, mesh.slot_devices))
    return SlotRows(mesh, parts, 1)


def fetch_local_rows(arr: SlotRows, mesh: Mesh) -> np.ndarray:
    """The inverse of `shard_local_rows`: this process's row shards as
    one (n_local_slots, s, ...) numpy stack in slot order."""
    return np.stack([p.detach().cpu().numpy() for p in arr.parts])


def local_rows(mesh: Mesh, t: torch.Tensor, n_pad: int) -> torch.Tensor:
    """This process's rows of a whole per-row tensor ``t`` ((n, ...), any
    device) padded with zeros to ``n_pad`` rows: its local slots' rows,
    slot-major, on the home device — the scalar-column layout of a
    row-sharded batch (`data.dataset.mesh_batch`)."""
    s = int(n_pad) // mesh.n_slots
    lo, hi = mesh.local_slots[0] * s, (mesh.local_slots[-1] + 1) * s
    n = int(t.shape[0])
    t = t.to(mesh.home)
    if hi <= n:
        return t[lo:hi]
    out = t.new_zeros((hi - lo,) + tuple(t.shape[1:]))
    if n > lo:
        out[:n - lo] = t[lo:n]
    return out


def gather_rows(mesh: Mesh, local: torch.Tensor, n_rows: int
                ) -> torch.Tensor:
    """The inverse of `local_rows`: every process's padded local rows
    gathered in slot order (one ``all_gather`` when P > 1) and trimmed to
    the ``n_rows`` real rows, on the home device — the same bits on every
    rank."""
    rows = gather_processes(mesh, local.to(mesh.home))
    return rows.reshape((-1,) + tuple(local.shape[1:]))[:int(n_rows)]


# ------------------------------------------------------------ compaction
def _map(fn, tree):
    """``fn`` over every tensor leaf of a tuple / NamedTuple / list / dict
    (None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    raise TypeError(f"compact_rows: unsupported leaf {type(tree).__name__}")


def compact_rows(tree, idx, pad_rows: int | None = None, mesh=None,
                 pad_mode: str = "zero"):
    """Gather leading-axis rows ``idx`` from every tensor of ``tree`` into
    a dense zero-padded ``(pad_rows, ...)`` block on the tensors' own
    device — the straggler repack and the continual refresh's compaction:
    the rows of interest (unconverged lanes, touched entities) become one
    small block padded to a fixed height. Zero-padded rows carry weight 0
    in every batch, so no reduction sees them. With ``mesh`` every leaf
    of the block is row-sharded over the mesh's slots (`SlotRows`; the
    height must divide the slot count).

    ``pad_mode="edge"`` repeats the LAST gathered row into the pad instead
    of zeros, for lock-step lane consumers (the lane tuner's survivor
    re-solve): a duplicate of a real lane converges as fast as its
    original, where a zero lane could be the chunk's slowest."""
    if pad_mode not in ("zero", "edge"):
        raise ValueError(f"pad_mode must be 'zero' or 'edge', got "
                         f"{pad_mode!r}")
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64).reshape(-1))
    idx = idx.long()
    n = int(idx.shape[0])
    target = n if pad_rows is None else int(pad_rows)
    if target < n:
        raise ValueError(f"pad_rows={target} is below the {n} gathered rows")
    if mesh is not None and target % mesh.n_slots:
        raise ValueError(f"{target} compacted rows do not divide the "
                         f"{mesh.n_slots}-slot mesh; pad to a multiple")
    if n == 0 and target > 0 and pad_mode == "edge":
        raise ValueError("pad_mode='edge' needs at least one gathered row")

    def take(x: torch.Tensor) -> torch.Tensor:
        g = x.index_select(0, idx.to(x.device))
        if target != n:
            pad = (g[-1:].expand((target - n,) + tuple(g.shape[1:]))
                   if pad_mode == "edge"
                   else g.new_zeros((target - n,) + tuple(g.shape[1:])))
            g = torch.cat([g, pad])
        return g if mesh is None else shard_rows(g, mesh, pad_rows=target)

    return _map(take, tree)


def make_hybrid_mesh(n_replicas: Optional[int] = None,
                     n_devices: Optional[int] = None, devices=None,
                     device=None) -> Mesh:
    """The replica × data mesh (reference: `make_hybrid_mesh`, DCN ×
    ICI): the `make_mesh` slots viewed as ``n_replicas`` replicas of D
    slots, replica-major, so a replica is a contiguous run of slots.
    ``n_replicas=None`` takes one replica per process (one for an
    in-process mesh). A count that does not divide the slots raises.
    Every row-sharded path runs on it as on the flat mesh of the same
    slots (its `psum` is the flat slot tree)."""
    mesh = make_mesh(n_devices=n_devices, devices=devices, device=device)
    R = mesh.process_count if n_replicas is None else int(n_replicas)
    if R < 1 or mesh.n_slots % R:
        raise ValueError(f"{mesh.n_slots} devices do not divide into "
                         f"{R} replicas")
    return dataclasses.replace(mesh, n_replicas=R)


# ------------------------------------------------------ the process group
def barrier_timeout_s() -> float:
    """``PHOTON_TPU_BARRIER_TIMEOUT_S`` in seconds (default 120, at least
    1)."""
    raw = get_raw("PHOTON_TPU_BARRIER_TIMEOUT_S")
    try:
        return max(float(raw), 1.0) if raw else 120.0
    except ValueError:
        return 120.0


def distributed_client() -> Optional[dict]:
    """The live process group's facts (backend, device, rank, world), or
    None — the one place the module state is read (double-init refusal,
    barriers, the checkpoint store's commit barrier)."""
    return dict(_DIST) if _DIST else None


def local_process_count(num_processes: int) -> int:
    """How many processes of the cluster run on THIS host: torchrun's
    ``LOCAL_WORLD_SIZE``, else all ``num_processes`` (one box, as
    `parallel.launch` runs them)."""
    raw = os.environ.get("LOCAL_WORLD_SIZE")
    if raw is None:
        return int(num_processes)
    n = int(raw)
    if not 1 <= n <= num_processes:
        raise ValueError(f"{n} processes on this host is outside 1.."
                         f"{num_processes} (the cluster's size)")
    return n


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           initialization_timeout: Optional[float] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Form this process's group (``torch.distributed`` over a TCP
    rendezvous at ``coordinator_address``, host:port) — the analogue of
    the reference's Spark driver/executor bootstrap.

    With no arguments, reads ``PHOTON_TPU_COORDINATOR`` /
    ``PHOTON_TPU_NUM_PROCESSES`` / ``PHOTON_TPU_PROCESS_ID`` (the launcher
    exports them to its children); with none of them set it returns False
    (a plain single process). Returns True once the group is up — an
    explicit ``num_processes=1`` cluster-of-one included.

    ``device`` is this process's device (default ``cuda``: the current
    card, which the caller pins with `torch.cuda.set_device` first; the
    launcher does). ``backend``: gloo for the CPU; for CUDA, NCCL (the
    default) needs a card per process — fewer raises — and gloo must be
    named to share a card (the partials reduce through host copies).

    Validation is loud and comes before any traffic: a rank outside
    ``[0, num_processes)``, a rank without a size, a bad size, NCCL on
    the CPU or on fewer cards than this host's processes
    (`local_process_count`), and a second initialize in the same process
    all raise."""
    import torch.distributed as dist

    from photon_tpu_torch.device import resolve_device

    if coordinator_address is None:
        coordinator_address = get_raw("PHOTON_TPU_COORDINATOR")
    if num_processes is None:
        raw = get_raw("PHOTON_TPU_NUM_PROCESSES")
        num_processes = int(raw) if raw is not None else None
    if process_id is None:
        raw = get_raw("PHOTON_TPU_PROCESS_ID")
        process_id = int(raw) if raw is not None else None

    if num_processes is not None and num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if process_id is not None:
        if num_processes is None:
            raise ValueError(
                "process_id given without num_processes — pass both (or "
                "set PHOTON_TPU_NUM_PROCESSES next to PHOTON_TPU_PROCESS_ID)")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for num_processes="
                f"{num_processes} (ranks are 0..{num_processes - 1})")
    if num_processes is not None and num_processes > 1 \
            and process_id is None:
        raise ValueError("num_processes given without process_id — every "
                         "member of a cluster needs its rank")
    if distributed_client() is not None or (dist.is_available()
                                            and dist.is_initialized()):
        raise RuntimeError(
            "a process group is already initialized in this process — "
            "initialize_distributed must run exactly once. Reuse the "
            "existing group (tests: run each cluster member in a fresh "
            "process, e.g. via parallel.launch)")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("a cluster needs PHOTON_TPU_COORDINATOR "
                         "(host:port of rank 0's rendezvous)")
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL reduces CUDA tensors; a CPU mesh uses "
                             "backend='gloo'")
        cards = torch.cuda.device_count()
        here = local_process_count(num_processes)
        if cards < here:
            raise ValueError(
                f"NCCL needs a card per process: {here} processes on this "
                f"host's {cards} card(s); name backend='gloo' to share a "
                "card (the partials then reduce through host copies). If "
                "the cluster spans several hosts, set "
                "LOCAL_WORLD_SIZE to this host's process count (torchrun "
                "sets it)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    timeout = datetime.timedelta(seconds=float(initialization_timeout or 300))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    # barriers ride a gloo group of their own, so a barrier on a writer
    # thread never interleaves with the main thread's reductions
    barrier_group = dist.new_group(backend="gloo", timeout=timeout)
    _DIST.update(backend=backend, device=dev, rank=process_id,
                 world=num_processes, barrier_group=barrier_group)
    return True


def shutdown_distributed() -> None:
    """Tear this process's group down (a no-op without one)."""
    import torch.distributed as dist

    if _DIST:
        _DIST.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def cluster_barrier(tag: str, timeout_s: Optional[float] = None) -> float:
    """A timed cluster-wide barrier: every process blocks until all ranks
    arrive, for at most ``timeout_s`` (default the
    ``PHOTON_TPU_BARRIER_TIMEOUT_S`` knob); a dead or late peer makes it
    RAISE (naming the rank, gloo's monitored barrier) — it never hangs.
    Returns this rank's wait in seconds; 0.0 for one process. ``tag``
    names the barrier in the error. The wait is a ``parallel.barrier_wait``
    span (attrs carry the tag): the rank that waits least is the one the
    others waited for, which is how `telemetry.aggregate` names the
    straggler."""
    t0 = time.perf_counter()
    with telemetry.span("parallel.barrier_wait", tag=tag):
        if not _DIST or _DIST["world"] <= 1:
            return 0.0
        import torch.distributed as dist

        t = barrier_timeout_s() if timeout_s is None else float(timeout_s)
        try:
            dist.monitored_barrier(group=_DIST["barrier_group"],
                                   timeout=datetime.timedelta(seconds=t),
                                   wait_all_ranks=True)
        except RuntimeError as e:
            raise RuntimeError(f"cluster barrier {tag!r} failed within "
                               f"{t:g} s on rank {_DIST['rank']}: {e}") from e
    telemetry.count("parallel.barrier_seconds", time.perf_counter() - t0)
    return time.perf_counter() - t0
