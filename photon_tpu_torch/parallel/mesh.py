"""Row padding and compaction on one device (the `pad_to_multiple` and
`compact_rows` part of `photon_tpu/parallel/mesh.py`).

Everything else of the reference module — meshes, row sharding, the
streamed mesh slots, the multi-host launch — waits for ROADMAP queue A
item 10: asking this module for any of it raises `NotImplementedError`
naming that item.
"""
from __future__ import annotations

import numpy as np
import torch

_MESH_NAMES = frozenset({
    "make_mesh", "initialize_distributed", "distributed_client",
    "cluster_barrier", "make_hybrid_mesh", "data_sharding", "replicated",
    "flat_mesh_devices", "local_row_slots", "shard_rows",
    "shard_local_rows", "shard_stacked", "fetch_local_rows", "shard_map"})


def __getattr__(name: str):
    if name in _MESH_NAMES:
        raise NotImplementedError(
            f"parallel.mesh.{name} (device meshes) is not ported yet "
            "(ROADMAP queue A item 10)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def pad_to_multiple(n: int, m: int) -> int:
    """Examples are padded (with weight 0) so shards are equal-size/static."""
    return ((n + m - 1) // m) * m


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


def compact_rows(tree, idx, pad_rows: int | None = None, mesh=None):
    """Gather leading-axis rows ``idx`` from every tensor of ``tree`` into
    a dense zero-padded ``(pad_rows, ...)`` block on the tensors' own
    device — the straggler repack and the continual refresh's compaction:
    the rows of interest (unconverged lanes, touched entities) become one
    small block padded to a fixed height. Zero-padded rows carry weight 0
    in every batch, so no reduction sees them. ``mesh`` (re-sharding the
    block) waits for ROADMAP queue A item 10, and the reference's
    ``pad_mode="edge"`` for the tuner that uses it (item 11)."""
    if mesh is not None:
        raise NotImplementedError(
            "compact_rows onto a mesh is not ported yet (ROADMAP queue A "
            "item 10)")
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64).reshape(-1))
    idx = idx.long()
    n = int(idx.shape[0])
    target = n if pad_rows is None else int(pad_rows)
    if target < n:
        raise ValueError(f"pad_rows={target} is below the {n} gathered rows")

    def take(x: torch.Tensor) -> torch.Tensor:
        g = x.index_select(0, idx.to(x.device))
        if target == n:
            return g
        return torch.cat([g, g.new_zeros((target - n,) + tuple(g.shape[1:]))])

    return _map(take, tree)
