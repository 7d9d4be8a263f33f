"""Coefficient store: the serving tier's model plane (port of
`photon_tpu/serving/store.py`).

- fixed effects: one flat ``(d,)`` float32 vector per fixed coordinate;
- random effects: one flat C-contiguous ``(E + 1, d)`` float32 block per
  random coordinate whose LAST row is all-zero — the cold-miss row. An
  unseen entity resolves to row ``E`` and contributes zero, so the request
  degrades to the fixed-effect-only score instead of erroring.

The host blocks stay numpy (``open(..., mmap=True)`` maps them read-only,
so several serving processes on one host share one page-cache copy);
`device_blocks` uploads them once to the store's device. The on-disk
format is the JAX package's, so either package opens a store the other
saved (in-memory TSV entity directories only in the port).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import threading

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint import faults
from photon_tpu_torch.checkpoint.store import (commit_bytes,
                                               replace_committed)
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_tpu_torch.ops.losses import TaskType

_META_NAME = "serving_store.json"
_FORMAT = "photon_tpu-serving-store-v1"


@dataclasses.dataclass
class FixedBlock:
    """One fixed-effect coordinate: a flat (d,) coefficient vector."""

    feature_shard: str
    weights: np.ndarray  # (d,) float32 (possibly a read-only memmap)


@dataclasses.dataclass
class RandomBlock:
    """One random-effect coordinate: flat (E+1, d) coefficients + the
    entity→row directory. Row E is the all-zero cold-miss row."""

    feature_shard: str
    entity_name: str
    coefficients: np.ndarray  # (E + 1, d) float32, last row zero
    directory: IndexMap  # frozen

    @property
    def n_entities(self) -> int:
        return int(self.coefficients.shape[0]) - 1

    @property
    def dim(self) -> int:
        return int(self.coefficients.shape[1])

    def lookup(self, raw_ids) -> tuple:
        """Raw entity keys → dense coefficient rows, vectorized.

        Returns ``(rows int32 (n,), n_miss)``; unseen keys land on the
        zero row ``E``, never raise."""
        g = self.directory.key_to_id.get
        keys = [k if isinstance(k, str) else str(k) for k in raw_ids]
        ids = np.fromiter((g(k, -1) for k in keys), np.int64,
                          count=len(keys))
        miss = ids < 0
        return (np.where(miss, self.n_entities, ids).astype(np.int32),
                int(miss.sum()))


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CoefficientStore:
    """The model plane: every coordinate's coefficients, gather-ready, and
    their upload to ``device`` (default ``cuda``; see `resolve_device`).

    ``order`` preserves the GameModel's coordinate order — the scoring
    program sums contributions in exactly that order."""

    def __init__(self, task: TaskType, order: tuple, fixed: dict,
                 random: dict, device=None):
        self.device = resolve_device(device)
        self.task = task
        self.order = tuple(order)
        self.fixed = fixed    # name -> FixedBlock
        self.random = random  # name -> RandomBlock
        self._device_blocks = None  # uploaded lazily, swapped by reloads
        # guards the (fixed, random, uploads) generation against hot swaps
        self._swap_lock = threading.Lock()

    # ----------------------------------------------------------- construction
    @classmethod
    def from_game_model(cls, model: GameModel,
                        device=None) -> "CoefficientStore":
        """Freeze an in-memory GameModel into a store on ``device``."""
        fixed: dict = {}
        random: dict = {}
        for name, cm in model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                fixed[name] = FixedBlock(
                    cm.feature_shard,
                    np.ascontiguousarray(
                        cm.model.weights.detach().cpu().numpy(), np.float32))
            elif isinstance(cm, RandomEffectModel):
                C = cm.coefficients.detach().cpu().numpy().astype(
                    np.float32, copy=False)
                flat = np.zeros((C.shape[0] + 1, C.shape[1]), np.float32)
                flat[:-1] = C
                directory = IndexMap(
                    {str(k): i
                     for i, k in enumerate(np.asarray(cm.entity_keys))},
                    frozen=True)
                random[name] = RandomBlock(cm.feature_shard, cm.entity_name,
                                           flat, directory)
            else:
                raise TypeError(f"unknown coordinate model: {type(cm)}")
        return cls(model.task, tuple(model.coordinates), fixed, random,
                   device=device)

    # ------------------------------------------------------------------ IO
    def save(self, out_dir) -> None:
        """Persist the store: one .npy per coefficient block (flat,
        mmap-able) + the entity directories + a JSON manifest.

        Two-phase: every payload is written and fsynced under a temp name
        first, then published by `replace_committed` (a ``commit`` fault
        site each), and the manifest commits LAST — a save killed midway
        leaves no manifest, so `open` fails cleanly instead of reading a
        torn block."""
        out_dir = str(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        tag = f".tmp.{os.getpid()}"
        meta: dict = {"format": _FORMAT, "task": self.task.name,
                      "coordinates": []}
        staged: list = []

        def stage_npy(fname: str, arr: np.ndarray) -> None:
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr, np.float32), allow_pickle=False)
            final = os.path.join(out_dir, fname)
            _write_synced(final + tag, buf.getvalue())
            staged.append(final)

        for name in self.order:
            if name in self.fixed:
                blk = self.fixed[name]
                stage_npy(f"{name}.fixed.npy", blk.weights)
                meta["coordinates"].append(
                    {"name": name, "type": "fixed",
                     "feature_shard": blk.feature_shard})
            else:
                blk = self.random[name]
                stage_npy(f"{name}.coeffs.npy", blk.coefficients)
                dpath = os.path.join(out_dir, f"{name}.entities.tsv")
                blk.directory.save(dpath + tag)
                staged.append(dpath)
                meta["coordinates"].append(
                    {"name": name, "type": "random",
                     "feature_shard": blk.feature_shard,
                     "entity_name": blk.entity_name, "directory": "tsv"})
        for final in staged:
            replace_committed(final + tag, final)
        commit_bytes(os.path.join(out_dir, _META_NAME),
                     json.dumps(meta, indent=2).encode())

    @classmethod
    def open(cls, out_dir, mmap: bool = True,
             device=None) -> "CoefficientStore":
        """Open a saved store onto ``device``; ``mmap=True`` maps every
        coefficient block read-only instead of copying it into the heap.

        The reads ride `faults.retry_io` (site ``store_open``): they are
        pure reads, so a retry restarts the open; an injected kill at the
        site propagates. A missing manifest (nothing published) fails at
        once rather than burning the retry budget."""
        out_dir = str(out_dir)
        manifest = os.path.join(out_dir, _META_NAME)
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"{manifest}: no store manifest")
        return faults.retry_io(lambda: cls._open(out_dir, mmap, device),
                               site="store_open")

    @classmethod
    def _open(cls, out_dir: str, mmap: bool, device) -> "CoefficientStore":
        manifest = os.path.join(out_dir, _META_NAME)
        with open(manifest) as f:
            meta = json.load(f)
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{out_dir}: not a {_FORMAT} store")
        mode = "r" if mmap else None
        fixed: dict = {}
        random: dict = {}
        order = []
        for c in meta["coordinates"]:
            name = c["name"]
            order.append(name)
            if c["type"] == "fixed":
                w = np.load(os.path.join(out_dir, f"{name}.fixed.npy"),
                            mmap_mode=mode)
                fixed[name] = FixedBlock(c["feature_shard"], w)
                continue
            if c["directory"] != "tsv":
                raise ValueError(
                    f"{out_dir}: coordinate {name!r} keeps its entity "
                    f"directory as {c['directory']!r}; the port reads only "
                    "'tsv' directories")
            C = np.load(os.path.join(out_dir, f"{name}.coeffs.npy"),
                        mmap_mode=mode)
            directory = IndexMap.load(
                os.path.join(out_dir, f"{name}.entities.tsv"))
            random[name] = RandomBlock(c["feature_shard"], c["entity_name"],
                                       C, directory)
        return cls(TaskType[meta["task"]], tuple(order), fixed, random,
                   device=device)

    # ------------------------------------------------------------- device side
    def device_blocks(self) -> tuple:
        """(fixed_ws, re_cs): name-keyed dicts of f32 blocks on the store's
        device, uploaded once and reused by every dispatch.

        Returns ONE coefficient generation atomically: a flush racing a
        `reload_coefficients` gets the whole old pair or the whole new
        pair, never a mix."""
        with self._swap_lock:
            if self._device_blocks is None:
                def up(a):
                    return torch.from_numpy(
                        np.array(a, np.float32)).to(self.device)

                self._device_blocks = (
                    {n: up(b.weights) for n, b in self.fixed.items()},
                    {n: up(b.coefficients) for n, b in self.random.items()})
            return self._device_blocks

    def reload_coefficients(self, other: "CoefficientStore") -> None:
        """Hot-swap coefficient VALUES from another store with identical
        structure (same coordinates, dims, entity spaces) — the online
        model-push path. In-flight flushes finish on the old generation;
        the next flush scores the new one. Counts ``serving.hot_swaps``."""
        if (other.order != self.order
                or any(other.fixed[n].weights.shape
                       != self.fixed[n].weights.shape for n in self.fixed)
                or any(other.random[n].coefficients.shape
                       != self.random[n].coefficients.shape
                       for n in self.random)):
            raise ValueError(
                "coefficient reload requires an identically-shaped store "
                "(new entities or features need a new program ladder)")
        with self._swap_lock:
            self.fixed = other.fixed
            self.random = other.random
            self._device_blocks = None
        telemetry.count("serving.hot_swaps")

    # ---------------------------------------------------------------- lookups
    def lookup(self, name: str, raw_ids) -> tuple:
        """Entity→row resolution for one random coordinate (see
        `RandomBlock.lookup`)."""
        return self.random[name].lookup(raw_ids)

    def n_entities(self, name: str) -> int:
        return self.random[name].n_entities

    def shard_dims(self) -> dict:
        """Feature-shard name → column count, from the blocks themselves."""
        dims: dict = {}
        for b in self.fixed.values():
            dims[b.feature_shard] = int(np.asarray(b.weights).shape[0])
        for b in self.random.values():
            dims.setdefault(b.feature_shard, b.dim)
        return dims
