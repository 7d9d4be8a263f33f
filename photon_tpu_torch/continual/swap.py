"""Atomic serving hot-swap: parity-probed, crash-consistent model push
(port of `photon_tpu/continual/swap.py`).

The flywheel's last step: refreshed coefficients go live. Three layers,
each independently safe:

- **Parity probe** (`parity_probe`): before anything publishes, K sampled
  entities score through the OLD and NEW coefficient blocks on
  deterministic probe rows; if the worst margin delta exceeds ``bound``
  the swap REFUSES (`SwapRefused`, counted on
  ``continual.swap_refusals``) — a corrupted or blown-up refresh never
  reaches traffic. The probe is host numpy in f64: it must not depend on
  the tier it guards.
- **Durable publish** (`publish_store` / `open_current`): each model
  version is a complete `CoefficientStore` directory under
  ``<root>/v<nnnnnnnn>/`` (itself two-phase-committed by `store.save`,
  each payload through `checkpoint.store.replace_committed`); the live
  pointer ``CURRENT.json`` swings LAST via `checkpoint.store.commit_bytes`.
  A kill ANYWHERE before the pointer commit (the ``swap_publish`` fault
  site sits between the version save and the pointer, the ``commit``
  sites inside both) leaves ``CURRENT`` pointing at the old version:
  readers keep serving the old model bit-identically, and the
  half-written version directory is swept on a later publish. The
  directory format is the reference's, so either package opens a version
  the other published.
- **In-process cutover**: `CoefficientStore.reload_coefficients` swings
  the live store's coefficient generation atomically under its swap lock
  (counted on ``serving.hot_swaps``); the program ladder takes
  coefficients as arguments and its int8 cache is keyed by the
  generation, so the next flush scores (and re-quantizes) the new one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Optional

import numpy as np

from photon_tpu_torch import telemetry
from photon_tpu_torch.checkpoint import faults
from photon_tpu_torch.checkpoint.store import commit_bytes
from photon_tpu_torch.serving.store import CoefficientStore

CURRENT_NAME = "CURRENT.json"
_VERSION_RE = re.compile(r"^v(\d{8})$")


class SwapRefused(RuntimeError):
    """The parity probe breached its bound: the new model does NOT go
    live. Carries the probe report for the operator."""

    def __init__(self, report: "ParityReport"):
        super().__init__(
            f"hot swap refused: parity probe max margin delta "
            f"{report.max_abs_delta:.6g} over {report.n_probes} probes "
            f"exceeds bound {report.bound:.6g}")
        self.report = report


@dataclasses.dataclass(frozen=True)
class ParityProbe:
    """Probe knobs: how many entities to sample per random coordinate,
    the margin-delta bound, and the deterministic row seed. ``exclude``:
    raw entity keys whose movement is EXPECTED (e.g. this refresh's
    touched set) when the caller wants the probe to watch only the
    supposedly-unchanged population — with priors in place the default
    (probe everyone) catches blow-ups without tripping on honest
    refreshes."""

    sample: int = 64
    bound: float = 1.0
    seed: int = 0
    exclude: frozenset = frozenset()


@dataclasses.dataclass
class ParityReport:
    n_probes: int
    max_abs_delta: float
    bound: float

    @property
    def ok(self) -> bool:
        return self.max_abs_delta <= self.bound


def _probe_keys(blk, probe: ParityProbe) -> list:
    """Deterministic sample of probe entity keys from a block's directory
    (an enumerable `IndexMap`; a PalDB directory is refused)."""
    directory = blk.directory
    if not hasattr(directory, "keys_in_order"):
        raise ValueError(
            "parity probe cannot enumerate a PalDB directory; probe with "
            "an IndexMap-backed store or skip the probe explicitly "
            "(probe=None)")
    keys = [k for k in directory.keys_in_order()
            if k not in probe.exclude]
    if len(keys) <= probe.sample:
        return keys
    rng = np.random.default_rng(probe.seed)
    idx = rng.choice(len(keys), size=probe.sample, replace=False)
    return [keys[i] for i in sorted(idx)]


def _margins(store: CoefficientStore, keys_by_coord: dict,
             rows_by_shard: dict) -> np.ndarray:
    """Host-numpy f64 margins of the probe rows through one store: fixed
    matvec + per-entity gather-dot in coordinate order — the serving
    program's math without a device in the loop."""
    n = next(iter(rows_by_shard.values())).shape[0]
    margin = np.zeros((n,), np.float64)
    for name in store.order:
        if name in store.fixed:
            blk = store.fixed[name]
            margin += rows_by_shard[blk.feature_shard] @ np.asarray(
                blk.weights, np.float64)
        else:
            blk = store.random[name]
            ids, _ = blk.lookup(keys_by_coord[name])
            C = np.asarray(blk.coefficients, np.float64)[ids]
            margin += np.einsum(
                "nd,nd->n", rows_by_shard[blk.feature_shard], C)
    return margin


def parity_probe(old: CoefficientStore, new: CoefficientStore,
                 probe: ParityProbe) -> ParityReport:
    """Score K sampled entities through both stores; report the worst
    absolute margin delta. Raises nothing — `hot_swap` decides."""
    with telemetry.span("continual.probe", sample=probe.sample):
        keys_by_coord: dict = {}
        n = 0
        for name, blk in old.random.items():
            keys = _probe_keys(blk, probe)
            keys_by_coord[name] = keys
            n = max(n, len(keys))
        if n == 0:
            return ParityReport(0, 0.0, probe.bound)
        for name in keys_by_coord:  # pad coordinate samples to a common n
            keys = keys_by_coord[name]
            keys_by_coord[name] = (keys * ((n // max(len(keys), 1)) + 1))[:n]
        rng = np.random.default_rng(probe.seed)
        rows_by_shard = {
            shard: rng.normal(size=(n, d)).astype(np.float64)
            for shard, d in old.shard_dims().items()}
        delta = _margins(old, keys_by_coord, rows_by_shard) - \
            _margins(new, keys_by_coord, rows_by_shard)
        telemetry.count("continual.probe_entities", n)
        return ParityReport(n, float(np.max(np.abs(delta))), probe.bound)


# ------------------------------------------------------------ durable layer
def _versions(root: str) -> list:
    out = []
    if os.path.isdir(root):
        for name in os.listdir(root):
            m = _VERSION_RE.match(name)
            if m and os.path.isdir(os.path.join(root, name)):
                out.append(int(m.group(1)))
    return sorted(out)


def current_version(root: str) -> Optional[int]:
    path = os.path.join(root, CURRENT_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(json.load(f)["version"])


def open_current(root: str, mmap: bool = True, device=None):
    """(CoefficientStore on ``device``, version) at the live pointer —
    what a serving process opens at startup. Raises FileNotFoundError
    when nothing has ever been published."""
    v = current_version(root)
    if v is None:
        raise FileNotFoundError(f"{root}: no {CURRENT_NAME} — nothing "
                                "published yet")
    return CoefficientStore.open(os.path.join(root, f"v{v:08d}"),
                                 mmap=mmap, device=device), v


def publish_store(root: str, store: CoefficientStore) -> int:
    """Write ``store`` as the next version directory, then swing the
    CURRENT pointer atomically. Returns the published version number.

    The version directory's own save is two-phase (payloads first, its
    manifest last), and the POINTER commit is the single publication
    point — the ``swap_publish`` fault site sits between the two, so a
    kill mid-swap leaves the previous version serving. Unreferenced
    version directories from crashed publishes are swept here, AFTER the
    new pointer commits."""
    os.makedirs(root, exist_ok=True)
    live = current_version(root)
    seen = _versions(root) + ([live] if live is not None else [])
    version = (max(seen) + 1) if seen else 0
    vdir = os.path.join(root, f"v{version:08d}")
    store.save(vdir)
    faults.kill_point("swap_publish")
    commit_bytes(os.path.join(root, CURRENT_NAME),
                 json.dumps({"version": version,
                             "path": f"v{version:08d}"}).encode())
    for v in _versions(root):  # sweep all but live + the one before it
        if v < version - 1:
            shutil.rmtree(os.path.join(root, f"v{v:08d}"),
                          ignore_errors=True)
    return version


def hot_swap(live: Optional[CoefficientStore], new: CoefficientStore, *,
             root: Optional[str] = None,
             probe: Optional[ParityProbe] = ParityProbe(),
             rows_changed_unix: Optional[float] = None) -> dict:
    """The cutover: probe → durable publish → in-process reload.

    ``live``: the serving process's store (None = publish-only, e.g. a
    refresh job on a different host than the scorers). ``root``: the
    versioned publish directory (None = in-process swap only).
    ``rows_changed_unix``: when the data this refresh folded in CHANGED
    (the delta drop's timestamp); the swap then gauges
    ``continual.staleness_s`` — rows-changed → servable seconds — at the
    moment the new coefficients become servable.
    Returns ``{"report": ParityReport | None, "version": int | None,
    "staleness_s": float | None}``.
    Raises `SwapRefused` on a probe breach — nothing publishes, nothing
    reloads, the old model keeps serving.
    """
    with telemetry.span("continual.swap"):
        report = None
        if probe is not None and live is not None:
            report = parity_probe(live, new, probe)
            if not report.ok:
                telemetry.count("continual.swap_refusals")
                raise SwapRefused(report)
        version = None
        if root is not None:
            version = publish_store(root, new)
        if live is not None:
            live.reload_coefficients(new)  # counts serving.hot_swaps
        staleness = None
        if rows_changed_unix is not None:
            staleness = max(0.0, time.time() - float(rows_changed_unix))
            telemetry.gauge("continual.staleness_s", staleness)
        return {"report": report, "version": version,
                "staleness_s": staleness}
