"""Delta ingestion: diff a new data drop against a previous run's
training-row manifest and emit a compact refresh plan (port of
`photon_tpu/continual/delta.py`).

Reference parity: the input side of Photon-ML's incremental training
(GameTrainingDriver `--initial-model` retrains on fresh data with the old
posterior as prior). The reference re-reads everything and lets priors do
the work; at "models refresh hourly" scale the win is knowing WHICH
per-entity models actually have new evidence — only those random-effect
buckets need re-solving, everything else serves unchanged.

The manifest (`build_manifest`, saved by
`data.model_io.save_game_model(..., manifest=...)` beside ``best_model/``
and beside every point a training driver saves) records, per
random-effect coordinate, the weight-carrying row count of every entity
the previous run trained on. `diff_manifest` compares a new
`game.dataset.GameData` drop against it:

- ``full=False`` (the default, a DELTA drop — only new/changed rows):
  every entity with weight-carrying rows in the drop is touched;
- ``full=True`` (the drop is the WHOLE refreshed dataset): an entity is
  touched iff its row count differs from the manifest's (gained or lost
  rows) — unchanged entities are skipped even though their rows are
  present.

Entities absent from the manifest are NEW: they are reported separately
(`CoordinatePlan.new_keys`), counted on ``continual.deferred_new_keys``
and logged at INFO on ``photon_tpu.continual``, because the refresh path
keeps the previous model's entity space (the serving hot-swap contract
pins shapes), so new entities serve the cold-miss fixed-effect-only
fallback until the next full retrain picks them up.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.matrix import _host
from photon_tpu_torch.game.model import RandomEffectModel

MANIFEST_VERSION = 1


def build_manifest(data, entity_names=None) -> dict:
    """The training-row manifest of one GameData: per entity type, each
    raw key's WEIGHT-CARRYING row count (weight-0 padding/down-sampled
    rows never count — they carry no evidence, exactly the rows
    `RandomEffectDataset.build` drops from training).

    ``entity_names``: which entity-id columns to record (default: all of
    ``data.entity_ids``). Saved beside the model by
    `data.model_io.save_game_model(..., manifest=...)`.
    """
    w = _host(data.weights)
    carrying = w != 0.0
    coords: dict = {}
    for name in (entity_names if entity_names is not None
                 else data.entity_ids):
        raw = np.asarray(data.entity_ids[name])
        keys, inv = np.unique(raw[carrying], return_inverse=True)
        counts = np.bincount(inv, minlength=keys.shape[0])
        coords[name] = {
            str(k): int(c) for k, c in zip(keys.tolist(), counts.tolist())}
    return {"version": MANIFEST_VERSION, "n_rows": int(w.shape[0]),
            "entities": coords}


@dataclasses.dataclass(frozen=True)
class CoordinatePlan:
    """One random-effect coordinate's slice of a refresh plan."""

    name: str  # coordinate name in the GameModel
    entity_name: str  # entity-id column
    touched_keys: np.ndarray  # raw keys with new evidence, prev entity space
    new_keys: np.ndarray  # raw keys unseen by the previous run (deferred)
    n_touched_rows: int  # drop rows belonging to touched entities

    @property
    def n_touched(self) -> int:
        return int(self.touched_keys.shape[0])


@dataclasses.dataclass(frozen=True)
class RefreshPlan:
    """The compact output of delta ingestion: which entities of which
    random-effect coordinates need a re-solve. Fixed-effect coordinates
    never appear — a refresh keeps them frozen (they are everyone's
    offset; retraining them is a full-retrain decision, not an hourly
    one)."""

    coordinates: dict  # name -> CoordinatePlan
    n_drop_rows: int
    n_prev_rows: int

    @property
    def n_touched(self) -> int:
        return sum(p.n_touched for p in self.coordinates.values())

    def is_empty(self) -> bool:
        return self.n_touched == 0


def _manifest_counts(manifest: dict, entity_name: str) -> dict:
    if manifest.get("version", 0) > MANIFEST_VERSION:
        raise ValueError(
            f"training manifest version {manifest.get('version')} is newer "
            f"than this build understands ({MANIFEST_VERSION}); refresh "
            "with a matching photon-tpu or retrain fully")
    ents = manifest.get("entities", {})
    if entity_name not in ents:
        raise KeyError(
            f"previous manifest records no entity column {entity_name!r} "
            f"(has {sorted(ents)}); it cannot anchor a delta for this "
            "coordinate — retrain fully or rebuild the manifest")
    return ents[entity_name]


def diff_manifest(prev_manifest: dict, drop, prev_model,
                  full: bool = False) -> RefreshPlan:
    """Diff a data drop against the previous run's manifest → RefreshPlan.

    ``prev_model`` supplies the coordinate structure (which coordinates
    are random effects, their entity columns) and the previous entity
    space that splits touched keys from NEW keys. See the module
    docstring for ``full`` semantics. Host work only.
    """
    with telemetry.span("continual.delta_diff", rows=drop.n):
        carrying = _host(drop.weights) != 0.0
        plans: dict = {}
        for cname, cm in prev_model.coordinates.items():
            if not isinstance(cm, RandomEffectModel):
                continue
            raw = np.asarray(drop.entity_ids[cm.entity_name]).astype(np.str_)
            keys, inv = np.unique(raw[carrying], return_inverse=True)
            counts = np.bincount(inv, minlength=keys.shape[0])
            prev_counts = _manifest_counts(prev_manifest, cm.entity_name)
            if full:
                prev_vec = np.asarray(
                    [prev_counts.get(str(k), 0) for k in keys.tolist()],
                    np.int64)
                changed = counts != prev_vec
                # entities that VANISHED from the dataset keep their model
                # (no new evidence, nothing to re-solve) — only present-
                # and-changed keys are touched
                keys, counts = keys[changed], counts[changed]
            known = np.asarray(
                [str(k) in prev_counts for k in keys.tolist()], bool)
            # the previous MODEL's entity space decides refreshability:
            # a key the manifest saw but the model dropped (all-weight-0
            # at train time) is still "new" to the refresh
            in_model = cm.dense_ids(keys) < cm.n_entities
            touched = keys[known & in_model]
            new = keys[~(known & in_model)]
            plans[cname] = CoordinatePlan(
                name=cname, entity_name=cm.entity_name,
                touched_keys=touched, new_keys=new,
                n_touched_rows=int(counts[known & in_model].sum()))
            telemetry.count("continual.touched_entities",
                            int(touched.shape[0]))
            if new.shape[0]:
                # new-entity deferral is a DECISION, not an accident: say
                # it out loud
                telemetry.count("continual.deferred_new_keys",
                                int(new.shape[0]))
                from photon_tpu_torch.utils.logging import photon_logger

                photon_logger("photon_tpu.continual", propagate=True).info(
                    "delta refresh coordinate %r: deferring %d new "
                    "entities outside the previous model's entity space "
                    "(the hot-swap contract pins shapes); they serve the "
                    "cold-miss fixed-effect-only fallback until the next "
                    "full retrain", cname, int(new.shape[0]))
        telemetry.count("continual.plans")
        return RefreshPlan(plans, n_drop_rows=drop.n,
                           n_prev_rows=int(prev_manifest.get("n_rows", 0)))
