"""Model save/load: GAME and GLM models ↔ Avro files on disk.

Reference parity: com.linkedin.photon.ml.io.avro.AvroModelProcessingUtils /
ModelProcessingUtils — the reference persists fixed-effect coefficients as
BayesianLinearModelAvro (lists of name⊕term → mean/variance) and
random-effect models as per-entity coefficient records, plus the feature
index maps needed to interpret them. Layout here:

    <dir>/metadata.json                      task, coordinate order/types
    <dir>/<coordinate>/feature_index.tsv     the shard's IndexMap
    <dir>/<coordinate>/coefficients.avro     fixed effect: name-term-value
    <dir>/<coordinate>/per_entity.avro       random effect: dense rows in
                                             feature_index order

Fixed-effect coefficients are stored sparse-by-name (portable, reference
format); per-entity coefficient vectors are stored dense in index order
(compact — entity count × d dominates, and names live once in the TSV).

The port's copy of `photon_tpu/data/model_io.py`: the same files, so a
directory saved by either package loads in the other. Coefficients are
read back as f32 tensors on the device `load_game_model` is given
(default ``cuda``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.checkpoint.store import commit_bytes
from photon_tpu_torch.data.avro_io import read_avro, write_avro
from photon_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key
from photon_tpu_torch.data.matrix import _host
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops.losses import TaskType

COEFFICIENT_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelCoefficientAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
        {"name": "variance", "type": ["null", "double"], "default": None},
    ],
}

PER_ENTITY_SCHEMA = {
    "type": "record",
    "name": "PerEntityModelAvro",
    "fields": [
        {"name": "entityId", "type": "string"},
        {"name": "means", "type": {"type": "array", "items": "double"}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "double"}],
         "default": None},
    ],
}


def _split_key(key: str) -> tuple[str, str]:
    name, _, term = key.partition(DELIMITER)
    return name, term


def save_glm_avro(path, weights, imap: IndexMap, variances=None) -> None:
    """Coefficients → name-term-value Avro (reference: BayesianLinearModelAvro
    via AvroUtils.convertGLMModelToBayesianLinearModelAvro)."""
    w = _host(weights)
    var = None if variances is None else _host(variances)
    keys = imap.keys_in_order()
    records = []
    for j, key in enumerate(keys):
        if w[j] == 0.0 and (var is None or var[j] == 0.0):
            continue  # sparse-by-name: zeros are implicit — but an L1-zeroed
            # coefficient with a real variance must still round-trip
        name, term = _split_key(key)
        records.append({
            "name": name, "term": term, "value": float(w[j]),
            "variance": None if var is None else float(var[j]),
        })
    write_avro(path, records, COEFFICIENT_SCHEMA)


def load_glm_avro(path, imap: IndexMap) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Avro coefficients → dense (d,) arrays in the IndexMap's column order.
    Names outside the map are dropped (the reference's behavior when loading
    into a narrower feature space)."""
    d = imap.n_features
    w = np.zeros(d, np.float32)
    var: Optional[np.ndarray] = None
    for rec in read_avro(path):
        j = imap.get(feature_key(rec["name"], rec["term"]))
        if j == IndexMap.NULL_ID:
            continue
        w[j] = rec["value"]
        if rec.get("variance") is not None:
            if var is None:
                var = np.zeros(d, np.float32)
            var[j] = rec["variance"]
    return w, var


MANIFEST_NAME = "training_manifest.json"


def save_training_manifest(out_dir, manifest: dict) -> None:
    """Commit the training-row manifest beside a saved model (atomic:
    checkpoint.store.commit_bytes — readers see old-or-new, never torn).

    The manifest is what the continual-training delta differ
    (`continual/delta.py`, ROADMAP queue A item 9) diffs a new data drop against:
    ``{"n_rows": int, "coordinates": {name: {"entity_name": str,
    "rows_per_entity": {raw key: weight-carrying row count}}}}``. Without
    it a refresh cannot tell WHICH entities gained rows, so the per-entity
    row counts must survive the training process alongside the
    coefficients and variances they condition."""
    os.makedirs(out_dir, exist_ok=True)
    commit_bytes(os.path.join(out_dir, MANIFEST_NAME),
                 json.dumps(manifest, indent=2, sort_keys=True).encode())


def load_training_manifest(out_dir) -> Optional[dict]:
    """The manifest saved beside a model, or None for models saved before
    (or without) one — callers must treat None as 'no delta baseline'."""
    path = os.path.join(out_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_game_model(out_dir, model: GameModel, index_maps: dict,
                    manifest: Optional[dict] = None) -> None:
    """Persist every coordinate + metadata (reference:
    ModelProcessingUtils.saveGameModelToHDFS).

    ``manifest``: optional training-row manifest (see
    `save_training_manifest`) persisted beside the coefficients, so an
    incremental refresh can build both its priors (variances ride the
    coordinate Avro records) and its delta plan from the saved model
    directory alone."""
    os.makedirs(out_dir, exist_ok=True)
    meta: dict = {"task": model.task.name, "coordinates": []}
    for name, cm in model.coordinates.items():
        cdir = os.path.join(out_dir, name)
        os.makedirs(cdir, exist_ok=True)
        imap = index_maps[name]
        imap.save(os.path.join(cdir, "feature_index.tsv"))
        if isinstance(cm, FixedEffectModel):
            coeffs = cm.model.coefficients
            save_glm_avro(
                os.path.join(cdir, "coefficients.avro"),
                _host(coeffs.means), imap,
                None if coeffs.variances is None else _host(coeffs.variances),
            )
            meta["coordinates"].append({
                "name": name, "type": "fixed", "feature_shard": cm.feature_shard,
            })
        elif isinstance(cm, RandomEffectModel):
            means = _host(cm.coefficients).astype(np.float64)
            variances = (None if cm.variances is None
                         else _host(cm.variances).astype(np.float64))
            records = (
                {
                    "entityId": str(cm.entity_keys[i]),
                    "means": means[i].tolist(),
                    "variances": None if variances is None
                    else variances[i].tolist(),
                }
                for i in range(cm.n_entities)
            )
            write_avro(os.path.join(cdir, "per_entity.avro"), records,
                       PER_ENTITY_SCHEMA)
            meta["coordinates"].append({
                "name": name, "type": "random",
                "feature_shard": cm.feature_shard,
                "entity_name": cm.entity_name,
            })
        else:
            raise TypeError(f"unknown coordinate model: {type(cm)}")
    # metadata.json is the model-publish manifest load_game_model keys
    # off — committed LAST and atomically, so a kill mid-save leaves a
    # directory that reads as "no model" rather than a torn one
    commit_bytes(os.path.join(out_dir, "metadata.json"),
                 json.dumps(meta, indent=2).encode())
    if manifest is not None:
        save_training_manifest(out_dir, manifest)


def load_game_model(out_dir, device=None) -> tuple[GameModel, dict]:
    """Inverse of save_game_model → (GameModel, per-coordinate IndexMaps),
    its coefficients on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    with open(os.path.join(out_dir, "metadata.json")) as f:
        meta = json.load(f)
    task = TaskType[meta["task"]]
    coords: dict = {}
    index_maps: dict = {}
    for c in meta["coordinates"]:
        name = c["name"]
        cdir = os.path.join(out_dir, name)
        imap = IndexMap.load(os.path.join(cdir, "feature_index.tsv"))
        index_maps[name] = imap
        if c["type"] == "fixed":
            w, var = load_glm_avro(os.path.join(cdir, "coefficients.avro"), imap)
            coords[name] = FixedEffectModel(
                GeneralizedLinearModel(
                    Coefficients(put(w), put(var)),
                    task,
                ),
                c["feature_shard"],
            )
        else:
            records = read_avro(os.path.join(cdir, "per_entity.avro"))
            E, d = len(records), imap.n_features
            keys = np.asarray([r["entityId"] for r in records])
            order = np.argsort(keys)  # dense id = sorted-key position,
            records = [records[i] for i in order]  # matching np.unique order
            keys = keys[order]
            means = np.zeros((E, d), np.float32)
            variances = None
            for i, r in enumerate(records):
                means[i] = np.asarray(r["means"], np.float32)
                if r.get("variances") is not None:
                    if variances is None:
                        variances = np.zeros((E, d), np.float32)
                    variances[i] = np.asarray(r["variances"], np.float32)
            coords[name] = RandomEffectModel(
                entity_name=c["entity_name"],
                feature_shard=c["feature_shard"],
                task=task,
                coefficients=put(means),
                entity_keys=keys,
                key_to_index={k: i for i, k in enumerate(keys.tolist())},
                variances=put(variances),
            )
    return GameModel(coords, task), index_maps
