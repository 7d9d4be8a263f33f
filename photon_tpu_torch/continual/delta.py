"""The training-row manifest (the `build_manifest` part of
`photon_tpu/continual/delta.py`; the delta differ and refresh plans wait
for ROADMAP queue A item 9).
"""
from __future__ import annotations

import numpy as np

from photon_tpu_torch.data.matrix import _host

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
