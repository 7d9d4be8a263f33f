"""Carry a GAME model across from the JAX package as plain numpy.

The port never imports the reference, so the crossing is by value: each
coordinate's coefficients and entity keys as numpy arrays, the task as its
enum value. For a `photon_tpu` GameModel ``m`` the caller builds::

    {name: {"type": "fixed", "feature_shard": cm.feature_shard,
            "means": np.asarray(cm.model.coefficients.means)}
     or    {"type": "random", "feature_shard": cm.feature_shard,
            "entity_name": cm.entity_name,
            "coefficients": np.asarray(cm.coefficients),
            "entity_keys": np.asarray(cm.entity_keys)}
     for name, cm in m.coordinates.items()}

and passes it with ``m.task.value``. `CoefficientStore.from_game_model`
then freezes the result for serving.
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops.losses import TaskType


def game_model_from_arrays(task, coordinates: dict,
                           device=None) -> GameModel:
    """A port GameModel on ``device`` (default ``cuda``) from per-coordinate
    numpy arrays, in ``coordinates``' order (see the module docstring)."""
    dev = resolve_device(device)
    task = task if isinstance(task, TaskType) else TaskType(task)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    out: dict = {}
    for name, c in coordinates.items():
        if c["type"] == "fixed":
            out[name] = FixedEffectModel(
                GeneralizedLinearModel(Coefficients(tensor(c["means"])),
                                       task),
                c["feature_shard"])
        elif c["type"] == "random":
            keys = np.asarray(c["entity_keys"])
            if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
                raise ValueError(f"{name}: entity_keys must be sorted and "
                                 "unique (dense_ids searches them)")
            out[name] = RandomEffectModel(
                entity_name=c["entity_name"],
                feature_shard=c["feature_shard"], task=task,
                coefficients=tensor(c["coefficients"]), entity_keys=keys,
                key_to_index={k: i for i, k in enumerate(keys.tolist())})
        else:
            raise ValueError(f"{name}: unknown coordinate type "
                             f"{c['type']!r}")
    return GameModel(out, task)
