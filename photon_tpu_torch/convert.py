"""Carry the JAX package's models and layouts across as plain numpy.

The port never imports the reference, so the crossing is by value: arrays
as numpy (a JAX bf16 array arrives as an ``ml_dtypes.bfloat16`` array and
is reinterpreted bit for bit as ``torch.bfloat16``), enums by value.

- `game_model_from_arrays`: a GAME model. For a `photon_tpu` GameModel
  ``m`` the caller builds::

    {name: {"type": "fixed", "feature_shard": cm.feature_shard,
            "means": np.asarray(cm.model.coefficients.means)}
     or    {"type": "random", "feature_shard": cm.feature_shard,
            "entity_name": cm.entity_name,
            "coefficients": np.asarray(cm.coefficients),
            "entity_keys": np.asarray(cm.entity_keys)}
     for name, cm in m.coordinates.items()}

  and passes it with ``m.task.value``. `CoefficientStore.from_game_model`
  then freezes the result for serving.
- `glm_from_arrays`: a trained GLM's coefficients (and variances).
- `blocked_ell_from_arrays`: a `photon_tpu` BlockedEllRows ``X`` given as
  ``{f.name: getattr(X, f.name) for f in dataclasses.fields(X)}``.
- `gp_from_arrays`: a fitted `photon_tpu.tuning` GaussianProcess ``gp``
  given as ``{f.name: getattr(gp, f.name) for f in
  dataclasses.fields(gp)}`` (arrays as numpy, scalars as floats).
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.data.matrix import BlockedEllRows
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


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor holding numpy array ``a``'s values; a bfloat16 numpy
    array (ml_dtypes) becomes ``torch.bfloat16`` with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def glm_from_arrays(task, means, variances=None,
                    device=None) -> GeneralizedLinearModel:
    """A port GLM on ``device`` (default ``cuda``) from a trained model's
    (d,) coefficients and optional (d,) variances."""
    dev = resolve_device(device)
    task = task if isinstance(task, TaskType) else TaskType(task)

    def tensor(a):
        return None if a is None else host_tensor(
            np.asarray(a, np.float32)).to(dev)

    return GeneralizedLinearModel(
        Coefficients(tensor(means), tensor(variances)), task)


def blocked_ell_from_arrays(fields: dict, device=None) -> BlockedEllRows:
    """The port's BlockedEllRows on ``device`` (default ``cuda``) from the
    reference layout's fields as arrays (see the module docstring); every
    array keeps its dtype and bits."""
    dev = resolve_device(device)

    def tensor(a):
        return host_tensor(a).to(dev)

    tuples = ("ell_pcols", "ell_vals", "bucket_rows", "bucket_vals")
    return BlockedEllRows(
        **{k: tuple(map(tensor, fields[k])) for k in tuples},
        **{k: tensor(fields[k])
           for k in ("dense", "row_pos", "perm_cols", "inv_perm")},
        **{k: int(fields[k]) for k in ("n_features", "n_prefix",
                                       "last_col_pos", "tail_nnz")})


def gp_from_arrays(fields: dict, device=None):
    """The port's `tuning.gp.GaussianProcess` on ``device`` (default
    ``cuda``) from a reference GP's fields (see the module docstring):
    the same posterior, every array f32 with its bits."""
    from photon_tpu_torch.tuning.gp import GaussianProcess

    dev = resolve_device(device)

    def tensor(a):
        return None if a is None else host_tensor(
            np.asarray(a, np.float32)).to(dev)

    return GaussianProcess(
        X=tensor(fields["X"]), y_mean=float(fields["y_mean"]),
        y_std=float(fields["y_std"]), alpha=tensor(fields["alpha"]),
        L=tensor(fields["L"]), amplitude=float(fields["amplitude"]),
        inv_lengthscales=tensor(fields["inv_lengthscales"]),
        noise=float(fields["noise"]),
        kernel_name=str(fields.get("kernel_name", "matern52")),
        mask=tensor(fields.get("mask")))
