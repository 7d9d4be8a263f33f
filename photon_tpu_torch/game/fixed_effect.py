"""Fixed-effect coordinate: one GLM solve over all rows (port of
`photon_tpu/game/fixed_effect.py`, in memory).

Reference parity: com.linkedin.photon.ml.algorithm.FixedEffectCoordinate —
trainModel on the offsets the other coordinates' scores make. The solve is
`models.training.train_glm` on the coordinate's device: its X passes go
through the port's kernels (the blocked-ELL kernels on a `BlockedEllRows`
shard, the fused value+grad on a dense OWL-QN solve). A host-chunked
shard (`data.dataset.ChunkedMatrix`) solves streamed (`train_glm` on its
`ChunkedBatch`) and scores into a host margin cache
(`game.scoring.score_chunked_host`).

On a mesh the dataset is row-sharded over the slots
(`FixedEffectDataset.build(mesh=)`), `train_glm(mesh=)` closes each
evaluation with one slot-ordered reduction, and the score is every
slot's margins gathered in slot order (`game.scoring.mesh_margins`): the
descent's whole (n,) offsets, the same bits on every process. The fused
one-program update stays off on a mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from photon_tpu_torch.game.dataset import FixedEffectDataset
from photon_tpu_torch.game.model import FixedEffectModel
from photon_tpu_torch.models.training import train_glm
from photon_tpu_torch.models.variance import VarianceComputationType
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig
from photon_tpu_torch.optim.tracker import OptResult


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """Reference: algorithm.FixedEffectCoordinate."""

    dataset: FixedEffectDataset
    task: TaskType
    config: OptimizerConfig
    mesh: Optional[object] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    # NormalizationContext of this coordinate's shard: train_glm solves in
    # normalized space and returns original-space coefficients
    normalization: Optional[object] = None

    def train(self, offsets_full,
              warm_start: Optional[FixedEffectModel] = None,
              prior: Optional[FixedEffectModel] = None
              ) -> tuple[FixedEffectModel, OptResult]:
        """Solve with the other coordinates' scores as offsets.
        ``prior``: a previous run's model whose coefficients and variances
        become an informative Gaussian prior (incremental training)."""
        w0 = None
        if (warm_start is not None
                and warm_start.model.weights.shape[0] == self.dataset.dim):
            w0 = warm_start.model.weights
        prior_dist = None
        if (prior is not None
                and prior.model.weights.shape[0] == self.dataset.dim):
            from photon_tpu_torch.optim.prior import PriorDistribution

            c = prior.model.coefficients
            prior_dist = PriorDistribution.from_coefficients(
                c.means.cpu().numpy(),
                None if c.variances is None else c.variances.cpu().numpy())
        model, res = train_glm(
            self.dataset.batch(offsets_full), self.task, self.config,
            w0=w0, variance=self.variance, normalization=self.normalization,
            prior=prior_dist, mesh=self.mesh, device=self.dataset.device)
        return FixedEffectModel(model, self.dataset.shard_name), res

    def score(self, model: FixedEffectModel):
        """This coordinate's margin alone (no offsets): an (n,) tensor on
        the device, or, for a chunked shard, a HOST (n,) numpy cache
        filled chunk by chunk (the full score vector never lives on the
        device)."""
        if self.dataset.chunked:
            from photon_tpu_torch.game.scoring import score_chunked_host

            return score_chunked_host(self.dataset.X, model.model.weights,
                                      self.mesh)
        if self.dataset.mesh is not None:
            from photon_tpu_torch.game.scoring import mesh_margins

            return mesh_margins(self.dataset.X, model.model.weights,
                                self.dataset.n)
        return model.score(self.dataset.X)
