"""GAME: generalized additive mixed-effect models (port of
`photon_tpu/game`) — the reference's public names, re-exported."""
from photon_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    coordinate_descent,
)
from photon_tpu_torch.game.dataset import (
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
    REBlock,
)
from photon_tpu_torch.game.estimator import (
    FixedEffectConfig,
    GameEstimator,
    GameFitResult,
    RandomEffectConfig,
)
from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    score_rows,
)
from photon_tpu_torch.game.projector import (
    ProjectionConfig,
    ProjectorType,
    RandomProjector,
)
from photon_tpu_torch.game.random_effect import (RandomEffectCoordinate,
                                                 RETrainStats)
from photon_tpu_torch.game.scoring import (coordinate_scores, predict_mean,
                                           score_game)

__all__ = [
    "GameData",
    "FixedEffectDataset",
    "RandomEffectDataset",
    "REBlock",
    "FixedEffectCoordinate",
    "RandomEffectCoordinate",
    "RETrainStats",
    "coordinate_descent",
    "CoordinateDescentResult",
    "FixedEffectModel",
    "RandomEffectModel",
    "GameModel",
    "score_rows",
    "coordinate_scores",
    "score_game",
    "predict_mean",
    "GameEstimator",
    "GameFitResult",
    "FixedEffectConfig",
    "RandomEffectConfig",
    "ProjectionConfig",
    "ProjectorType",
    "RandomProjector",
]
