"""End-to-end drivers (port of `photon_tpu/drivers`; reference:
com.linkedin.photon.ml.cli.game)."""
from photon_tpu_torch.drivers.train import (
    CoordinateSpec,
    TrainingOutput,
    TrainingParams,
    run_training,
)
from photon_tpu_torch.drivers.score import ScoringOutput, ScoringParams, run_scoring
from photon_tpu_torch.drivers.index import (
    IndexingOutput,
    IndexingParams,
    load_index_maps,
    run_indexing,
)

__all__ = [
    "CoordinateSpec", "TrainingParams", "TrainingOutput", "run_training",
    "ScoringParams", "ScoringOutput", "run_scoring",
    "IndexingParams", "IndexingOutput", "run_indexing", "load_index_maps",
]
