"""Online GAME scoring (port of `photon_tpu/serving`): coefficient store →
program ladder → micro-batching dispatcher, on CUDA by default."""
from photon_tpu_torch.serving.admission import (AdmissionController,
                                                AdmissionPolicy, Shed)
from photon_tpu_torch.serving.dispatcher import (MicroBatchDispatcher,
                                                 RungExecutor, ScoreRequest,
                                                 collate_rung_args)
from photon_tpu_torch.serving.programs import (ProgramLadder,
                                               QuantizationRefused, ShardSpec)
from photon_tpu_torch.serving.store import (CoefficientStore, FixedBlock,
                                            RandomBlock)

__all__ = [
    "AdmissionController", "AdmissionPolicy", "CoefficientStore",
    "FixedBlock", "MicroBatchDispatcher", "ProgramLadder",
    "QuantizationRefused", "RandomBlock", "RungExecutor", "ScoreRequest",
    "ShardSpec", "Shed", "collate_rung_args",
]
