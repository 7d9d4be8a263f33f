"""Online GAME scoring (port of `photon_tpu/serving`): coefficient store →
program ladder → micro-batching dispatcher → replica fleet, on CUDA by
default.

CLI: ``python -m photon_tpu_torch.serving --selftest`` spins up the store,
the ladder, the dispatcher and a 2-replica fleet in-process (on the card
unless ``--device cpu``) and exits non-zero on any parity, retrace,
latency-accounting, overload or replica-kill failure."""
from photon_tpu_torch.serving.admission import (AdmissionController,
                                                AdmissionPolicy, Shed)
from photon_tpu_torch.serving.dispatcher import (MicroBatchDispatcher,
                                                 RungExecutor, ScoreRequest,
                                                 collate_rung_args)
from photon_tpu_torch.serving.fleet import (FleetPolicy, Replica,
                                            ReplicaFleet, shard_bounds,
                                            shard_store)
from photon_tpu_torch.serving.programs import (ProgramLadder,
                                               QuantizationRefused, ShardSpec)
from photon_tpu_torch.serving.store import (CoefficientStore, FixedBlock,
                                            RandomBlock)

__all__ = [
    "AdmissionController", "AdmissionPolicy", "CoefficientStore",
    "FixedBlock", "FleetPolicy", "MicroBatchDispatcher", "ProgramLadder",
    "QuantizationRefused", "RandomBlock", "Replica", "ReplicaFleet",
    "RungExecutor", "ScoreRequest", "ShardSpec", "Shed",
    "collate_rung_args", "shard_bounds", "shard_store",
]
