"""photon_tpu_torch: the PyTorch/CUDA port of photon_tpu for NVIDIA Hopper.

The package mirrors `photon_tpu`'s module layout (so
`photon_tpu_torch/serving/programs.py` is the counterpart of
`photon_tpu/serving/programs.py`) and imports neither JAX nor anything of
`photon_tpu`: what it needs from the reference it keeps as its own copy.

Conventions:

- plain functions on tensors, an explicit ``device=`` at every entry
  point, explicit `torch.Generator`s where randomness is needed;
- entry points default to ``device="cuda"`` and raise when no GPU is
  present and the caller did not ask for the CPU (`device.resolve_device`)
  — there is no quiet fallback to the CPU;
- every TPU kernel on a ported path is a hand-written Hopper kernel under
  `kernels/`, with its plain PyTorch version beside it.

Ported so far (slices 1–22): the GAME serving path (store →
int8/bf16/f32 program ladder → micro-batching dispatcher), with the int8
rung as a CUDA kernel, and the replica fleet; single-device GLM training
(`models.training.train_glm`: L-BFGS, OWL-QN, TRON; priors,
normalization, variances) on dense X, `SparseRows`, the blocked-ELL
layout — whose X passes are CUDA kernels — and the hybrid and permuted
hybrid layouts; the dense fused value+grad kernel; reg-weight grids
(`train_glm_grid`); GAME training (`game.estimator.GameEstimator`);
streamed training of datasets larger than device memory (a host
`data.dataset.ChunkedBatch` through `train_glm`, and a GAME fixed effect
over a host-chunked shard); evaluation and validation-driven selection;
the drivers (`drivers`) over the streamed data plane: the native Avro
block decoder (`native`, host C++ built by g++), streamed reads to the
card and to the host (`data.streaming`), the parallel ingest plane with
its chunk cache (`data.ingest_plane`, `ingest`) and the training
driver's streamed regimes; continual refresh and the hot swap
(`continual`); elastic runs (`checkpoint`); the mesh and multi-process
training (`parallel`); run telemetry and request tracing (`telemetry`);
Bayesian and lane-batched tuning (`tuning`) and the model diagnostics
(`diagnostics`); the attribution ledger (`profiling`); the self-test
CLIs and the umbrella ``python -m photon_tpu_torch --selfcheck``; and
the source auditor with its thread model (``python -m
photon_tpu_torch.lint [--threads]``) and the hot paths' run-time
contracts (``python -m photon_tpu_torch.analysis``); the sharded
layouts' one-device global view, the tiled kernels' work-item tile
autotuner (`tuning.tile_tuner`); and the reference's package facades:
this one re-exports `OptimizerConfig`, `OptimizerType`,
`RegularizationContext`, `RegularizationType` and `TaskType`, `game` and
`utils` theirs.
"""

__version__ = "0.1.0"

from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim.config import (  # noqa: E402
    OptimizerConfig, OptimizerType)
from photon_tpu_torch.optim.regularization import (  # noqa: E402
    RegularizationContext, RegularizationType)

__all__ = [
    "OptimizerConfig",
    "OptimizerType",
    "RegularizationContext",
    "RegularizationType",
    "TaskType",
]
