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

Ported so far: the GAME serving path (store → int8/bf16/f32 program
ladder → micro-batching dispatcher), with the int8 rung as a CUDA kernel;
single-device GLM training (`models.training.train_glm`: L-BFGS, OWL-QN,
TRON; priors, normalization, variances) on dense X, `SparseRows` or the
blocked-ELL layout, whose X passes are CUDA kernels; reg-weight grids
(`train_glm_grid`); GAME training (`game.estimator.GameEstimator`); and
streamed training of datasets larger than device memory (a host
`data.dataset.ChunkedBatch` through `train_glm`, and a GAME fixed effect
over a host-chunked shard).
"""
