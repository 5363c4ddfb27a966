"""ucoslam_tpu_torch — the PyTorch/CUDA port of ucoslam_tpu for NVIDIA Hopper.

A second package beside the JAX reference `ucoslam_tpu`, with the same
layout, a copy of its `Params` (`config.py`) and the same checkpoints.
Plain tensor code is PyTorch; the two Pallas TPU kernels of the reference
are hand-written CUDA
kernels for `sm_90a` (`csrc/`), built with `nvcc` at their first launch on a
CUDA tensor (`ops/cuda`). On a CPU tensor every kernel wrapper runs its plain
PyTorch version instead, which is what the CPU tests exercise.

Ported so far: monocular SLAM in sequential mode (`UcoSlam.setParams` ->
`process(img)` per frame -> `saveToFile`) and LOCALIZATION against a saved
map (`readFromFile` -> `setMode(Mode.LOCALIZATION)` -> `process(img)`).
Relocalization, markers, stereo/RGB-D input, loop correction, global BA
and the async mapper are not ported yet (ROADMAP.md, Queue 1).

This package imports neither jax nor anything of `ucoslam_tpu`: `Params`,
`Mode` and `TrackingState` are its own (`ucoslam_tpu_torch.config`).
"""

__version__ = "0.1.0"

from ucoslam_tpu_torch.config import Mode, Params, TrackingState  # noqa: F401
