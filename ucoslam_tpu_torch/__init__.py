"""ucoslam_tpu_torch — the PyTorch/CUDA port of ucoslam_tpu for NVIDIA Hopper.

A second package beside the JAX reference `ucoslam_tpu`, with the same
layout, a copy of its `Params` (`config.py`) and the same checkpoints.
Plain tensor code is PyTorch; the two Pallas TPU kernels of the reference
are hand-written CUDA kernels for `sm_90a` (`csrc/`), and so is the
frontend's detect stage (F1 and F2, `csrc/fast_kernel.cu`), all built with
`nvcc` at the first launch on a CUDA tensor (`ops/cuda`). On a CPU tensor every kernel wrapper runs its plain
PyTorch version instead, which is what the CPU tests exercise.

Ported so far: monocular SLAM (`UcoSlam.setParams` ->
`process(img)` per frame -> `saveToFile`), LOCALIZATION against a saved
map (`readFromFile` -> `setMode(Mode.LOCALIZATION)` -> `process(img)`),
relocalization after `resetTracker()` or a lost frame, the re-seed of a new
map segment after a long loss, keypoint loop closure and
`globalOptimization`, and ArUco markers (the native detector, built with
g++; IPPE; marker and hybrid init with metric scale; marker rows in the
tracker's LM; marker vertices in BA; the marker relocalization fallback;
marker loops), and stereo and RGB-D input (`processStereo` on a rectified
pair, `io.stereorectify.StereoRectify` for a calibrated rig, and
`processRGBD`; the one-frame metric depth init), trained `.fbow`
vocabularies (`setParams(..., vocabulary=path)`), global BA at scale (the
point-major and matrix-free CG solvers) and the asynchronous mapper
(`runSequential=False`), the detector-resolution and sensitivity options
of the frontend, and datasets on disk with the command-line harness
(`io.png`, a PNG codec without cv2; `io.datasets`, TUM / EuRoC / KITTI;
`io.exporters`; `apps.test_sequence`, `run_slam`, `test_reloc`,
`map_export`, `compare_logs`, `analyze_logs`, `stereo_rectify`;
`viz.viewer`; `utils.timers`), and every descriptor family: ORB, FREAK and
SURF on the device (`features/orb.py`, `features/descriptors.py`), AKAZE and
BRISK through the cv2 grid extractor on the host (`features/grid_extractor.py`),
with the vocabulary trainer (`features/vocab_trainer.py`) and the chessboard
stereo calibration (`apps/stereo_calibrate.py`, cv2), every marker
dictionary the reference resolves (cv2's predefined tables committed as
`markers/predefined.py`, on the native detector), and bundle adjustment
sharded over torch.distributed ranks (`parallel`; `apps/bench_scaling.py`).
Left (ROADMAP.md, Queue 1): the port's benchmark.

This package imports neither jax nor anything of `ucoslam_tpu`: `Params`,
`Mode` and `TrackingState` are its own (`ucoslam_tpu_torch.config`).
"""

__version__ = "0.1.0"

from ucoslam_tpu_torch.config import Mode, Params, TrackingState  # noqa: F401
