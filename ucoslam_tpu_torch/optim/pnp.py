"""Single-frame pose refinement: robust motion-only LM.

Port of `ucoslam_tpu/optim/pnp.py::motion_only_lm`. The reference picks its
backend with a switch (`_use_pallas_lm`); here there is one dispatch: kernel
B2 for CUDA tensors, its plain PyTorch version for CPU tensors. `pnp_ransac`
(relocalization) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.ops.cuda.lm_kernel import motion_only_lm_fused


@dataclass
class PnPResult:
    pose_f2g: torch.Tensor  # (4, 4)
    inliers: torch.Tensor  # (B,) bool per input observation
    n_inliers: torch.Tensor  # ()


def motion_only_lm(
    pose_init: torch.Tensor,  # (4, 4)
    pts3d: torch.Tensor,  # (B, 3) world points
    uv: torch.Tensor,  # (B, 2) undistorted observations
    sigma2: torch.Tensor,  # (B,) per-observation variance
    valid: torch.Tensor,  # (B,) bool
    cam: CameraParams,
    depth: torch.Tensor | None = None,  # (B,) stereo/RGB-D depth (0 = mono row)
    bf: float | None = None,  # baseline * fx for the stereo residual
    iters: int = 10,
    rounds: int = 4,
) -> PnPResult:
    """Fixed-iteration robust motion-only bundle adjustment; rows with depth
    add the disparity residual u_r = u - bf/z, gated at chi2(3D)."""
    pose, inliers = motion_only_lm_fused(
        pose_init, pts3d, uv, sigma2, valid, cam.fx, cam.fy, cam.cx, cam.cy,
        depth=depth, bf=bf, iters=iters, rounds=rounds, has_depth=depth is not None,
    )
    return PnPResult(pose_f2g=pose, inliers=inliers, n_inliers=inliers.sum())
