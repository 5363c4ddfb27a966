"""Epipolar geometry helpers.

Port of `ucoslam_tpu/geometry/epipolar.py`: the essential and fundamental
matrices of a relative pose and the squared point-to-epipolar-line distance
used by the epipolar matcher (chi2(1 dof) gate).
"""

from __future__ import annotations

import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import _hat


def essential_from_relative(T_21: torch.Tensor) -> torch.Tensor:
    """E = [t]x R for the relative pose mapping cam1 coords -> cam2 coords."""
    return _hat(T_21[..., :3, 3]) @ T_21[..., :3, :3]


def fundamental_from_poses(
    T1_g2c: torch.Tensor, T2_g2c: torch.Tensor, cam1: CameraParams, cam2: CameraParams
) -> torch.Tensor:
    """F12 such that x2^T F x1 = 0 for undistorted pixel coords; poses may
    carry leading batch dims."""
    T_21 = T2_g2c @ torch.linalg.inv(T1_g2c)
    E = essential_from_relative(T_21)
    K1i = torch.linalg.inv(cam1.K(T1_g2c.device))
    K2i = torch.linalg.inv(cam2.K(T1_g2c.device))
    return K2i.transpose(-1, -2) @ E @ K1i


def epipolar_line_sq_dist(F12: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Squared distance of x2 to the epipolar line of x1.

    uv1: (..., N, 2) points in image 1; uv2: (..., M, 2) points in image 2.
    Returns (..., N, M).
    """
    ones1 = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype, device=uv1.device)
    x1 = torch.cat([uv1, ones1], -1)  # (..., N, 3)
    lines = x1 @ F12.transpose(-1, -2)  # (..., N, 3): l = F x1
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    u2 = uv2[..., None, :, 0]  # (..., 1, M)
    v2 = uv2[..., None, :, 1]
    val = a * u2 + b * v2 + c  # (..., N, M)
    denom = (a * a + b * b).clamp(min=1e-12)
    return val * val / denom
