"""Pinhole camera with radial-tangential distortion.

Port of `ucoslam_tpu/geometry/camera.py`. Intrinsics are Python floats
holding float32 values (the reference keeps float32 scalars), so a product
with a float32 tensor is the same float32 product on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class CameraParams:
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1, k2, p1, p2, k3
    width: int = 640
    height: int = 480
    bl: float = 0.0  # stereo baseline (meters); 0 => monocular
    rgb_depthscale: float = 1.0 / 5000.0

    @classmethod
    def create(cls, fx, fy, cx, cy, dist=None, width=640, height=480, bl=0.0,
               rgb_depthscale=1.0 / 5000.0) -> "CameraParams":
        d = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
        if d.shape[0] < 5:
            d = np.pad(d, (0, 5 - d.shape[0]))
        return cls(
            _f32(fx), _f32(fy), _f32(cx), _f32(cy), tuple(float(v) for v in d[:5]),
            int(width), int(height), float(bl), float(rgb_depthscale),
        )

    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in self.dist)

    def K(self, device="cpu") -> torch.Tensor:
        """(3, 3) float32 intrinsic matrix on `device`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    @property
    def bf(self) -> float:
        """baseline * fx, the stereo disparity scale (float32 product)."""
        return _f32(np.float32(self.fx) * np.float32(self.bl))

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Undistorted pixels (..., 2) + depth (...,) -> camera-frame (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x * depth, y * depth, depth], -1)

    def project(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> undistorted pixels (..., 2)."""
        z = xyz[..., 2:3]
        inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        x = xyz[..., 0:1] * inv_z
        y = xyz[..., 1:2] * inv_z
        return torch.cat([self.fx * x + self.cx, self.fy * y + self.cy], -1)

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """OpenCV radial-tangential distortion of normalized coordinates (..., 2)."""
        k1, k2, p1, p2, k3 = (_f32(v) for v in self.dist)
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], -1)

    def undistort_points(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Distorted pixels (..., 2) -> undistorted pixels, by the reference's
        fixed-point inversion of the distortion."""
        xn = torch.stack([(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy], -1)
        x = xn
        k1, k2, p1, p2, k3 = (_f32(v) for v in self.dist)
        for _ in range(iters):
            xs, ys = x[..., 0], x[..., 1]
            r2 = xs * xs + ys * ys
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * xs * ys + p2 * (r2 + 2.0 * xs * xs)
            dy = p1 * (r2 + 2.0 * ys * ys) + 2.0 * p2 * xs * ys
            x = (xn - torch.stack([dx, dy], -1)) / radial[..., None]
        return torch.stack([x[..., 0] * self.fx + self.cx, x[..., 1] * self.fy + self.cy], -1)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return (
            (uv[..., 0] >= margin)
            & (uv[..., 0] < self.width - margin)
            & (uv[..., 1] >= margin)
            & (uv[..., 1] < self.height - margin)
        )
