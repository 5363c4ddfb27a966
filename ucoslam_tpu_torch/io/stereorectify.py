"""Stereo rectification: a calibrated pair -> a row-aligned rectified pair.

Port of `ucoslam_tpu/io/stereorectify.py`. The remap tables come from a
stereo calibration by Bouguet's algorithm (as cv::stereoRectify): split the
rotation between the cameras evenly, then rotate both so that the baseline
becomes the common x-axis. Both eyes are warped by one batched bilinear
gather on the device, after which epipolar lines are image rows, as
`FrameExtractor.process_stereo` expects.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import so3_exp, so3_log
from ucoslam_tpu_torch.ops.image import bilinear_sample


class StereoRectify:
    def __init__(self, cam_left: CameraParams, cam_right: CameraParams, R: np.ndarray, T: np.ndarray,
                 new_size: tuple | None = None, device="cuda"):
        """R, T: the right camera from the left (x_r = R x_l + T); new_size:
        (width, height) of the rectified images, the left camera's by
        default."""
        self.cam_left = cam_left
        self.cam_right = cam_right
        self.device = torch.device(device)
        R = np.asarray(R, np.float64)
        T = np.asarray(T, np.float64).reshape(3)
        w = new_size[0] if new_size else cam_left.width
        h = new_size[1] if new_size else cam_left.height

        # Bouguet: half the rotation each way (the logarithm and exponential
        # in float32, as the reference), then the baseline along +x
        r_half = so3_log(torch.from_numpy(R[None].astype(np.float32)))[0].numpy() / 2.0
        R_half = so3_exp(torch.from_numpy(r_half[None]))[0].numpy()
        t = R_half @ T  # the baseline in the split frame
        e1 = t / np.linalg.norm(t)
        if abs(e1[0]) < 1e-9:
            e1 = np.asarray([1.0, 0.0, 0.0])
        e2 = np.asarray([-t[1], t[0], 0.0])
        n2 = np.linalg.norm(e2)
        e2 = e2 / n2 if n2 > 1e-12 else np.asarray([0.0, 1.0, 0.0])
        Rrect = np.stack([e1, e2, np.cross(e1, e2)])  # rows
        if e1[0] < 0:
            Rrect[0] *= -1.0
            Rrect[2] *= -1.0
        self.R1 = (Rrect @ R_half).astype(np.float32)  # left camera -> rectified
        self.R2 = (Rrect @ R_half.T).astype(np.float32)  # right camera -> rectified
        self.baseline = float(np.linalg.norm(T))
        f = float(0.5 * (cam_left.fy + cam_right.fy))
        self.cam_rect = CameraParams.create(f, f, w / 2.0, h / 2.0, dist=None, width=w, height=h, bl=self.baseline)
        self._grids = None

    def remap_grids(self) -> torch.Tensor:
        """(2, H, W, 2) source pixel of each rectified pixel, left then right;
        computed once."""
        if self._grids is None:
            cr = self.cam_rect
            ys, xs = np.mgrid[0 : cr.height, 0 : cr.width].astype(np.float32)
            # rectified pixel -> normalized ray in the rectified frame
            rays = np.stack([(xs - cr.cx) / cr.fx, (ys - cr.cy) / cr.fy, np.ones_like(xs)], -1)
            grids = []
            for cam, Ri in ((self.cam_left, self.R1), (self.cam_right, self.R2)):
                rays_cam = rays @ Ri  # R_i^T applied to each ray: into the source camera
                xn = np.stack([rays_cam[..., 0] / rays_cam[..., 2], rays_cam[..., 1] / rays_cam[..., 2]], -1)
                xyd = cam.distort_normalized(torch.from_numpy(xn).to(self.device))
                grids.append(torch.stack([xyd[..., 0] * cam.fx + cam.cx, xyd[..., 1] * cam.fy + cam.cy], -1))
            self._grids = torch.stack(grids)
        return self._grids

    def rectify(self, left: np.ndarray, right: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw (H, W) pair -> the rectified pair, float32 images."""
        imgs = torch.from_numpy(np.stack([np.asarray(left, np.float32), np.asarray(right, np.float32)]))
        out = bilinear_sample(imgs.to(self.device), self.remap_grids(), mode="bilinear").cpu().numpy()
        return out[0], out[1]

    def rectified_camera(self) -> CameraParams:
        return self.cam_rect
