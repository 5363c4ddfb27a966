"""The port's StereoRectify against the JAX package on the verged rig of
tests/test_stereorectify.py (a right camera rotated a few degrees, other
intrinsics and distortion):

- the counterparts of its two tests (rectified rows align, disparity
  matches f b / z; the remap warps images);
- R1, R2 within 1e-5 of the reference's, the baseline and the rectified
  camera equal, the remap grids within 1e-5 relative (a pixel coordinate of
  ~600 has a float32 step of 6e-5);
- the rectified images of the same random pair within 1e-3 of 255.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.geometry.se3 import so3_exp as ref_so3_exp
from ucoslam_tpu.io.stereorectify import StereoRectify as RefRectify
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.stereorectify import StereoRectify

torch.set_num_threads(2)

LEFT = dict(fx=460.0, fy=460.0, cx=320.0, cy=240.0, dist=[0.05, -0.1, 0.001, -0.001, 0.0])
RIGHT = dict(fx=455.0, fy=455.0, cx=315.0, cy=242.0, dist=[0.04, -0.08, -0.001, 0.001, 0.0])
T = np.asarray([-0.11, 0.002, -0.004])


@pytest.fixture(scope="module")
def rigs():
    R = np.asarray(ref_so3_exp(jnp.asarray([0.01, -0.03, 0.005])))
    port = StereoRectify(CameraParams.create(**LEFT), CameraParams.create(**RIGHT), R, T, device="cpu")
    ref = RefRectify(RefCamera.create(**LEFT), RefCamera.create(**RIGHT), R, T)
    return port, ref, R


def test_rectified_rows_align(rigs):
    sr, _, R = rigs
    cam = sr.rectified_camera()
    assert abs(cam.bl - np.linalg.norm(T)) < 1e-6
    rng = np.random.default_rng(101)
    X = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(2, 8, 200)
    # project through the rectified cameras: left at [R1 | 0], right at [R2 | R2 T]
    q_l = X @ sr.R1.T
    q_r = (X @ R.T + T) @ sr.R2.T
    uv_l = cam.project(torch.from_numpy(q_l)).numpy()
    uv_r = cam.project(torch.from_numpy(q_r.astype(np.float32))).numpy()
    assert np.median(np.abs(uv_l[:, 1] - uv_r[:, 1])) < 0.2
    disp = uv_l[:, 0] - uv_r[:, 0]
    pred = cam.fx * cam.bl / q_l[:, 2]
    in_img = (np.abs(uv_l[:, 0] - 320) < 300) & (np.abs(uv_l[:, 1] - 240) < 220)
    assert np.median(np.abs(disp[in_img] - pred[in_img])) < 0.5


def test_remap_warps_images(rigs):
    sr, ref, _ = rigs
    rng = np.random.default_rng(101)
    left = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    right = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    lr, rr = sr.rectify(left, right)
    assert lr.shape == (480, 640) and rr.shape == (480, 640) and lr.dtype == np.float32
    assert lr.std() > 30  # content preserved, not constant
    want_l, want_r = ref.rectify(left, right)
    np.testing.assert_allclose(lr, want_l, atol=1e-3 * 255, rtol=0)
    np.testing.assert_allclose(rr, want_r, atol=1e-3 * 255, rtol=0)


def test_rotations_and_grids_match_reference(rigs):
    sr, ref, _ = rigs
    np.testing.assert_allclose(sr.R1, ref.R1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sr.R2, ref.R2, atol=1e-5, rtol=0)
    assert sr.baseline == ref.baseline
    c, rc = sr.rectified_camera(), ref.rectified_camera()
    assert (c.fx, c.fy, c.cx, c.cy, c.width, c.height, c.bl) == (
        float(rc.fx), float(rc.fy), float(rc.cx), float(rc.cy), rc.width, rc.height, rc.bl)
    grids = sr.remap_grids().numpy()
    for k, which in enumerate(("left", "right")):
        want = np.asarray(ref._remap_grid(which))
        np.testing.assert_allclose(grids[k], want, rtol=1e-5, atol=1e-5)
