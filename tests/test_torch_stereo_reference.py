"""The port's stereo step against the benchmark's plain reference
(`portbench/reference/stereo.py`, float64 numpy, importing nothing of the
port), on the CPU:

- `stereo_depth` on seeded pairs of the `quads_stereo` scene at 320x240 with
  512 keypoints: the same left keypoints get a depth, and the depths agree
  within the stereo cell's written tolerance (`stereo_fleet.DEPTH_RTOL`);
- on a fronto-parallel plane at an integer disparity, every depth is
  bf / disparity to 1e-3 relative, in the port and in the reference;
- `rigid_rmse` reads 0 for a rigidly moved copy of a trajectory and not 0
  for a scaled one;
- `quads_stereo` renders `quads`' left image bit for bit (unscaled, and at
  the cell's world scale 0.5);
- the stereo step is a span of its own, `frontend.stereo`, below
  `frontend.extract`.
"""

import numpy as np
import pytest
import torch

from portbench.core import manifest, stereo_fleet
from portbench.reference import stereo as ref
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.features import frame_extractor as fe
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)

EUROC = manifest.config("euroc_stereo")
BL = EUROC["camera"]["bl"]
#: the EuRoC rig at half its focal length, on a 320x240 image
CAMERA = {"fx": EUROC["camera"]["fx"] / 2, "fy": EUROC["camera"]["fy"] / 2, "cx": 160.0, "cy": 120.0,
          "width": 320, "height": 240, "bl": BL}
PARAMS = Params().replace(maxKeyPointsPerFrame=512, nOctaveLevels=4, maxDescDistance=60.0, detectMarkers=False)


def scene(seed: int, world_scale: float = 0.5, renderer: str = "quads_stereo"):
    spec = {"renderer": renderer, "n_points": 800, "n_frames": 24, "trajectory": "arc"}
    if renderer == "quads_stereo":
        spec["world_scale"] = world_scale
    return manifest.scene_module(renderer).make(spec, CAMERA, seed)


def u8(img):
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def extract(left, right, params=PARAMS, cam=None):
    """The port's stereo frame of the pair, and what its stereo step was
    handed (the left frame, the right keypoints)."""
    cam = cam or CameraParams.create(CAMERA["fx"], CAMERA["fy"], CAMERA["cx"], CAMERA["cy"], width=CAMERA["width"],
                                     height=CAMERA["height"], bl=BL)
    seen = {}
    inner = fe.stereo_depth

    def stereo_depth(f, gray_l, gray_r, xy_r, desc_r, octave_r, valid_r, *args):
        seen.update(f=f, right=(xy_r, octave_r, desc_r, valid_r))
        return inner(f, gray_l, gray_r, xy_r, desc_r, octave_r, valid_r, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fe, "stereo_depth", stereo_depth)
        frame = fe.FrameExtractor(params, cam, device="cpu").process_stereo(left, right, 0)
    return frame, seen, cam


def reference_depth(left, right, seen, cam):
    f = seen["f"]
    xy_r, oct_r, desc_r, valid_r = (t.numpy() for t in seen["right"])
    return ref.stereo_depth(left, right, f.xy.numpy(), f.octave.numpy(), f.desc.numpy().view(np.uint32),
                            f.valid.numpy(), xy_r, oct_r, desc_r.view(np.uint32), valid_r, cam.fx * cam.bl, cam.fx,
                            float(PARAMS.maxDescDistance))


@pytest.mark.parametrize("seed", [5, 17])
def test_depth_matches_the_reference(seed):
    sc = scene(seed)
    for i in (0, 11, 23):
        left, right = (u8(a) for a in sc.render_stereo(i))
        frame, seen, cam = extract(left, right)
        v = frame.valid.numpy()
        got, want = frame.depth.numpy().astype(np.float64)[v], reference_depth(left, right, seen, cam)[v]
        assert ((got > 0) == (want > 0)).all()
        assert (want > 0).sum() > 0.3 * v.sum()
        both = want > 0
        np.testing.assert_allclose(got[both], want[both], rtol=stereo_fleet.DEPTH_RTOL, atol=0)


def test_depth_on_a_fronto_parallel_plane():
    """A plane of 16-px cells of random gray seen 13 px apart: every corner's
    SAD is a symmetric V about the true offset, so the refined disparity is
    13 exactly."""
    W, H, cell, disparity = 320, 240, 16, 13
    cells = np.random.default_rng(4).integers(30, 226, (H // cell + 1, (W + disparity) // cell + 2))
    tex = np.kron(cells, np.ones((cell, cell), np.int64)).astype(np.uint8)
    left, right = tex[:H, :W], tex[:H, disparity:disparity + W]  # x_r = x_l - disparity
    frame, seen, cam = extract(left, right, PARAMS.replace(nOctaveLevels=1))
    v = frame.valid.numpy()
    for depth in (frame.depth.numpy()[v], reference_depth(left, right, seen, cam)[v]):
        assert (depth > 0).sum() > 0.5 * v.sum()
        np.testing.assert_allclose(depth[depth > 0], cam.bf / disparity, rtol=1e-3)


def test_rigid_rmse_reads_a_rigid_motion_as_none_and_a_scale_as_error():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(40, 3))
    a = np.deg2rad(30.0)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    moved = gt @ R.T + np.array([1.0, -2.0, 0.5])
    assert ref.rigid_rmse(moved, gt) < 1e-12
    assert ref.rigid_rmse(1.05 * moved, gt) > 0.01


@pytest.mark.parametrize("world_scale", [1.0, 0.5])
def test_left_image_is_the_mono_scenes(world_scale):
    stereo, mono = scene(11, world_scale), scene(11, renderer="quads")
    for i in (0, 23):
        left, right = stereo.render_stereo(i)
        np.testing.assert_array_equal(left, mono.render(i))
        assert np.abs(left - right).mean() > 1.0
        pose = stereo.gt_pose(i)
        np.testing.assert_array_equal(pose[:3, :3], mono.gt_pose(i)[:3, :3])
        np.testing.assert_allclose(pose[:3, 3], world_scale * mono.gt_pose(i)[:3, 3], rtol=1e-6)


def test_stereo_step_is_a_span_below_extract():
    left, right = (u8(a) for a in scene(5).render_stereo(0))
    with tracing():
        timers.drain()
        extract(left, right)
        spans = timers.drain()
    by_id = {s.id: s for s in spans}
    stereo = [s for s in spans if s.name == "frontend.stereo"]
    assert len(stereo) == 1 and by_id[stereo[0].parent].name == "frontend.extract"
